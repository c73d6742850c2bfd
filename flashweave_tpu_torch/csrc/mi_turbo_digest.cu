// K7: the turbo window digest: for W full-target windows (a target T and m
// candidates each), the conditional G-test of every distinct (candidate,
// subset) pair of the window's template, its float64 log p, and the digest
// of each of the window's NC slots.
//
// Replaces the JAX package's turbo window function
// flashweave_tpu/ops/condtests.py:297 `_turbo_digest_fn` (an XLA function,
// not a `pl.pallas_call`): there the pairs' joint tables came from one
// batched product of 0/1 level-indicator planes, (n, m Lr^2) by (n, U S) a
// window.  Same function as the port's plain version,
// ops/kernels.py:mi_turbo_digest_ref (ops/condtests.py:_turbo_pair_stats in
// chunks of windows, then _mi_digest over each template test's pair).
//
// The template (learning/hiton.py:_turbo_mxu_template(m, max_k), uploaded
// once for each m): the U subsets of the candidates (`memb`, `klen`), the
// NP distinct (candidate j, subset u) pairs its tests use (`pj`, `pu`),
// each of its B tests' pair (`tpair`), and the NC slots' contiguous
// segments of tests (`counts`, `offs`).  Pair (j, u) is the test of T
// against candidate j given the candidates memb[u][0 .. klen[u]): its rows
// pass the row mask of the table's nz mode and fall into cell
//   (x - o) + Lr (y - o) + Lr^2 z,   z = sum_i C[memb[u][i]] L^i,
// as in K5 (csrc/mi_cond_stats.cu), with L^klen strata.
//
// What bounds it on this card: the function's floor is the larger of the
// window's column bytes (the table read once: (m + 1) n bytes a window,
// 22.5 KB at n = 2,048, m = 10; 24 NC bytes written) and its pairs' joint
// tables counted as int8 tensor-core products, 2 Lr^2 L^klen n operations
// a pair as K3's planes are counted (NP = 1,290 pairs at m = 10, max_k =
// 3).  This kernel builds the tables on the SIMT pipes instead, so what
// holds it is one shared-memory atomic for each kept row of each distinct
// pair: each pair sweeps 2 + klen columns and adds up to n atomics.  The
// pairs' float64 log p chains (up to max_df / 2 steps a pair) run beside
// them.
//
// What the design does about it:
// - one block a window; the block copies the window's m + 1 columns into
//   shared memory once (16-byte cp.async where n is a multiple of 16 and
//   the table aligned, bytes otherwise), padded to 16-byte rows; where
//   those columns do not fit a block's shared memory the STAGED = false
//   variant reads them from device memory as K5 does (decided from the
//   shapes by ops/kernels.py:k7_staged, not a fallback);
// - the warps take the distinct pairs only (the template's tests repeat a
//   pair between the interleaving prefix and the elimination rotation:
//   1,290 pairs against 1,665 tests at m = 10), each building the pair's
//   histogram in its own slice of shared memory with shared atomics, 16
//   rows a lane from 16-byte loads, and running K5's float64 epilogue
//   (csrc/mi_cond_epilogue.cuh);
// - the pairs' (stat, df, n_obs, suff) stay in shared memory; every thread
//   then takes pairs for the log p (csrc/mi_digest.cuh's mi_logp, the plain
//   chain bit for bit), and a warp a slot reduces the slot's tests through
//   their pair index with mi_digest.cuh's compare-and-select reduction;
// - nothing of a window reaches device memory but its (3, NC) digest (and,
//   on request, the pairs' results, which chip_smoke.py holds against the
//   plain version); one launch a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mi_cond_epilogue.cuh"
#include "mi_digest.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int MAX_WARPS = 8;
// a block's shared memory on sm_90 (227 KB); ops/kernels.py:SMEM_BLOCK_BYTES
constexpr int SMEM_BLOCK_BYTES = 232448;

struct Args {
  const int8_t* dataT;                // (p, n) int8, contiguous
  int n;
  const int* levels;                  // (p,)
  const int* max_vals;                // (p,)
  const long long* Ts;                // (W,)
  const long long* C;                 // (W, m)
  int W, m, L, nz;
  const int* pj;                      // (NP,) candidate of each pair
  const int* pu;                      // (NP,) subset of each pair
  const int* tpair;                   // (B,) pair of each test
  const int* memb;                    // (U, max_k)
  const int* klen;                    // (U,)
  const int* counts;                  // (NC,) tests a slot
  const int* offs;                    // (NC,) a slot's first test
  int NP, NC, max_k, hist_ints;
  double hps, log_alpha;
  int max_df;
  const double* lg;                   // (max_df / 2, 2) lgamma offsets
  bool vec;                           // device reads by 16 bytes
  double* out;                        // (3, W, NC)
  double* pair_stat;                  // (W, NP) each, or nullptr
  long long* pair_df;
  double* pair_nobs;
  uint8_t* pair_suff;
};

// Byte offsets of the shared-memory regions: the pairs' stat and n_obs
// (later log p) as float64, the warps' histograms, the pairs' df and suff,
// then (STAGED) the window's columns in rows of n rounded up to 16.
struct Layout {
  int hist, df, suff, cols, bytes;
};

__host__ __device__ inline Layout layout(int NP, int warps, int hist_ints,
                                         int m, int n, bool staged) {
  Layout l;
  l.hist = 16 * NP;
  l.df = l.hist + 4 * warps * hist_ints;
  l.suff = l.df + 4 * NP;
  l.cols = (l.suff + NP + 15) & ~15;
  l.bytes = l.cols + (staged ? (m + 1) * ((n + 15) & ~15) : 0);
  return l;
}

__device__ __forceinline__ int byte_at(const uint4& v, int i) {
  const unsigned w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (int)((w >> (8 * (i & 3))) & 0xffu);
}

__device__ __forceinline__ uint4 load16(const int8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <bool STAGED>
__global__ void __launch_bounds__(MAX_WARPS * 32)
mi_turbo_digest_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x, n = a.n, L = a.L, m = a.m, NP = a.NP;
  const Layout lay = layout(NP, warps, a.hist_ints, m, n, STAGED);
  double* pstat = reinterpret_cast<double*>(smem);
  double* paux = pstat + NP;                   // n_obs, then log p
  int* pdf = reinterpret_cast<int*>(smem + lay.df);
  uint8_t* psuff = smem + lay.suff;
  int8_t* cols = reinterpret_cast<int8_t*>(smem + lay.cols);
  const int n16 = (n + 15) & ~15;
  const long long* Cw = a.C + (long long)w * m;
  const long long T = a.Ts[w];

  // column i of the window: 0 the target, 1 + j candidate j
  auto var = [&](int i) -> long long { return i == 0 ? T : Cw[i - 1]; };
  if (STAGED) {
    if (a.vec) {
      const int per = n / 16;
      for (int q = threadIdx.x; q < (m + 1) * per; q += blockDim.x) {
        const int i = q / per, r = (q - i * per) * 16;
        cp_async16(cols + (size_t)i * n16 + r,
                   a.dataT + (size_t)var(i) * n + r);
      }
      cp_async_wait_all();
    } else {
      for (int q = threadIdx.x; q < (m + 1) * n; q += blockDim.x) {
        const int i = q / n, r = q - i * n;
        cols[(size_t)i * n16 + r] = a.dataT[(size_t)var(i) * n + r];
      }
    }
    __syncthreads();
  }
  auto col = [&](int i) -> const int8_t* {
    return STAGED ? cols + (size_t)i * n16 : a.dataT + (size_t)var(i) * n;
  };
  const bool vec = STAGED || a.vec;

  const int o = a.nz == 2 ? 1 : 0;             // level offset of the cells
  const int Lr = L - o, LL = Lr * Lr;
  const int ox = a.nz == 1 ? (a.max_vals[T] > 1) : 0;
  int* hist = reinterpret_cast<int*>(smem + lay.hist) + warp * a.hist_ints;
  const int8_t* xc = col(0);

  for (int p = warp; p < NP; p += warps) {
    const int j = a.pj[p], u = a.pu[p], kl = a.klen[u];
    const int* mb = a.memb + (size_t)u * a.max_k;
    int S = 1;
    for (int q = 0; q < kl; ++q) S *= L;
    for (int i = lane; i < LL * S; i += 32) hist[i] = 0;
    const long long Y = Cw[j];
    const int oy = a.nz == 1 ? (a.max_vals[Y] > 1) : 0;
    const int8_t* yc = col(1 + j);
    __syncwarp();

    auto add = [&](int x, int y, int z) {
      const bool keep = a.nz == 2 ? (x != 0 && y != 0)
                        : a.nz == 1 ? ((x != 0 || !ox) && (y != 0 || !oy))
                                    : true;
      if (keep) atomicAdd(&hist[(x - o) + Lr * (y - o) + LL * z], 1);
    };

    if (vec) {
      for (int r0 = 16 * lane; r0 < n; r0 += 16 * 32) {
        const uint4 xv = load16(xc + r0), yv = load16(yc + r0);
        int z[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) z[i] = 0;
        int wz = 1;
        for (int q = 0; q < kl; ++q) {
          const uint4 zv = load16(col(1 + mb[q]) + r0);
#pragma unroll
          for (int i = 0; i < 16; ++i) z[i] += byte_at(zv, i) * wz;
          wz *= L;
        }
#pragma unroll
        for (int i = 0; i < 16; ++i)
          if (r0 + i < n) add(byte_at(xv, i), byte_at(yv, i), z[i]);
      }
    } else {
      for (int r = lane; r < n; r += 32) {
        int z = 0, wz = 1;
        for (int q = 0; q < kl; ++q) {
          z += col(1 + mb[q])[r] * wz;
          wz *= L;
        }
        add(xc[r], yc[r], z);
      }
    }
    __syncwarp();

    double lx, ly;
    if (a.nz) {
      lx = (double)(L - (a.nz == 2 ? 1 : ox));
      ly = (double)(L - (a.nz == 2 ? 1 : oy));
    } else {
      lx = (double)a.levels[T];
      ly = (double)a.levels[Y];
    }
    const fw_cond::CondResult res =
        fw_cond::cond_epilogue(hist, Lr, S, ox, oy, lx, ly, a.hps, lane);
    if (lane == 0) {
      pstat[p] = res.stat;
      paux[p] = res.n_obs;
      pdf[p] = (int)res.df;
      psuff[p] = res.suff;
      if (a.pair_stat) {
        const size_t g = (size_t)w * NP + p;
        a.pair_stat[g] = res.stat;
        a.pair_df[g] = res.df;
        a.pair_nobs[g] = res.n_obs;
        a.pair_suff[g] = res.suff;
      }
    }
    __syncwarp();                              // before the next pair's zeros
  }
  __syncthreads();

  // each pair's log p, 0 where its power check failed
  for (int p = threadIdx.x; p < NP; p += blockDim.x)
    paux[p] = psuff[p] ? fw_digest::mi_logp(pstat[p], pdf[p], paux[p],
                                            a.max_df, a.lg)
                       : 0.0;
  __syncthreads();

  // a warp a slot: its tests through their pairs
  const size_t WN = (size_t)a.W * a.NC;
  for (int c = warp; c < a.NC; c += warps) {
    const int offs = a.offs[c], cnt = a.counts[c];
    fw_digest::Best b = fw_digest::best_init();
    for (int j = lane; j < cnt; j += 32)
      fw_digest::best_add(b, j, paux[a.tpair[offs + j]], a.log_alpha);
    b = fw_digest::best_warp(b);
    if (lane == 0) {
      const size_t at = (size_t)w * a.NC + c;
      a.out[at] = b.exit == INT_MAX ? -1.0 : (double)b.exit;
      a.out[WN + at] = pstat[a.tpair[offs + max(b.w, 0)]];
      a.out[2 * WN + at] = exp(b.M);
    }
  }
}

}  // namespace

extern "C" {

// The shared-memory bytes of a K7 block (ops/kernels.py:k7_smem_bytes
// computes the same): NP distinct pairs, min(8, NP) warps each with
// hist_ints ints of histogram, and with `staged` the m + 1 columns of n
// rows.
int fw_mi_turbo_smem_bytes(int NP, int hist_ints, int m, int n, int staged) {
  const int warps = NP < MAX_WARPS ? (NP > 0 ? NP : 1) : MAX_WARPS;
  return layout(NP, warps, hist_ints, m, n, staged != 0).bytes;
}

// Launches K7 on `stream` for W windows and returns the cudaError_t of the
// launch (0 on success).  dataT: (p, n) int8 contiguous, values 0..L-1;
// levels, max_vals: (p,) int32; Ts: (W,) and C: (W, m) int64 variable
// indices; the template as int32 arrays (pj, pu (NP,), tpair (B,), memb
// (U, max_k), klen (U,), counts and offs (NC,)); hist_ints: (Lr + 1)^2
// L^max(klen); nz: 0 plain, 1 nz, 2 nz-uniform (L == 3); lg: (max_df / 2,
// 2) float64; out: (3, W, NC) float64; the pair outputs (W, NP) float64 /
// int64 / float64 / uint8, all null or none.  staged: the columns go
// through shared memory (the caller checks that they fit).
int fw_mi_turbo_digest(const void* dataT, int n, const void* levels,
                       const void* max_vals, const void* Ts, const void* C,
                       int W, int m, int L, int nz, const void* pj,
                       const void* pu, const void* tpair, const void* memb,
                       const void* klen, const void* counts, const void* offs,
                       int NP, int NC, int max_k, int hist_ints, double hps,
                       double log_alpha, int max_df, const void* lg,
                       int staged, void* out, void* pair_stat, void* pair_df,
                       void* pair_nobs, void* pair_suff, void* stream) {
  if (n <= 0 || W <= 0 || m < 1 || NP <= 0 || NC <= 0 || L < 1 || L > 127 ||
      nz < 0 || nz > 2 || (nz == 2 && L != 3) || hist_ints <= 0)
    return (int)cudaErrorInvalidValue;
  const int warps = NP < MAX_WARPS ? NP : MAX_WARPS;
  const int bytes = fw_mi_turbo_smem_bytes(NP, hist_ints, m, n, staged);
  if (bytes > SMEM_BLOCK_BYTES) return (int)cudaErrorInvalidValue;
  static bool raised_staged[fw_smem::kMaxDevices] = {};
  static bool raised_direct[fw_smem::kMaxDevices] = {};
  const cudaError_t attr =
      staged ? fw_smem::raise_limit_once(mi_turbo_digest_kernel<true>,
                                         SMEM_BLOCK_BYTES, raised_staged)
             : fw_smem::raise_limit_once(mi_turbo_digest_kernel<false>,
                                         SMEM_BLOCK_BYTES, raised_direct);
  if (attr != cudaSuccess) return (int)attr;
  Args a{static_cast<const int8_t*>(dataT), n,
         static_cast<const int*>(levels), static_cast<const int*>(max_vals),
         static_cast<const long long*>(Ts), static_cast<const long long*>(C),
         W, m, L, nz,
         static_cast<const int*>(pj), static_cast<const int*>(pu),
         static_cast<const int*>(tpair), static_cast<const int*>(memb),
         static_cast<const int*>(klen), static_cast<const int*>(counts),
         static_cast<const int*>(offs), NP, NC, max_k, hist_ints, hps,
         log_alpha, max_df, static_cast<const double*>(lg),
         n % 16 == 0 && (reinterpret_cast<uintptr_t>(dataT) & 15) == 0,
         static_cast<double*>(out), static_cast<double*>(pair_stat),
         static_cast<long long*>(pair_df), static_cast<double*>(pair_nobs),
         static_cast<uint8_t*>(pair_suff)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged)
    mi_turbo_digest_kernel<true><<<W, warps * 32, bytes, s>>>(a);
  else
    mi_turbo_digest_kernel<false><<<W, warps * 32, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
