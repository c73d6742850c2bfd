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
// as in K5 (csrc/mi_cond_stats.cu), with S_u = L^klen[u] strata.
//
// What bounds it on this card: the function's floor is the largest of the
// window's column bytes ((m + 1) n bytes a window), its pairs' joint
// tables counted as int8 tensor-core products (2 Lr^2 S_u n operations a
// pair, as K3's planes are counted) and its pairs' float64 work, the
// G-test's log and division an occupied cell and the log p chains; at the
// headline's windows the float64 work sets it.
//
// The design: the tables are one int8 tensor-core product a window,
// C = A^T B over the samples, as the JAX package's contraction of planes:
// - A (n x m Lr^2): for candidate j, the 0/1 indicator of each (x, y_j)
//   cell, row j Lr^2 + (x - o) + Lr (y_j - o), with the row mask folded in
//   (nz 2: levels 1..L-1 of both sides; nz 1: a side's level-0 indicator is
//   0 where its offset is set; nz 0: all levels), and 0 past sample n;
// - B (n x sum_u S_u): for each subset u, the indicator of each stratum s,
//   column colo[u] + s, the subsets' columns laid end to end;
// - mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 over 32-sample
//   k-steps: A's bytes are 0x01, B's 0x80, so a joint match adds 128 and
//   the count is the sum >> 7 (exact for n < 2^24).
// Both sides' indicators come from 32-bit words of four samples in three
// integer instructions (int8_indicator_pipe.cuh's match80).  A stratum code
// is formed a word at a time, sum_i word(C[memb[u][i]]) L^i: every byte of
// a column is below L and every code below L^klen <= 128, so no byte
// carries into the next.  Samples past n are masked in A by their position,
// not by a pad value: at L = 2, klen = 7 the codes reach 127.
//
// A block takes one window and sweeps its samples once a pass.  The host
// (ops/kernels.py:k7_plan) cuts the (candidate, subset) plane into passes
// of a candidate range [j0, j1) and a subset range [u0, u1): each warp
// holds up to MTW x (16 / MTW) accumulator tiles of 16 x 8, all M-tiles of
// the pass's rows against its share of the pass's N-tiles.  A pass streams
// the window's m + 1 columns through a cp.async ring of 128-sample chunks
// (each column's chunk staged as the aligned 144-byte window that covers
// it, read with a funnel shift, so one variant serves every n); for each
// chunk the block forms the pass's A rows and its subsets' stratum codes
// in shared memory once (the members' column references staged a pass),
// and the warps read A by ldmatrix, two k-steps at a time where the
// registers allow (one past two M-tiles), and form their B fragments from
// the codes, a lane's code words of those k-steps in one load (the codes'
// words are stored permuted for it).  A and the codes have two buffers, so
// the next chunk is formed while this one is multiplied (one barrier a
// chunk).  After the sweep the accumulators go to a shared (rows x
// columns) int32 slab that aliases the ring; each template pair of the
// pass (the host lists them a pass) gathers its Lr^2 x S_u block into the
// layout of csrc/mi_cond_epilogue.cuh (v + Lr b + Lr^2 s, margins after)
// in its warp's slice and runs K5's float64 epilogue there.  The pairs' (stat,
// df, n_obs, suff) stay in shared memory; every thread then takes pairs for
// the log p (csrc/mi_digest.cuh's mi_logp, the plain chain bit for bit),
// and a warp a slot reduces the slot's tests through their pair index.
// Nothing of a window reaches device memory but its (3, NC) digest (and,
// on request, the pairs' results); one launch a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_indicator_pipe.cuh"
#include "mi_cond_epilogue.cuh"
#include "mi_digest.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int MAX_WARPS = 8;
// a block's shared memory on sm_90 (227 KB); ops/kernels.py:SMEM_BLOCK_BYTES
constexpr int SMEM_BLOCK_BYTES = 232448;
constexpr int CHUNK = 128;              // samples a ring stage
constexpr int WINDOW = CHUNK + 16;      // bytes of a staged column's chunk
constexpr int WINDOW_WORDS = WINDOW / 4;
constexpr int WORDS16 = WINDOW / 16;    // 16-byte copies a column a chunk
constexpr int STAGES = 3;
constexpr int ACC_TILES = 16;           // 16 x 8 accumulator tiles a warp
constexpr int MAX_MTW = 4;              // M-tiles a pass
constexpr int MAX_LR = 7;               // a candidate's Lr^2 rows in 4 tiles
constexpr int ZDESC_INTS = 8;           // a subset's klen and member columns
constexpr uint32_t NO_CODE = 0x7f7f7f7fu;   // matches no byte of the zero row

struct Args {
  const int8_t* dataT;                // (p, n) int8, contiguous
  int n, p;
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
  // colo (U + 1,), passes (npass, 4), each pass's first pair in ppairs
  // (npass + 1,), the pairs grouped by pass (NP,)
  const int* plan;
  int U, npass, cg_ints, zrows;
  int NP, NC, max_k, hist_ints;
  double hps, log_alpha;
  int max_df;
  const double* lg;                   // (max_df / 2, 2) lgamma offsets
  double* out;                        // (3, W, NC)
  double* pair_stat;                  // (W, NP) each, or nullptr
  long long* pair_df;
  double* pair_nobs;
  uint8_t* pair_suff;
};

// Byte offsets of the shared-memory regions: the pairs' stat and n_obs
// (later log p) as float64, their df and suff; the warps' histogram
// slices; the warps' B columns (a code offset and a stratum for each
// column of each of a warp's N-tiles); the pass's subset descriptors; the
// window's column references and nz flags; then the ring and two buffers
// each of the pass's A rows and of its stratum codes (the codes' rows and
// a zero row), which the (rows x columns) int32 slab of a finished pass
// aliases.
struct Layout {
  int df, suff, hist, lanes, zdesc, cols, flags, ring, abuf, zbuf, bytes;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int NP, int warps, int hist_ints,
                                         int m, int mtw, int cg_ints,
                                         int zrows) {
  Layout l;
  l.df = 16 * NP;
  l.suff = l.df + 4 * NP;
  l.hist = align16(l.suff + NP);
  l.lanes = align16(l.hist + 4 * warps * hist_ints);
  l.zdesc = l.lanes + warps * (ACC_TILES / mtw) * 8 * 8;
  l.cols = l.zdesc + zrows * ZDESC_INTS * 4;
  l.flags = l.cols + 4 * (m + 1);
  l.ring = align16(l.flags + m + 1);
  l.abuf = l.ring + STAGES * (m + 1) * WINDOW;
  l.zbuf = l.abuf + 2 * 16 * mtw * WINDOW;
  const int streams = l.zbuf + 2 * (zrows + 1) * WINDOW - l.ring;
  l.bytes = l.ring + (4 * cg_ints > streams ? 4 * cg_ints : streams);
  return l;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// A staged column's reference: the stage word where its chunk's samples
// start (its row r and the byte offset `off` of its table offset v n
// within 16 bytes) and the funnel shift, r WINDOW_WORDS + off / 4 |
// 8 (off % 4) << 16.
__device__ __forceinline__ int col_ref(int r, long long base) {
  const int off = (int)(base & 15);
  return (r * WINDOW_WORDS + (off >> 2)) | ((8 * (off & 3)) << 16);
}

// The word of samples [k0 + pos, k0 + pos + 4) of the staged column `ref`.
__device__ __forceinline__ uint32_t ring_word(const uint32_t* st, int ref,
                                              int pos) {
  const int wi = (ref & 0xffff) + (pos >> 2);
  return __funnelshift_r(st[wi], st[wi + 1], ref >> 16);
}

// The words of samples [k0 + pos, k0 + pos + 8).
__device__ __forceinline__ uint2 ring_word2(const uint32_t* st, int ref,
                                            int pos) {
  const int wi = (ref & 0xffff) + (pos >> 2), sh = ref >> 16;
  const uint32_t a = st[wi], b = st[wi + 1], c = st[wi + 2];
  return make_uint2(__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh));
}

// A subset's codes are stored a row a subset with sample word w at
// (w % 4) 8 + w / 4, so that lane t's words of a chunk's four k-steps
// (w = t + 4 i) are the eight words from t 8.
__device__ __forceinline__ int zword_at(int w) {
  return (w & 3) * 8 + (w >> 2);
}

template <int MTW>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
mi_turbo_digest_kernel(Args a) {
  constexpr int NTW = ACC_TILES / MTW;
  constexpr int KH = MTW <= 2 ? 2 : 1;       // k-steps a group of products
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int w = blockIdx.x, n = a.n, L = a.L, m = a.m, NP = a.NP;
  const Layout lay = layout(NP, warps, a.hist_ints, m, MTW, a.cg_ints,
                            a.zrows);
  double* pstat = reinterpret_cast<double*>(smem);
  double* paux = pstat + NP;                   // n_obs, then log p
  int* pdf = reinterpret_cast<int*>(smem + lay.df);
  uint8_t* psuff = smem + lay.suff;
  int* hist = reinterpret_cast<int*>(smem + lay.hist) + warp * a.hist_ints;
  int* cref = reinterpret_cast<int*>(smem + lay.cols);  // col_ref of each
  uint8_t* coff = smem + lay.flags;            // a column's nz offset flag
  int* zdesc = reinterpret_cast<int*>(smem + lay.zdesc);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(smem);
  uint32_t* abuf = reinterpret_cast<uint32_t*>(smem + lay.abuf);
  uint32_t* zbuf = reinterpret_cast<uint32_t*>(smem + lay.zbuf);
  int* cg = reinterpret_cast<int*>(smem + lay.ring);
  // a buffer of A rows and of codes (the codes' rows and the zero row)
  const int abuf_words = 16 * MTW * WINDOW_WORDS;
  const int zbuf_words = (a.zrows + 1) * WINDOW_WORDS;
  const long long* Cw = a.C + (long long)w * m;
  const long long T = a.Ts[w];
  const size_t total = (size_t)a.p * n;
  const int o = a.nz == 2 ? 1 : 0;             // level offset of the cells
  const int Lr = L - o, LL = Lr * Lr;
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const int* colo = a.plan;

  // column 0 the target, 1 + j candidate j: its offset in the table and
  // (nz 1) whether its level 0 is cut from the table
  for (int r = threadIdx.x; r <= m; r += blockDim.x) {
    const long long v = r == 0 ? T : Cw[r - 1];
    cref[r] = col_ref(r, v * n);
    coff[r] = a.nz == 1 ? (a.max_vals[v] > 1) : 0;
  }
  __syncthreads();
  const int ox = coff[0];

  auto load_stage = [&](int k0, uint8_t* st) {
    for (int idx = threadIdx.x; idx < (m + 1) * WORDS16; idx += blockDim.x) {
      const int r = idx / WORDS16, c = idx - r * WORDS16;
      const size_t base = (size_t)(r == 0 ? T : Cw[r - 1]) * n;
      const size_t ad = ((base + k0) & ~(size_t)15) + 16 * c;
      const int bytes =
          ad >= total ? 0 : total - ad >= 16 ? 16 : (int)(total - ad);
      fw_pipe::cp_async16(st + r * WINDOW + 16 * c,
                          bytes ? a.dataT + ad : a.dataT, bytes);
    }
  };

  for (int ps = 0; ps < a.npass; ++ps) {
    const int* pp = a.plan + a.U + 1 + 4 * ps;
    const int j0 = pp[0], j1 = pp[1], u0 = pp[2], u1 = pp[3];
    const int R0 = (j0 * LL) & ~15, R1 = (j1 * LL + 15) & ~15;
    const int C0 = colo[u0] & ~7, C1 = (colo[u1] + 7) & ~7;
    const int mcount = (R1 - R0) >> 4, ntp = (C1 - C0) >> 3;
    const int rs = ((8 * ntp + 31) & ~31) + 8;  // slab row stride, ints
    const int q = (ntp + warps - 1) / warps;    // N-tiles a warp
    const int wn0 = warp * q;
    const int nq = min(q, ntp - wn0);
    const int jf0 = R0 / LL, jf1 = min(m, (R1 + LL - 1) / LL);
    const int nu = u1 - u0;

    // the B column of each of this warp's N-tiles (ni, g): the word offset
    // of its subset's codes and its stratum (the zero row and no code
    // outside the pass's subsets), kept in shared memory, not registers
    uint2* ltab = reinterpret_cast<uint2*>(smem + lay.lanes) + warp * NTW * 8;
    for (int ni = t; ni < NTW; ni += 4) {
      const int c = C0 + 8 * (wn0 + ni) + g;
      uint2 e = make_uint2(((uint32_t)lay.zbuf >> 2) + nu * WINDOW_WORDS,
                           NO_CODE);
      if (ni < nq && c >= colo[u0] && c < colo[u1]) {
        int lo = u0, hi = u1 - 1;              // the u with colo[u] <= c
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (colo[mid] <= c) lo = mid; else hi = mid - 1;
        }
        e = make_uint2(((uint32_t)lay.zbuf >> 2) + (lo - u0) * WINDOW_WORDS,
                       0x01010101u * (uint32_t)(c - colo[lo]));
      }
      ltab[ni * 8 + g] = e;
    }
    int acc[MTW][NTW][4];
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    __syncthreads();      // the slab of the previous pass has been read
    // in both buffers: rows of the pass past the last candidate stay 0,
    // and the row after the codes is the zero row of B columns outside the
    // pass's subsets
    for (int i = threadIdx.x; i < (R1 - R0) * WINDOW_WORDS; i += blockDim.x)
      if (R0 + i / WINDOW_WORDS >= m * LL)
        abuf[i] = abuf[abuf_words + i] = 0u;
    for (int i = threadIdx.x; i < CHUNK / 4; i += blockDim.x)
      zbuf[nu * WINDOW_WORDS + i] =
          zbuf[zbuf_words + nu * WINDOW_WORDS + i] = 0u;
    // each subset of the pass: its size and its members' column references
    for (int i = threadIdx.x; i < nu * ZDESC_INTS; i += blockDim.x) {
      const int u = u0 + i / ZDESC_INTS, k = i % ZDESC_INTS;
      const int* mb = a.memb + (size_t)u * a.max_k;
      zdesc[i] = k == 0 ? a.klen[u] : k <= a.klen[u] ? cref[1 + mb[k - 1]] : 0;
    }
    // the chunks: a ring of STAGES raw chunks, and two buffers of the A
    // rows and codes formed from them, so that chunk kc + 1 is formed in
    // the same phase as chunk kc is multiplied (one barrier a chunk)
    auto stage = [&](int kc) {
      return smem + lay.ring + (kc % STAGES) * (m + 1) * WINDOW;
    };
    auto form = [&](int kc) {
      const uint32_t* st = reinterpret_cast<const uint32_t*>(stage(kc));
      uint32_t* ab = abuf + (kc & 1) * abuf_words;
      uint32_t* zb = zbuf + (kc & 1) * zbuf_words;
      const int rem = n - kc * CHUNK;   // valid samples from the chunk's start
      // A: candidate j's Lr^2 cells of each word, 0x01 a joint match
      for (int task = threadIdx.x; task < (jf1 - jf0) * 32;
           task += blockDim.x) {
        const int j = jf0 + (task >> 5), wd = task & 31, pos = 4 * wd;
        const uint32_t xw = ring_word(st, cref[0], pos);
        const uint32_t yw = ring_word(st, cref[1 + j], pos);
        uint32_t keep = 0xffffffffu;
        if (rem - pos < 4) {            // only in the chunk that holds sample n
          const int k = max(0, rem - pos);
          keep = k == 0 ? 0u : (0xffffffffu >> (32 - 8 * k));
        }
        const int oy = coff[1 + j];
        uint32_t xm[MAX_LR];
#pragma unroll
        for (int x = 0; x < MAX_LR; ++x)
          xm[x] = (x >= Lr || (x + o == 0 && ox))
                      ? 0u
                      : fw_pipe::match80(xw, 0x01010101u * (x + o)) & keep;
        for (int b = 0; b < Lr; ++b) {
          const uint32_t ym = (b + o == 0 && oy)
                                  ? 0u
                                  : fw_pipe::match80(yw, 0x01010101u * (b + o));
          const int row0 = j * LL + Lr * b - R0;
#pragma unroll
          for (int x = 0; x < MAX_LR; ++x) {
            const int row = row0 + x;
            if (x < Lr && row >= 0 && row < R1 - R0)
              ab[row * WINDOW_WORDS + wd] = (xm[x] & ym) >> 7;
          }
        }
      }
      // stratum codes of the pass's subsets, a byte a sample, two words a
      // task
      for (int task = threadIdx.x; task < nu * 16; task += blockDim.x) {
        const int iu = task >> 4, wd = 2 * (task & 15), pos = 4 * wd;
        const int4 d0 = reinterpret_cast<const int4*>(zdesc)[2 * iu];
        const int4 d1 = reinterpret_cast<const int4*>(zdesc)[2 * iu + 1];
        const int ref[ZDESC_INTS - 1] = {d0.y, d0.z, d0.w, d1.x, d1.y, d1.z,
                                         d1.w};
        uint32_t z0 = 0u, z1 = 0u, wz = 1u;
#pragma unroll
        for (int i = 0; i < ZDESC_INTS - 1; ++i) {
          if (i < d0.x) {
            const uint2 v = ring_word2(st, ref[i], pos);
            z0 += v.x * wz;
            z1 += v.y * wz;
          }
          wz *= (uint32_t)L;
        }
        zb[iu * WINDOW_WORDS + zword_at(wd)] = z0;
        zb[iu * WINDOW_WORDS + zword_at(wd + 1)] = z1;
      }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < chunks) load_stage(s * CHUNK, stage(s));
      fw_pipe::cp_async_commit();
    }
    fw_pipe::cp_async_wait<STAGES - 2>();
    __syncthreads();      // chunk 0 landed; the pass's descriptors written
    form(0);
    if (STAGES - 1 < chunks)
      load_stage((STAGES - 1) * CHUNK, stage(STAGES - 1));
    fw_pipe::cp_async_commit();
    for (int kc = 0; kc < chunks; ++kc) {
      fw_pipe::cp_async_wait<STAGES - 2>();
      // chunk kc + 1 landed; chunk kc formed; chunk kc - 1 multiplied, so
      // its buffers and chunk kc's ring stage are free
      __syncthreads();
      if (kc + STAGES < chunks) load_stage((kc + STAGES) * CHUNK, stage(kc));
      fw_pipe::cp_async_commit();
      if (kc + 1 < chunks) form(kc + 1);

      // the products of chunk kc: KH k-steps at a time (two where A's
      // fragments of two fit the registers beside the accumulators), A by
      // ldmatrix, each N-tile's B from its lane's codes (2 KH words of KH
      // k-steps in one load)
      const unsigned char* ab =
          reinterpret_cast<const unsigned char*>(abuf + (kc & 1) * abuf_words);
      const uint32_t zw0 = (uint32_t)(kc & 1) * zbuf_words;
#pragma unroll
      for (int kg = 0; kg < CHUNK; kg += 32 * KH) {
        uint32_t af[KH][MTW][4];
#pragma unroll
        for (int h = 0; h < KH; ++h)
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi)
            if (mi < mcount)
              ldsm_x4(af[h][mi], ab + (16 * mi + (lane & 15)) * WINDOW + kg +
                                     32 * h + ((lane >> 4) << 4));
#pragma unroll
        for (int ni = 0; ni < NTW; ++ni) {
          if (ni < nq) {
            const uint2 lc = ltab[ni * 8 + g];
            const uint32_t* zr = sw + lc.x + zw0 + 8 * t + (kg >> 4);
            uint32_t b[2 * KH];
            if constexpr (KH == 2) {
              const uint4 zw = *reinterpret_cast<const uint4*>(zr);
              b[0] = zw.x, b[1] = zw.y, b[2] = zw.z, b[3] = zw.w;
            } else {
              const uint2 zw = *reinterpret_cast<const uint2*>(zr);
              b[0] = zw.x, b[1] = zw.y;
            }
#pragma unroll
            for (int i = 0; i < 2 * KH; ++i)
              b[i] = fw_pipe::match80(b[i], lc.y);
#pragma unroll
            for (int h = 0; h < KH; ++h)
#pragma unroll
              for (int mi = 0; mi < MTW; ++mi)
                if (mi < mcount)
                  fw_pipe::mma_u8(acc[mi][ni], af[h][mi], b[2 * h],
                                  b[2 * h + 1]);
          }
        }
      }
    }
    fw_pipe::cp_async_wait<0>();
    __syncthreads();      // every warp's products done: the slab may alias

    // the accumulators into the (rows x columns) slab: row R0 + i, column
    // C0 + c at cg[i * rs + c]; counts are the sums >> 7
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTW; ++ni)
        if (mi < mcount && ni < nq) {
          int* d = cg + (16 * mi + g) * rs + 8 * (wn0 + ni) + 2 * t;
          *reinterpret_cast<int2*>(d) =
              make_int2(acc[mi][ni][0] >> 7, acc[mi][ni][1] >> 7);
          *reinterpret_cast<int2*>(d + 8 * rs) =
              make_int2(acc[mi][ni][2] >> 7, acc[mi][ni][3] >> 7);
        }
    __syncthreads();

    // the pass's template pairs: gather, then K5's epilogue
    const int* poffs = a.plan + a.U + 1 + 4 * a.npass;
    const int* ppairs = poffs + a.npass + 1;
    for (int i = poffs[ps] + warp; i < poffs[ps + 1]; i += warps) {
      const int p = ppairs[i];
      const int j = a.pj[p], u = a.pu[p];
      const int S = colo[u + 1] - colo[u];
      const int* blk = cg + (j * LL - R0) * rs + (colo[u] - C0);
      for (int k = lane; k < LL * S; k += 32) {
        const int s = k / LL, cell = k - s * LL;
        hist[k] = blk[cell * rs + s];
      }
      __syncwarp();
      const long long Y = Cw[j];
      const int oy = coff[1 + j];
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
          const size_t gi = (size_t)w * NP + p;
          a.pair_stat[gi] = res.stat;
          a.pair_df[gi] = res.df;
          a.pair_nobs[gi] = res.n_obs;
          a.pair_suff[gi] = res.suff;
        }
      }
      __syncwarp();                            // before the next pair's gather
    }
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

template <int MTW>
cudaError_t launch(const Args& a, int warps, int bytes, cudaStream_t s) {
  static bool raised[fw_smem::kMaxDevices] = {};
  const cudaError_t err = fw_smem::raise_limit_once(
      mi_turbo_digest_kernel<MTW>, SMEM_BLOCK_BYTES, raised);
  if (err != cudaSuccess) return err;
  mi_turbo_digest_kernel<MTW><<<a.W, warps * 32, bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shared-memory bytes of a K7 block (ops/kernels.py:k7_smem_bytes
// computes the same): NP distinct pairs, `warps` histogram slices of
// hist_ints ints, the warps' B columns, the window's m + 1 columns, and the
// larger of the pass
// streams (ring, mtw M-tiles of A, zrows subsets' codes) and the slab of
// cg_ints ints that aliases them.
int fw_mi_turbo_smem_bytes(int NP, int warps, int hist_ints, int m, int mtw,
                           int cg_ints, int zrows) {
  return layout(NP, warps, hist_ints, m, mtw, cg_ints, zrows).bytes;
}

// Launches K7 on `stream` for W windows and returns the cudaError_t of the
// launch (0 on success).  dataT: (p, n) int8 contiguous, values 0..L-1;
// levels, max_vals: (p,) int32; Ts: (W,) and C: (W, m) int64 variable
// indices; the template as int32 arrays (pj, pu (NP,), tpair (B,), memb
// (U, max_k), klen (U,), counts and offs (NC,)); plan: int32, the subsets'
// first columns (U + 1,), npass passes (j0, j1, u0, u1), each pass's first
// entry in the pair list (npass + 1,) and the pair list (NP,), with mtw
// M-tiles a pass at most, warps a block, a slab of cg_ints ints and zrows
// subsets a pass at most (ops/kernels.py:k7_plan); hist_ints: (Lr + 1)^2
// L^max(klen); nz: 0 plain, 1 nz, 2 nz-uniform (L == 3); lg: (max_df / 2,
// 2) float64; out: (3, W, NC) float64; the pair outputs (W, NP) float64 /
// int64 / float64 / uint8, all null or none.
int fw_mi_turbo_digest(const void* dataT, int n, int p, const void* levels,
                       const void* max_vals, const void* Ts, const void* C,
                       int W, int m, int L, int nz, const void* pj,
                       const void* pu, const void* tpair, const void* memb,
                       const void* klen, const void* counts, const void* offs,
                       const void* plan, int U, int npass, int mtw, int warps,
                       int cg_ints, int zrows, int NP, int NC, int max_k,
                       int hist_ints, double hps, double log_alpha,
                       int max_df, const void* lg, void* out, void* pair_stat,
                       void* pair_df, void* pair_nobs, void* pair_suff,
                       void* stream) {
  const int Lr = nz == 2 ? L - 1 : L;
  if (n <= 0 || n >= (1 << 24) || p <= 0 || W <= 0 || m < 1 || NP <= 0 ||
      NC <= 0 || U <= 0 || npass <= 0 || L < 2 || Lr > MAX_LR || nz < 0 ||
      nz > 2 || (nz == 2 && L != 3) || hist_ints <= 0 || mtw < 1 ||
      mtw > MAX_MTW || warps < 1 || warps > MAX_WARPS || zrows < 1 ||
      cg_ints < 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = fw_mi_turbo_smem_bytes(NP, warps, hist_ints, m, mtw,
                                           cg_ints, zrows);
  if (bytes > SMEM_BLOCK_BYTES) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const int8_t*>(dataT), n, p,
         static_cast<const int*>(levels), static_cast<const int*>(max_vals),
         static_cast<const long long*>(Ts), static_cast<const long long*>(C),
         W, m, L, nz,
         static_cast<const int*>(pj), static_cast<const int*>(pu),
         static_cast<const int*>(tpair), static_cast<const int*>(memb),
         static_cast<const int*>(klen), static_cast<const int*>(counts),
         static_cast<const int*>(offs), static_cast<const int*>(plan), U,
         npass, cg_ints, zrows, NP, NC, max_k, hist_ints, hps, log_alpha,
         max_df, static_cast<const double*>(lg),
         static_cast<double*>(out), static_cast<double*>(pair_stat),
         static_cast<long long*>(pair_df), static_cast<double*>(pair_nobs),
         static_cast<uint8_t*>(pair_suff)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mtw) {
    case 1: return (int)launch<1>(a, warps, bytes, s);
    case 2: return (int)launch<2>(a, warps, bytes, s);
    case 3: return (int)launch<3>(a, warps, bytes, s);
    default: return (int)launch<4>(a, warps, bytes, s);
  }
}

}  // extern "C"
