// K5: the conditional mi / mi_nz G-test of a batch of (X, Y | Z) tests:
// each test's stratified contingency table, its signed mutual information,
// adjusted df, row count and power check, in one kernel.
//
// Replaces the JAX package's conditional test function
// flashweave_tpu/ops/condtests.py:110 `_mi_cond_kernel` with its table
// flashweave_tpu/ops/contingency.py:124 `cond_ctab_batch`, whose TPU branch
// is the byte-packed compare-reduce `_packed_hist` (:98).  Neither is a
// `pl.pallas_call`: the TPU ran them as XLA functions.  Same function as the
// port's plain version, ops/kernels.py:mi_cond_stats_ref (the row mask,
// ops/contingency.py:cond_ctab_batch's scatter_add_ histogram,
// ops/statfuns.py:mi_stats, the occupied strata and the power check), for
// tables whose strata are not compacted (S == L^max_k).
//
// Inputs: the (p, n) int8 table, `levels` and `max_vals` (p,) int32, and one
// int32 descriptor row a test, [X, Y, k, Z_0 .. Z_{max_k-1}].  A test's
// rows pass the row mask of its mode (0: every row; 1, nz: rows where X is
// nonzero unless max_vals[X] <= 1, and the same for Y; 2, nz-uniform: rows
// where X and Y are both nonzero) and fall into cell
//   (x - o) + Lr (y - o) + Lr^2 z,   z = sum_{j<k} Z_j L^j,
// with o = 1 and Lr = L - 1 in mode 2 (the sliced table, as `reduced=True`
// builds it), o = 0 and Lr = L otherwise.  Masked rows are skipped.
//
// What bounds it on this card: the bytes.  A test reads its 2 + k columns,
// (2 + k) n bytes of the table, and writes 25 bytes; its table holds a few
// hundred cells at most (108 at the nz-uniform headline), so the float64
// epilogue is small against the reads.  At 4,096 tests of k = 0..3 on a
// 2,048-row table that is ~29 MB, 9 us at 3.35 TB/s.  Below that bound the
// shared-memory atomics of the histogram (one a kept row) and the latency
// of each warp's loads decide.
//
// What the design does about it:
// - one warp a test, four tests a block; each warp keeps its test's int32
//   histogram and margins in its own slice of shared memory, (Lr + 1)^2 S
//   ints, and fills it with shared atomics; nothing of a test but its four
//   results reaches device memory (the plain version builds about six
//   (n, B) int64 tensors a chunk and sends every masked row to one spare
//   bin in device memory);
// - where n is a multiple of 16 and the table 16-byte aligned, a lane reads
//   16 rows of each column as one 16-byte load, neighbouring lanes on
//   neighbouring rows, and builds the 16 z-codes in registers; otherwise
//   each lane reads single bytes, a warp 32 neighbouring rows;
// - the epilogue runs in float64 over the warp (csrc/mi_cond_epilogue.cuh,
//   which K7 shares): row and column margins a (level, stratum), then the
//   occupied strata, n_obs and the adjusted df a stratum, then the MI terms
//   a cell, reduced with shuffles; the term is the plain version's
//   log((m_k c) / (m_i m_j)) c and the flip its mi_neg (n_neg / n) >
//   mi_pos (n_pos / n), with explicitly rounded products and sums
//   (__dmul_rn, __dadd_rn), so no multiply-add is fused where the plain
//   version rounds twice; only the order of the sums differs;
// - one launch serves a whole call of the engine, so its descriptors go up
//   as one int32 array (no 4,096-test chunks as the plain version's
//   temporaries need).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mi_cond_epilogue.cuh"
#include "smem_limit.cuh"

namespace {

constexpr int WARPS = 4;              // tests a block, one warp each
// shared-memory ints a test at most, (Lr + 1)^2 S: the histogram (Lr^2 S),
// the row and column margins (2 Lr S) and the strata (S); 32 KiB, the
// budget ops/kernels.py:K5_TEST_BYTES states
constexpr int TEST_INTS = 8192;
constexpr int MAX_SMEM_BYTES = WARPS * TEST_INTS * 4;

struct Batch {
  const int8_t* dataT;     // (p, n) int8, contiguous
  int n;
  const int* levels;       // (p,)
  const int* max_vals;     // (p,)
  const int* desc;         // (B, 3 + max_k) int32
  int B, max_k, L, nz;
  double hps;
  bool vec;                // 16-byte loads: n % 16 == 0, table aligned
  double* stat;
  long long* df;
  double* nobs;
  uint8_t* suff;
};

__device__ __forceinline__ int byte_at(const uint4& v, int i) {
  const unsigned w = i < 4 ? v.x : i < 8 ? v.y : i < 12 ? v.z : v.w;
  return (int)((w >> (8 * (i & 3))) & 0xffu);
}

__device__ __forceinline__ uint4 load16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__global__ void __launch_bounds__(WARPS * 32)
mi_cond_stats_kernel(Batch a) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t = (long long)blockIdx.x * WARPS + warp;
  if (t >= a.B) return;                        // whole warps only
  const int L = a.L, n = a.n;
  const int o = a.nz == 2 ? 1 : 0;             // level offset of the cells
  const int Lr = L - o;
  int S = 1;
  for (int j = 0; j < a.max_k; ++j) S *= L;
  const int LL = Lr * Lr, C = LL * S;
  int* hist = smem + warp * (Lr + 1) * (Lr + 1) * S;
  for (int i = lane; i < C; i += 32) hist[i] = 0;

  const int* d = a.desc + t * (3 + a.max_k);
  const int X = d[0], Y = d[1];
  const int k = min(max(d[2], 0), a.max_k);
  // nz offsets of the diagonal and the mask (mode 1 only)
  const int ox = a.nz == 1 ? (a.max_vals[X] > 1) : 0;
  const int oy = a.nz == 1 ? (a.max_vals[Y] > 1) : 0;
  const int8_t* xc = a.dataT + (size_t)X * n;
  const int8_t* yc = a.dataT + (size_t)Y * n;
  __syncwarp();

  auto add = [&](int x, int y, int z) {
    const bool keep = a.nz == 2 ? (x != 0 && y != 0)
                      : a.nz == 1 ? ((x != 0 || !ox) && (y != 0 || !oy))
                                  : true;
    if (keep) atomicAdd(&hist[(x - o) + Lr * (y - o) + LL * z], 1);
  };

  if (a.vec) {
    for (int r0 = 16 * lane; r0 < n; r0 += 16 * 32) {
      const uint4 xv = load16(xc + r0), yv = load16(yc + r0);
      int z[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) z[i] = 0;
      int w = 1;
      for (int j = 0; j < k; ++j) {
        const uint4 zv = load16(a.dataT + (size_t)d[3 + j] * n + r0);
#pragma unroll
        for (int i = 0; i < 16; ++i) z[i] += byte_at(zv, i) * w;
        w *= L;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) add(byte_at(xv, i), byte_at(yv, i), z[i]);
    }
  } else {
    for (int r = lane; r < n; r += 32) {
      int z = 0, w = 1;
      for (int j = 0; j < k; ++j) {
        z += a.dataT[(size_t)d[3 + j] * n + r] * w;
        w *= L;
      }
      add(xc[r], yc[r], z);
    }
  }
  __syncwarp();

  // the float64 epilogue (csrc/mi_cond_epilogue.cuh); the power check's
  // lx and ly are the sliced table's levels under nz, the variables' own
  // otherwise
  double lx, ly;
  if (a.nz) {
    lx = (double)(L - (a.nz == 2 ? 1 : ox));
    ly = (double)(L - (a.nz == 2 ? 1 : oy));
  } else {
    lx = (double)a.levels[X];
    ly = (double)a.levels[Y];
  }
  const fw_cond::CondResult res =
      fw_cond::cond_epilogue(hist, Lr, S, ox, oy, lx, ly, a.hps, lane);
  if (lane != 0) return;
  a.stat[t] = res.stat;
  a.df[t] = res.df;
  a.nobs[t] = res.n_obs;
  a.suff[t] = res.suff;
}

}  // namespace

extern "C" {

// Launches K5 on `stream` for B tests and returns the cudaError_t of the
// launch (0 on success).  dataT: (p, n) int8 contiguous, values in
// 0..L-1; levels, max_vals: (p,) int32; desc: (B, 3 + max_k) int32 rows
// [X, Y, k, Z_0 .. Z_{max_k-1}]; nz: 0 plain, 1 nz, 2 nz-uniform (L == 3);
// outputs (B,) float64 stat, int64 df, float64 n_obs, uint8 suff.  The
// test's cells, (Lr + 1)^2 L^max_k ints, must fit TEST_INTS.
int fw_mi_cond_stats(const void* dataT, int n, int p, const void* levels,
                     const void* max_vals, const void* desc, int B, int max_k,
                     int L, int nz, double hps, void* stat, void* df,
                     void* nobs, void* suff, void* stream) {
  if (n <= 0 || p <= 0 || B <= 0 || max_k < 0 || L < 1 || L > 127 ||
      nz < 0 || nz > 2 || (nz == 2 && L != 3))
    return (int)cudaErrorInvalidValue;
  const long long Lr = nz == 2 ? L - 1 : L;
  long long ints = (Lr + 1) * (Lr + 1);
  for (int j = 0; j < max_k && ints <= TEST_INTS; ++j) ints *= L;
  if (ints > TEST_INTS) return (int)cudaErrorInvalidValue;
  static bool raised[fw_smem::kMaxDevices] = {};
  const cudaError_t attr =
      fw_smem::raise_limit_once(mi_cond_stats_kernel, MAX_SMEM_BYTES, raised);
  if (attr != cudaSuccess) return (int)attr;
  Batch a{static_cast<const int8_t*>(dataT), n,
          static_cast<const int*>(levels), static_cast<const int*>(max_vals),
          static_cast<const int*>(desc), B, max_k, L, nz, hps,
          n % 16 == 0 && (reinterpret_cast<uintptr_t>(dataT) & 15) == 0,
          static_cast<double*>(stat), static_cast<long long*>(df),
          static_cast<double*>(nobs), static_cast<uint8_t*>(suff)};
  const int blocks = (B + WARPS - 1) / WARPS;
  mi_cond_stats_kernel<<<blocks, WARPS * 32, (int)(WARPS * ints * 4),
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
