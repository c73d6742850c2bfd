// Univariate mi / mi_nz G-test of an X-block against a Y-slab, with the
// joint counts on the int8 tensor cores: K1's function for L = 2..127.
//
// Replaces the TPU kernel flashweave_tpu/ops/pallas_kernels.py:639
// `mi_univar_stats_planes` (body `_make_mi_planes_kernel` :606, epilogue
// `_mi_epilogue` :305), fed there by `x_indicator_planes` :575 and
// `y_indicator_planes` :592.  Same function as K1 (mi_univar_stats.cu): for
// every pair (X, Y) the (L-1)^2 joint counts of levels >= 1 are one product
// of level-indicator matrices, (K * tx x n) . (n x K * ty) with K = L - 1;
// row 0, column 0 and the corner of the L x L table are rebuilt from the
// level marginals and n, then nz slicing, signed MI, adjusted df, n_obs and
// the pre/post power checks.  Only those four per-pair values reach the
// outputs.
//
// What bounds it on this card: the data-sheet bound is int8 tensor-core
// operations.  Phase 6's block of the 12-level slice (n = 2048, X-block
// 512 against a 10,000-wide Y-slab) is 2 * 121 * 2048 * 5.12e6 = 2.5e12
// int8 ops, 1.28 ms at 1,979 TOPS; the 3-level slice's block 0.042 ms.
// The counts cross device memory once each way: at phase 6's block
// 2.48 GB of int32 counts written and read, ~1.5 ms at 3.35 TB/s, which a
// streaming epilogue would remove.  Below both, forming the indicators
// costs integer instructions in step with the mma (K3's loop), and the
// epilogue's float64 logs, up to L^2 a pair, run on the FP64 units.  On
// an H100 80GB HBM3 at 700 W (chip_smoke.py phase 2c, PERF.md section 6)
// those two set the time: at phase 6's block the count kernel takes about
// two thirds of it, at K3's speed per sweep, and the epilogue kernel the
// other third, far more than its slab reads; and both stay far from the
// data-sheet bound.
//
// What the design does about it:
// - the counts run on the pipelined loop of int8_indicator_pipe.cuh from
//   level 1 (level_products<1>): a 3-stage cp.async ring of aligned windows
//   for any n, each warp owning a 16 x 16 pair sub-tile of the block's
//   32 x 64 pairs and all of its level products, 3 x 3 levels a sweep,
//   two blocks an SM; the TPU's K-fold indicator planes in HBM never exist;
// - a block tile's (L-1)^2 counts (991 KB at L = 12) do not fit in shared
//   memory, so the count kernel writes them as int32 to a slab in device
//   memory, count-major, [(a-1) K + (b-1)][pair], with the pairs in
//   the order block tile, warp sub-tile, then row-major inside the 16 x 16
//   sub-tile: a warp writes each level pair's counts as one 1 KB run, and
//   the epilogue's reads of a count are coalesced across threads.  The
//   wrapper walks the block in sub-blocks of whole block tiles whose slab
//   stays under 1 GB;
// - the count kernel's grid is block tiles x X level groups: each block
//   takes one group of 3 X levels against all Y levels (ceil((L-1)/3)
//   sweeps), so the grid stays wide at high L, where few block tiles fit
//   the slab (8 at L = 127);
// - the epilogue is K1's in float64, written for a runtime L (one thread a
//   pair in 64-thread blocks, the counts read back from the slab), with the
//   same summation order, so the card's decisions equal the float64 CPU
//   path's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_indicator_pipe.cuh"

namespace {

using fw_pipe::BX;
using fw_pipe::BY;
using fw_pipe::G;
using fw_pipe::THREADS;
using fw_pipe::WXN;

constexpr int MAX_L = 128;
constexpr int PAIRS = BX * BY;          // pairs of a block tile (2048)
constexpr int SUB_PAIRS = 16 * 16;      // pairs of a warp's sub-tile
constexpr int EPI_THREADS = 64;         // epilogue kernel: threads a block

// An X-block [x_start, x_start + tile) against a Y-slab [y_start, y_start +
// y_len) and its outputs, (tile, y_len) blocks with row stride ld.
struct Block {
  const int8_t* dataT;   // (p, n) int8, contiguous, 16-byte aligned
  int n, p, L, nz;
  int x_start, tile, y_start, y_len, ld;
  const int* marg;       // (L, p) level marginals
  const int* levels;     // (p,)
  const int* max_vals;   // (p,)
  double hps, n_obs_min;
  double* stat;
  int* df;
  int* nobs;
  bool* suff;
};

// Block tile bt of the block (X tiles vary fastest, as in K3).
__device__ __forceinline__ fw_pipe::Tile block_tile(const Block& B, int bt) {
  const int ntx = (B.tile + BX - 1) / BX;
  const int xt = (bt % ntx) * BX, yt = (bt / ntx) * BY;
  return fw_pipe::Tile{B.dataT, B.n, (size_t)B.p * B.n, B.x_start + xt,
                       min(BX, B.tile - xt), B.y_start + yt,
                       min(BY, B.y_len - yt)};
}

// Epilogue of the tile loop: each sweep's counts of levels (a, b) go to
// slab[((a-1) K + (b-1)) * stride + base + warp * 256 + r * 16 + c] for
// row r and column c of the warp's sub-tile, two neighbouring columns a
// store.
struct CountStore {
  int* slab;
  size_t stride;   // pairs of the slab (counts of one level pair)
  size_t base;     // the block tile's first pair
  int K;

  __device__ __forceinline__ void operator()(
      int a0, int na, int b0, int nb, const int (&acc)[G][G][2][4]) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int a = 0; a < G; ++a)
#pragma unroll
      for (int b = 0; b < G; ++b) {
        if (a >= na || b >= nb) continue;
        int* dst = slab + (size_t)((a0 + a - 1) * K + b0 + b - 1) * stride +
                   base + warp * SUB_PAIRS + 2 * q;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(dst + (g + 8 * h) * 16 + 8 * j) =
                make_int2(acc[a][b][j][2 * h] >> 7, acc[a][b][j][2 * h + 1] >> 7);
      }
  }
};

// The counts of one pair in the slab: jc(a, b), levels a, b >= 1.
struct PairCounts {
  const int* at;   // the pair's count of levels (1, 1)
  size_t stride;
  int K;

  __device__ __forceinline__ int operator()(int a, int b) const {
    return at[(size_t)((a - 1) * K + b - 1) * stride];
  }
};

// G-test epilogue for one pair in float64 (semantics of
// ops.univariate.mi_block_stats; the arithmetic and order of K1's epilogue
// in mi_univar_stats.cu).  jc(a, b) is the joint count of levels a, b >= 1.
__device__ __forceinline__ void epilogue(
    const PairCounts& jc, int L, const int* __restrict__ marg, int p, int gx, int gy,
    int lx_i, int ly_i, int mvx, int mvy, int n_rows, int nz, double hps,
    double n_obs_min, double* stat, int* df_out, int* nobs_out,
    bool* suff_out) {
  const int K = L - 1;
  auto mx = [&](int a) { return marg[(size_t)a * p + gx]; };
  auto my = [&](int b) { return marg[(size_t)b * p + gy]; };

  int rowJ[MAX_L], colJ[MAX_L];   // row / column sums of the joint counts
  for (int b = 1; b <= K; ++b) colJ[b] = 0;
  int sum_mx = 0, sum_my = 0, sum_joint = 0;
  for (int a = 1; a <= K; ++a) {
    int r = 0;
    for (int b = 1; b <= K; ++b) {
      const int v = jc(a, b);
      r += v;
      colJ[b] += v;
    }
    rowJ[a] = r;
    sum_joint += r;
    sum_mx += mx(a);
  }
  for (int b = 1; b <= K; ++b) sum_my += my(b);
  const int cnt00 = n_rows - sum_mx - sum_my + sum_joint;
  // cell (a, b) of the full L x L table
  auto cell = [&](int a, int b) -> int {
    if (a > 0 && b > 0) return jc(a, b);
    if (a > 0) return mx(a) - rowJ[a];
    if (b > 0) return my(b) - colJ[b];
    return cnt00;
  };

  // nz offsets: 2 (uniform) means every variable has 3 levels, so both are 1
  const int ox = nz == 2 ? 1 : (nz ? (mvx > 1) : 0);
  const int oy = nz == 2 ? 1 : (nz ? (mvy > 1) : 0);
  // sums of the sliced table (rows a >= ox, columns b >= oy), exact in int
  auto row_sub = [&](int a) -> int {
    if (a < ox) return 0;
    const int full = a > 0 ? mx(a) : n_rows - sum_mx;
    return full - (oy ? cell(a, 0) : 0);
  };
  auto col_sub = [&](int b) -> int {
    if (b < oy) return 0;
    const int full = b > 0 ? my(b) : n_rows - sum_my;
    return full - (ox ? cell(0, b) : 0);
  };
  const double n_view = (double)(ox ? sum_mx : n_rows);   // X-trimmed view
  int n_obs_i = 0, alx = 0, aly = 0;
  for (int a = 0; a < L; ++a) {
    const int r = row_sub(a), c = col_sub(a);
    n_obs_i += r;
    alx += r != 0;
    aly += c != 0;
  }
  const double n_obs = (double)n_obs_i;

  double mi_pos = 0.0, mi_neg = 0.0, n_pos = 0.0;
  for (int a = 0; a < L; ++a) {
    const double ra = (double)row_sub(a);
    for (int b = 0; b < L; ++b) {
      const double s = (a >= ox && b >= oy) ? (double)cell(a, b) : 0.0;
      const double cb = (double)col_sub(b);
      double term = 0.0;
      if (s != 0.0 && ra != 0.0 && cb != 0.0)
        term = __dmul_rn(log((n_obs * s) / (ra * cb)), s);
      if (a - ox == b - oy) {
        mi_pos += term;
        n_pos += s;
      } else {
        mi_neg += term;
      }
    }
  }
  const double n_neg = n_obs - n_pos;
  const double safe_n = n_obs > 0.0 ? n_obs : 1.0;
  double mi = (mi_pos + mi_neg) / safe_n;
  if (mi_neg * (n_neg / safe_n) > mi_pos * (n_pos / safe_n)) mi = -mi;

  // adjusted df (reference src/statfuns.jl:281-305)
  alx = alx > 1 ? alx : 1;
  aly = aly > 1 ? aly : 1;
  const int df = (alx - 1) * (aly - 1);

  // pre-check on the X-trimmed view (reference src/tests.jl:9-20)
  const double lx = (double)lx_i, ly = (double)ly_i;
  const double cells_pre = (lx - (lx > 1.0 ? 2.0 : 1.0)) * (ly - (ly > 1.0 ? 2.0 : 1.0));
  const bool pre_ok = n_view >= n_obs_min && (cells_pre > 0.0 ? n_view / cells_pre > hps : true);
  // post-check on the sliced table (reference src/tests.jl:56-62)
  const double lx_eff = nz ? (double)(L - ox) : lx;
  const double ly_eff = nz ? (double)(L - oy) : ly;
  const double cells_post = lx_eff * ly_eff;
  const bool post_ok = n_obs >= n_obs_min && (cells_post > 0.0 ? n_obs / cells_post > hps : true);
  const bool suff = pre_ok && post_ok && lx_i >= 2;

  *stat = suff ? mi : 0.0;
  *df_out = suff ? df : 0;
  *nobs_out = n_obs_i;
  *suff_out = suff;
}

// First kernel: the counts of block tile blockIdx.x at X levels
// [a_lo, a_lo + 3), a_lo = 1 + 3 * blockIdx.y, against all Y levels, to the
// slab.
__global__ void __launch_bounds__(THREADS, 2)
mi_univar_stats_planes_count_kernel(const Block B, int* __restrict__ slab) {
  extern __shared__ __align__(16) uint8_t smem[];
  CountStore put{slab, (size_t)gridDim.x * PAIRS, (size_t)blockIdx.x * PAIRS,
                 B.L - 1};
  const int a_lo = 1 + G * blockIdx.y;
  fw_pipe::level_products<1>(block_tile(B, blockIdx.x), B.L, a_lo,
                             min(B.L, a_lo + G), smem, put);
}

// Second kernel: the epilogue of slab pair i, in slot i % 2048 (warp
// sub-tile, then row-major inside it) of block tile i / 2048, if the pair
// lies in the block.
__global__ void __launch_bounds__(EPI_THREADS)
mi_univar_stats_planes_epilogue_kernel(const Block B,
                                       const int* __restrict__ slab,
                                       size_t stride) {
  const size_t i = (size_t)blockIdx.x * EPI_THREADS + threadIdx.x;
  const int bt = (int)(i / PAIRS), loc = (int)(i % PAIRS);
  const int ntx = (B.tile + BX - 1) / BX;
  const int w = loc / SUB_PAIRS;
  const int x = (bt % ntx) * BX + 16 * (w % WXN) + (loc % SUB_PAIRS) / 16;
  const int y = (bt / ntx) * BY + 16 * (w / WXN) + loc % 16;
  if (x >= B.tile || y >= B.y_len) return;
  const int gx = B.x_start + x, gy = B.y_start + y;
  const size_t o = (size_t)x * B.ld + y;
  epilogue(PairCounts{slab + i, stride, B.L - 1}, B.L, B.marg, B.p, gx, gy,
           B.levels[gx], B.levels[gy], B.max_vals[gx], B.max_vals[gy], B.n,
           B.nz, B.hps, B.n_obs_min, B.stat + o, B.df + o, B.nobs + o,
           B.suff + o);
}

}  // namespace

extern "C" {

// Launches K4 on `stream` for the X-block [x_start, x_start + tile) against
// the Y-slab [y_start, y_start + y_len) and returns the cudaError_t of the
// launches (0 on success).  Arguments as fw_mi_univar_stats
// (mi_univar_stats.cu), plus ld, the row stride of the four (tile, y_len)
// outputs, and `slab`, room for (L-1)^2 * blocks * 2048 int32 counts,
// blocks = ceil(tile / 32) * ceil(y_len / 64).  dataT must be 16-byte
// aligned, with values in 0..L-1 and n < 2^24.
int fw_mi_univar_stats_planes(const void* dataT, int n, int p, int x_start,
                              int tile, int y_start, int y_len, int ld,
                              const void* marg, const void* levels,
                              const void* max_vals, int L, int nz, double hps,
                              double n_obs_min, void* stat, void* df,
                              void* nobs, void* suff, void* slab,
                              void* stream) {
  if (L < 2 || L >= MAX_L || n <= 0 || n >= (1 << 24) || tile <= 0 ||
      y_len <= 0 || ld < y_len || slab == nullptr ||
      (reinterpret_cast<uintptr_t>(dataT) & 15))
    return (int)cudaErrorInvalidValue;
  const Block B{static_cast<const int8_t*>(dataT), n, p, L, nz, x_start, tile,
                y_start, y_len, ld, static_cast<const int*>(marg),
                static_cast<const int*>(levels),
                static_cast<const int*>(max_vals), hps, n_obs_min,
                static_cast<double*>(stat), static_cast<int*>(df),
                static_cast<int*>(nobs), static_cast<bool*>(suff)};
  const int blocks = ((tile + BX - 1) / BX) * ((y_len + BY - 1) / BY);
  const int a_groups = (L - 1 + G - 1) / G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* counts = static_cast<int*>(slab);
  mi_univar_stats_planes_count_kernel<<<dim3(blocks, a_groups), THREADS,
                                        fw_pipe::RING_BYTES, s>>>(B, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mi_univar_stats_planes_epilogue_kernel<<<blocks * (PAIRS / EPI_THREADS),
                                           EPI_THREADS, 0, s>>>(
      B, counts, (size_t)blocks * PAIRS);
  return (int)cudaGetLastError();
}

}  // extern "C"
