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
// the pre/post power checks.  Only those four per-pair values reach device
// memory.
//
// What bounds it on this card: int8 tensor-core operations.  One block of
// the 3-level slice (n = 2048, X-block 512 against a 10,000-wide Y-slab) is
// 2 * 4 * 2048 * 5.12e6 = 8.4e10 int8 ops, 0.042 ms at 1,979 TOPS; its
// traffic is 21.5 MB read and 87 MB written, 0.032 ms at 3.35 TB/s.  The
// count grows with (L-1)^2: 12 levels are 30x the work of 3.
//
// What the design does about it:
// - the tile loop of int8_indicator_mma.cuh forms the indicators in shared
//   memory while loading the mma fragments, so the TPU's K-fold indicator
//   planes in HBM never exist;
// - the (K * bx) x (K * by) int32 counts of one pair tile go to shared
//   memory, and the wrapper picks bx, by from L so they fit (bx = by =
//   128 / K rounded to 16, down to 16 x 8, i.e. up to L = 21).  Past that
//   even a 16 x 8 tile's counts exceed shared memory (8 MB at L = 127), so
//   they go to a slice of a scratch buffer that the wrapper allocates per
//   block, and the blocks walk the tiles persistently;
// - the epilogue is K1's in float64, written for a runtime L (one thread a
//   pair, the counts read back from the store), with the same summation
//   order, so the card's decisions equal the float64 CPU path's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_indicator_mma.cuh"

namespace {

constexpr int MAX_L = 128;

// G-test epilogue for one pair in float64 (semantics of
// ops.univariate.mi_block_stats; the arithmetic and order of K1's epilogue
// in mi_univar_stats.cu).  jc(a, b) is the joint count of levels a, b >= 1,
// read from `store` at row (a - 1) * bx + x, column (b - 1) * by + y.
__device__ void epilogue(const int* store, int ld, int bx, int by, int x,
                         int y, int L, const int* __restrict__ marg, int p,
                         int gx, int gy, int lx_i, int ly_i, int mvx, int mvy,
                         int n_rows, int nz, double hps, double n_obs_min,
                         double* stat, int* df_out, int* nobs_out,
                         bool* suff_out) {
  const int K = L - 1;
  const int* jrow = store + (size_t)x * ld + y;
  auto jc = [&](int a, int b) {
    return jrow[(size_t)(a - 1) * bx * ld + (b - 1) * by];
  };
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

__global__ void __launch_bounds__(fw_mma::THREADS, 1)
mi_univar_stats_planes_kernel(const int8_t* __restrict__ dataT, int n, int p,
                              int x_start, int tile, int y_start, int y_len,
                              const int* __restrict__ marg,
                              const int* __restrict__ levels,
                              const int* __restrict__ max_vals, int L, int nz,
                              double hps, double n_obs_min, int bx, int by,
                              int* __restrict__ scratch,
                              double* __restrict__ stat, int* __restrict__ df,
                              int* __restrict__ nobs, bool* __restrict__ suff) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int K = L - 1;
  uint8_t* sx = smem;
  uint8_t* sy = smem + bx * fw_mma::STRIDE;
  const int ld = K * by;                    // row stride of the count store
  int* store = scratch != nullptr
                   ? scratch + (size_t)blockIdx.x * K * K * bx * by
                   : reinterpret_cast<int*>(smem + fw_mma::staging_bytes(bx, by));
  const int ntx = (tile + bx - 1) / bx, nty = (y_len + by - 1) / by;
  for (int tt = blockIdx.x; tt < ntx * nty; tt += gridDim.x) {
    // neighbouring blocks share an X tile and walk along the Y-slab
    const int tx = tt / nty, ty = tt % nty;
    fw_mma::Tile t{dataT, n, x_start + tx * bx, min(bx, tile - tx * bx),
                   y_start + ty * by, min(by, y_len - ty * by), bx, by};
    fw_mma::tile_counts(t, K, K, 1, sx, sy, [&](int row, int col, int v) {
      store[(size_t)row * ld + col] = v;
    });
    for (int pr = threadIdx.x; pr < bx * by; pr += fw_mma::THREADS) {
      const int x = pr / by, y = pr % by;
      if (x < t.nx && y < t.ny) {
        const int gx = t.x0 + x, gy = t.y0 + y;
        const size_t o = (size_t)(tx * bx + x) * y_len + ty * by + y;
        epilogue(store, ld, bx, by, x, y, L, marg, p, gx, gy, levels[gx],
                 levels[gy], max_vals[gx], max_vals[gy], n, nz, hps,
                 n_obs_min, stat + o, df + o, nobs + o, suff + o);
      }
    }
    __syncthreads();   // the store is read before the next tile overwrites it
  }
}

// Shared memory of one block for a bx x by tile at L levels: the staging
// area, plus the count store unless it lives in scratch.
int smem_bytes(int L, int bx, int by, bool store_in_scratch) {
  const int K = L - 1;
  return fw_mma::staging_bytes(bx, by) +
         (store_in_scratch ? 0 : K * K * bx * by * (int)sizeof(int));
}

}  // namespace

extern "C" {

// Launches K4 on `stream` and returns the cudaError_t of the launch (0 on
// success).  Arguments as fw_mi_univar_stats (mi_univar_stats.cu), plus the
// pair tile bx x by (bx % 16 == 0, by % 8 == 0, both <= 128), the number of
// blocks, and `scratch`: null to keep the counts in shared memory, else
// n_blocks * (L-1)^2 * bx * by int32 of device memory.
int fw_mi_univar_stats_planes(const void* dataT, int n, int p, int x_start,
                              int tile, int y_start, int y_len,
                              const void* marg, const void* levels,
                              const void* max_vals, int L, int nz, double hps,
                              double n_obs_min, void* stat, void* df,
                              void* nobs, void* suff, int bx, int by,
                              void* scratch, int n_blocks, void* stream) {
  if (L < 2 || L >= MAX_L || bx % 16 || by % 8 || bx <= 0 || by <= 0 ||
      bx > fw_mma::MAX_TILE || by > fw_mma::MAX_TILE || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(L, bx, by, scratch != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      mi_univar_stats_planes_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mi_univar_stats_planes_kernel<<<n_blocks, fw_mma::THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dataT), n, p, x_start, tile, y_start, y_len,
      static_cast<const int*>(marg), static_cast<const int*>(levels),
      static_cast<const int*>(max_vals), L, nz, hps, n_obs_min, bx, by,
      static_cast<int*>(scratch), static_cast<double*>(stat),
      static_cast<int*>(df), static_cast<int*>(nobs),
      static_cast<bool*>(suff));
  return (int)cudaGetLastError();
}

}  // extern "C"
