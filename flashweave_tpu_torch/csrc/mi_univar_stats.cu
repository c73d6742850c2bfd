// Fused univariate mi / mi_nz G-test of an X-block against a Y-slab, for
// tables of L = 2..4 levels.
//
// Replaces the TPU kernel flashweave_tpu/ops/pallas_kernels.py:478
// `mi_univar_stats_pallas` (bodies `_make_mi_stats_kernel_dbuf`,
// `_make_mi_stats_kernel`, epilogue `_mi_epilogue`).  Same function: for
// every pair (X, Y) it counts only the (L-1)^2 joint counts of levels >= 1,
// rebuilds row 0, column 0 and the corner from the per-variable level
// marginals and the true row count n, applies nz slicing (0 plain, 1
// per-variable offset from max_vals, 2 all-3-level uniform), and writes the
// signed MI, the adjusted df, n_obs and the pre/post power check.  Nothing
// but those four per-pair values reaches device memory: as on the TPU, the
// counts never leave the SM.
//
// What bounds it on this card: at the 3-level slice's block (n = 2048,
// X-block 512 against a 10,000-wide Y-slab) the data-sheet bound is the
// four joint-count planes as int8 tensor-core products, 2 * 4 * 2048 *
// 5.12e6 = 8.4e10 ops, 0.042 ms at 1,979 TOPS; at L = 2 it is the bytes,
// the outputs' 17 B a pair (87 MB) and the table (21.5 MB), 0.032 ms at
// 3.35 TB/s.  Below both, forming the level indicators costs integer
// instructions in step with the mma (K3's loop), and the epilogue's float64
// logs, up to L^2 a pair, run on the FP64 units.  On an H100 80GB HBM3 at
// 700 W (chip_smoke.py phase 2, PERF.md section 6) a sweep of the loop at
// that block takes about the same time whatever the number of products in
// it (1 at L = 2 to 9 at L = 4), so the loop's fixed work -- staging, the
// fragment words' loads and funnel shifts, the barriers -- sets K1's time,
// and the epilogue adds what the other block's loop does not hide.
//
// What the design does about it:
// - the counts run on the pipelined loop of int8_indicator_pipe.cuh from
//   level 1 with a group width of L - 1 (level_products<1, L - 1>): one
//   sweep over the samples yields every joint count of a pair, and each
//   raw word becomes exactly the L - 1 indicators a side that are counted
//   (one at L = 2, where the default width of 3 would form three);
// - after the sweep the ring is idle, and each warp writes its 16 x 16
//   pairs' counts into it (int2 stores, rows of 72 ints, free of bank
//   conflicts), so the accumulators are dead before the float64 epilogue
//   starts: at L = 4 the 72 accumulators and the epilogue's registers would
//   not fit the loop's 128 together;
// - then every thread runs the float64 epilogue for 8 of the block tile's
//   2048 pairs, one at a time in a loop (one copy of its code), pair
//   thread + 256 s in row-major order, so that a warp's stores of each
//   output cover 32 neighbouring pairs of one row;
// - two blocks an SM, so one block's epilogue overlaps the other's loop;
// - the epilogue is unchanged in arithmetic and order, so the card's
//   decisions equal the float64 CPU path's.
// K4 (mi_univar_stats_planes.cu) serves the same function at L = 5..127,
// where a pair's counts no longer come out of one sweep.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_indicator_pipe.cuh"
#include "smem_limit.cuh"

namespace {

using fw_pipe::BX;
using fw_pipe::BY;
using fw_pipe::THREADS;
using fw_pipe::WXN;

constexpr int MAX_L = 4;                 // levels 1..L-1 in one sweep
constexpr int PAIRS = BX * BY;           // pairs of a block tile (2048)
constexpr int RS = BY + 8;               // ints a block-tile row of the count store
constexpr int CSTRIDE = BX * RS;         // ints a level pair of the count store
constexpr int MAX_STORE_BYTES = (MAX_L - 1) * (MAX_L - 1) * CSTRIDE * 4;
static_assert(2 * MAX_STORE_BYTES <= 227 * 1024,
              "two blocks an SM with the largest count store");

// Dynamic shared memory of K1 at L levels: the ring, later the count store.
template <int L>
constexpr int smem_bytes() {
  return (L - 1) * (L - 1) * CSTRIDE * 4 > fw_pipe::RING_BYTES
             ? (L - 1) * (L - 1) * CSTRIDE * 4
             : fw_pipe::RING_BYTES;
}

// An X-block [x_start, x_start + tile) against a Y-slab [y_start, y_start +
// y_len) and its (tile, y_len) row-major outputs.
struct Block {
  const int8_t* dataT;   // (p, n) int8, contiguous, 16-byte aligned
  int n, p, nz;
  int x_start, tile, y_start, y_len;
  const int* marg;       // (L, p) level marginals
  const int* levels;     // (p,)
  const int* max_vals;   // (p,)
  double hps, n_obs_min;
  double* stat;
  int* df;
  int* nobs;
  bool* suff;
};

// G-test epilogue for one pair in float64 (semantics of
// ops.univariate.mi_block_stats and ops.statfuns.mi_stats, reference
// src/statfuns.jl:163-323 + src/tests.jl:28-103).
template <int L>
__device__ __forceinline__ void epilogue(
    const int (&joint)[L - 1][L - 1], const int* __restrict__ marg, int p,
    int gx, int gy, int lx_i, int ly_i, int mvx, int mvy, int n_rows, int nz,
    double hps, double n_obs_min, double* stat, int* df_out, int* nobs_out,
    bool* suff_out) {
  int cnt[L][L];
  int sum_mx = 0, sum_my = 0, sum_joint = 0;
#pragma unroll
  for (int a = 1; a < L; ++a) {
    int row = 0;
#pragma unroll
    for (int b = 1; b < L; ++b) {
      cnt[a][b] = joint[a - 1][b - 1];
      row += cnt[a][b];
    }
    const int mx = marg[a * p + gx];
    cnt[a][0] = mx - row;
    sum_mx += mx;
    sum_joint += row;
  }
#pragma unroll
  for (int b = 1; b < L; ++b) {
    int col = 0;
#pragma unroll
    for (int a = 1; a < L; ++a) col += cnt[a][b];
    const int my = marg[b * p + gy];
    cnt[0][b] = my - col;
    sum_my += my;
  }
  cnt[0][0] = n_rows - sum_mx - sum_my + sum_joint;

  // nz offsets: 2 (uniform) means every variable has 3 levels, so both are 1
  const int ox = nz == 2 ? 1 : (nz ? (mvx > 1) : 0);
  const int oy = nz == 2 ? 1 : (nz ? (mvy > 1) : 0);

  double sub[L][L];
  double row[L], col[L];
  double n_view = 0.0;
#pragma unroll
  for (int a = 0; a < L; ++a) {
    row[a] = 0.0;
    col[a] = 0.0;
  }
#pragma unroll
  for (int a = 0; a < L; ++a) {
#pragma unroll
    for (int b = 0; b < L; ++b) {
      const double c = (double)cnt[a][b];
      if (a >= ox) n_view += c;      // X-trimmed view of the pre-check
      sub[a][b] = (a >= ox && b >= oy) ? c : 0.0;
      row[a] += sub[a][b];
    }
  }
  double n_obs = 0.0;
#pragma unroll
  for (int a = 0; a < L; ++a) {
    n_obs += row[a];
#pragma unroll
    for (int b = 0; b < L; ++b) col[b] += sub[a][b];
  }

  double mi_pos = 0.0, mi_neg = 0.0, n_pos = 0.0;
#pragma unroll
  for (int a = 0; a < L; ++a) {
#pragma unroll
    for (int b = 0; b < L; ++b) {
      const double s = sub[a][b];
      double term = 0.0;
      if (s != 0.0 && row[a] != 0.0 && col[b] != 0.0)
        term = log((n_obs * s) / (row[a] * col[b])) * s;
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
  int alx = 0, aly = 0;
#pragma unroll
  for (int a = 0; a < L; ++a) {
    alx += row[a] != 0.0;
    aly += col[a] != 0.0;
  }
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
  *nobs_out = (int)n_obs;
  *suff_out = suff;
}

// Epilogue of the tile loop's one sweep (levels 1..L-1 a side): every
// warp's counts go to the count store in the idle ring,
// store[((a-1) K + (b-1)) CSTRIDE + r RS + c] for row r and column c of the
// block tile; then every thread runs the G-test of pairs thread + 256 s of
// the tile from there.
template <int L>
struct TileGTest {
  const Block& B;
  int xt, yt;   // the block tile's origin inside the block
  int* store;

  __device__ __forceinline__ void operator()(
      int, int, int, int, const int (&acc)[L - 1][L - 1][2][4]) const {
    constexpr int K = L - 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int r0 = 16 * (warp % WXN) + (lane >> 2);
    const int c0 = 16 * (warp / WXN) + 2 * (lane & 3);
    __syncthreads();   // every warp has read the ring's last chunk
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int b = 0; b < K; ++b)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(store + (a * K + b) * CSTRIDE +
                                     (r0 + 8 * h) * RS + c0 + 8 * j) =
                make_int2(acc[a][b][j][2 * h] >> 7,
                          acc[a][b][j][2 * h + 1] >> 7);
    __syncthreads();
#pragma unroll 1
    for (int i = threadIdx.x; i < PAIRS; i += THREADS) {
      const int r = i / BY, c = i % BY;
      const int x = xt + r, y = yt + c;
      if (x >= B.tile || y >= B.y_len) continue;
      int joint[K][K];
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int b = 0; b < K; ++b)
          joint[a][b] = store[(a * K + b) * CSTRIDE + r * RS + c];
      const int gx = B.x_start + x, gy = B.y_start + y;
      const size_t o = (size_t)x * B.y_len + y;
      epilogue<L>(joint, B.marg, B.p, gx, gy, B.levels[gx], B.levels[gy],
                  B.max_vals[gx], B.max_vals[gy], B.n, B.nz, B.hps,
                  B.n_obs_min, B.stat + o, B.df + o, B.nobs + o, B.suff + o);
    }
  }
};

// One block a 32 x 64 block tile of the block (X tiles vary fastest, as in
// K3 and K4): its joint counts in one sweep, then its G-tests.
template <int L>
__global__ void __launch_bounds__(THREADS, 2)
mi_univar_stats_kernel(const Block B) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ntx = (B.tile + BX - 1) / BX;
  const int xt = (blockIdx.x % ntx) * BX, yt = (blockIdx.x / ntx) * BY;
  const fw_pipe::Tile t{B.dataT, B.n, (size_t)B.p * B.n, B.x_start + xt,
                        min(BX, B.tile - xt), B.y_start + yt,
                        min(BY, B.y_len - yt)};
  TileGTest<L> epi{B, xt, yt, reinterpret_cast<int*>(smem)};
  fw_pipe::level_products<1, L - 1>(t, L, 1, L, smem, epi);
}

template <int L>
cudaError_t launch(const Block& B, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<L>();
  static bool raised[fw_smem::kMaxDevices] = {};
  const cudaError_t attr =
      fw_smem::raise_limit_once(mi_univar_stats_kernel<L>, bytes, raised);
  if (attr != cudaSuccess) return attr;
  const int blocks = ((B.tile + BX - 1) / BX) * ((B.y_len + BY - 1) / BY);
  mi_univar_stats_kernel<L><<<blocks, THREADS, bytes, stream>>>(B);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches K1 on `stream` and returns the cudaError_t of the launch (0 on
// success).  dataT: (p, n) int8 contiguous, 16-byte aligned, values in
// 0..L-1, n < 2^24; marg: (L, p) int32; levels / max_vals: (p,) int32;
// outputs (tile, y_len) row-major; L = 2..4.
int fw_mi_univar_stats(const void* dataT, int n, int p, int x_start, int tile,
                       int y_start, int y_len, const void* marg,
                       const void* levels, const void* max_vals, int L, int nz,
                       double hps, double n_obs_min, void* stat, void* df,
                       void* nobs, void* suff, void* stream) {
  if (L < 2 || L > MAX_L || n <= 0 || n >= (1 << 24) || tile <= 0 ||
      y_len <= 0 || (reinterpret_cast<uintptr_t>(dataT) & 15))
    return (int)cudaErrorInvalidValue;
  const Block B{static_cast<const int8_t*>(dataT), n, p, nz, x_start, tile,
                y_start, y_len, static_cast<const int*>(marg),
                static_cast<const int*>(levels),
                static_cast<const int*>(max_vals), hps, n_obs_min,
                static_cast<double*>(stat), static_cast<int*>(df),
                static_cast<int*>(nobs), static_cast<bool*>(suff)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 2:
      return (int)launch<2>(B, s);
    case 3:
      return (int)launch<3>(B, s);
    default:
      return (int)launch<4>(B, s);
  }
}

const char* fw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
