// Fused univariate mi / mi_nz G-test of an X-block against a Y-slab.
//
// Replaces the TPU kernel flashweave_tpu/ops/pallas_kernels.py
// `mi_univar_stats_pallas` (bodies `_make_mi_stats_kernel_dbuf`,
// `_make_mi_stats_kernel`, epilogue `_mi_epilogue`).  Same function: for
// every pair (X, Y) it counts only the (L-1)^2 joint counts of levels >= 1,
// rebuilds row 0, column 0 and the corner from the per-variable level
// marginals and the true row count n, applies nz slicing (0 plain, 1
// per-variable offset from max_vals, 2 all-3-level uniform), and writes the
// signed MI, the adjusted df, n_obs and the pre/post power check.  Nothing
// but those four per-pair values reaches device memory.
//
// What bounds it on the card: integer compare-and-add throughput.  The
// joint counts cost (L-1)^2 compare-and-adds per pair and sample, about
// 4 * n * p^2 / 2 operations for L = 3 over the triangle sweep -- 4e11 at
// n = 2048, p = 10,000.  Reads are small next to that (each staged sample
// byte is reused by 16 * R pairs).
//
// What the design does about it:
// - one block owns a (16R x 16R) output tile and loops over all n samples
//   in 64-sample chunks staged in shared memory (the TPU's sequential grid
//   axis and its k == 0 / k == last accumulators become this loop; no
//   reduction across blocks);
// - each thread owns an R x R micro-tile of pairs with R*R*(L-1)^2 int32
//   counters indexed at compile time, so they live in registers;
// - four samples travel as one 32-bit word: __vcmpeq4 turns a word into a
//   per-byte level mask once per (variable, level), and one AND + popc then
//   counts four samples of one (pair, level pair) -- a 4x cut in counting
//   instructions over a byte-at-a-time loop;
// - the epilogue runs in registers in float64 (cheap on the H100 next to
//   the counting loop), so the card's decisions equal the float64 CPU path.
// The ragged edge is masked while staging: samples past n and variables past
// the block stage as level 0, which no joint counter counts.
// Tensor cores, TMA and bit-plane popcounts are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;              // threads along the Y (column) axis
constexpr int TY = 16;              // threads along the X (row) axis
constexpr int CHUNK = 64;           // samples staged per step
constexpr int STRIDE = CHUNK + 4;   // row stride in bytes: 17 words, no bank conflicts

template <int L>
struct Micro {
  // pairs per thread along each axis: keeps R*R*(L-1)^2 counters <= 64
  static constexpr int R = (L <= 3) ? 4 : ((L <= 5) ? 2 : 1);
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

template <int L>
__global__ void __launch_bounds__(TX * TY)
mi_univar_stats_kernel(const int8_t* __restrict__ dataT, int n, int p,
                       int x_start, int tile, int y_start, int y_len,
                       const int* __restrict__ marg,
                       const int* __restrict__ levels,
                       const int* __restrict__ max_vals, int nz, double hps,
                       double n_obs_min, double* __restrict__ stat,
                       int* __restrict__ df, int* __restrict__ nobs,
                       bool* __restrict__ suff) {
  constexpr int R = Micro<L>::R;
  constexpr int K = L - 1;
  constexpr int BX = TY * R;   // X variables per block
  constexpr int BY = TX * R;   // Y variables per block
  __shared__ __align__(16) uint8_t sx[BX * STRIDE];
  __shared__ __align__(16) uint8_t sy[BY * STRIDE];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bx0 = blockIdx.y * BX;   // first X of the tile owned by this block
  const int by0 = blockIdx.x * BY;   // first Y of the slab owned by this block

  int cnt[R][R][K][K];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int s = 0; s < R; ++s)
#pragma unroll
      for (int a = 0; a < K; ++a)
#pragma unroll
        for (int b = 0; b < K; ++b) cnt[r][s][a][b] = 0;

  for (int k0 = 0; k0 < n; k0 += CHUNK) {
    for (int idx = tid; idx < BX * CHUNK; idx += TX * TY) {
      const int v = idx / CHUNK, c = idx % CHUNK;
      const int xv = bx0 + v, k = k0 + c;
      uint8_t val = 0;
      if (xv < tile && k < n) val = (uint8_t)dataT[(size_t)(x_start + xv) * n + k];
      sx[v * STRIDE + c] = val;
    }
    for (int idx = tid; idx < BY * CHUNK; idx += TX * TY) {
      const int v = idx / CHUNK, c = idx % CHUNK;
      const int yv = by0 + v, k = k0 + c;
      uint8_t val = 0;
      if (yv < y_len && k < n) val = (uint8_t)dataT[(size_t)(y_start + yv) * n + k];
      sy[v * STRIDE + c] = val;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < CHUNK; c += 4) {
      uint32_t xm[R][K], ym[R][K];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(&sx[(ty + TY * r) * STRIDE + c]);
#pragma unroll
        for (int a = 0; a < K; ++a) xm[r][a] = __vcmpeq4(w, 0x01010101u * (uint32_t)(a + 1));
      }
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(&sy[(tx + TX * s) * STRIDE + c]);
#pragma unroll
        for (int b = 0; b < K; ++b) ym[s][b] = __vcmpeq4(w, 0x01010101u * (uint32_t)(b + 1));
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s)
#pragma unroll
          for (int a = 0; a < K; ++a)
#pragma unroll
            for (int b = 0; b < K; ++b) cnt[r][s][a][b] += __popc(xm[r][a] & ym[s][b]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int xi = bx0 + ty + TY * r;
      const int yj = by0 + tx + TX * s;
      if (xi < tile && yj < y_len) {
        int joint[K][K];
#pragma unroll
        for (int a = 0; a < K; ++a)
#pragma unroll
          for (int b = 0; b < K; ++b) joint[a][b] = cnt[r][s][a][b] >> 3;  // 8 bits per matching byte
        const int gx = x_start + xi, gy = y_start + yj;
        const size_t o = (size_t)xi * y_len + yj;
        epilogue<L>(joint, marg, p, gx, gy, levels[gx], levels[gy], max_vals[gx],
                    max_vals[gy], n, nz, hps, n_obs_min, stat + o, df + o, nobs + o,
                    suff + o);
      }
    }
  }
}

template <int L>
cudaError_t launch(const int8_t* dataT, int n, int p, int x_start, int tile,
                   int y_start, int y_len, const int* marg, const int* levels,
                   const int* max_vals, int nz, double hps, double n_obs_min,
                   double* stat, int* df, int* nobs, bool* suff,
                   cudaStream_t stream) {
  constexpr int R = Micro<L>::R;
  const dim3 block(TX, TY);
  const dim3 grid((y_len + TX * R - 1) / (TX * R), (tile + TY * R - 1) / (TY * R));
  mi_univar_stats_kernel<L><<<grid, block, 0, stream>>>(
      dataT, n, p, x_start, tile, y_start, y_len, marg, levels, max_vals, nz,
      hps, n_obs_min, stat, df, nobs, suff);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the cudaError_t of the launch
// (0 on success).  dataT: (p, n) int8 contiguous; marg: (L, p) int32;
// levels / max_vals: (p,) int32; outputs (tile, y_len) row-major.
int fw_mi_univar_stats(const void* dataT, int n, int p, int x_start, int tile,
                       int y_start, int y_len, const void* marg,
                       const void* levels, const void* max_vals, int L, int nz,
                       double hps, double n_obs_min, void* stat, void* df,
                       void* nobs, void* suff, void* stream) {
  const auto* d = static_cast<const int8_t*>(dataT);
  const auto* m = static_cast<const int*>(marg);
  const auto* lv = static_cast<const int*>(levels);
  const auto* mv = static_cast<const int*>(max_vals);
  auto* st = static_cast<double*>(stat);
  auto* dfp = static_cast<int*>(df);
  auto* no = static_cast<int*>(nobs);
  auto* su = static_cast<bool*>(suff);
  auto s = static_cast<cudaStream_t>(stream);
#define FW_CASE(LV)                                                          \
  case LV:                                                                   \
    return (int)launch<LV>(d, n, p, x_start, tile, y_start, y_len, m, lv, mv, \
                           nz, hps, n_obs_min, st, dfp, no, su, s);
  switch (L) {
    FW_CASE(2)
    FW_CASE(3)
    FW_CASE(4)
    FW_CASE(5)
    FW_CASE(6)
    FW_CASE(7)
    FW_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FW_CASE
}

const char* fw_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
