// Masked Pearson correlation (fz_nz univariate pass) of an X-block against a
// Y-slab, moments and r fused in one kernel.
//
// Replaces the TPU kernel flashweave_tpu/ops/pallas_kernels.py:83
// `fz_nz_moments` (body `_moments_kernel` :42), reached through
// `fz_nz_stats_pallas` :110 and `fz_nz_block_pallas` :706.  Same function:
// for every pair (X, Y) the six moments N, Sx, Sy, Sxx, Syy, Sxy over the
// rows where both values are nonzero, then r with the rules of
// flashweave_tpu/ops/univariate.py:86-97 (0/0 gives NaN, which propagates;
// +-inf clamps to +-1; N == 0 gives 0).  The TPU wrote six f32 moment planes
// to HBM and formed r in XLA; here the moments stay in registers and only r
// (float64) and N (int32) reach device memory.
//
// What bounds it on this card: FP64 arithmetic.  Written as six products
// over the samples, one block of the slice (n = 2048, X-block 512 against a
// 10,000-wide Y-slab) is 6 * 2 * 2048 * 5.12e6 = 1.26e11 FP64 flop, about
// 1.9 ms at the H100 SXM's 67 TFLOP/s FP64 tensor-core rate (3.7 ms at
// 34 TFLOP/s outside the tensor cores).  Its traffic is (512 + 10,000) *
// 2048 * 8 B = 172 MB read and 5.12e6 * 12 B = 61 MB written, 0.07 ms at
// 3.35 TB/s.  float64 because the card's univariate decisions must equal
// the CPU float64 path's: in f32 the cancellation Sxy - Sx*Sy/N loses most
// digits of a near-zero correlation.
//
// What the design does about it:
// - one block owns a (64 x 32) pair tile and loops over all n samples in
//   16-sample chunks staged in shared memory (the TPU's sequential k grid
//   axis and its k == 0 accumulators become this loop; no reduction across
//   blocks).  Chunks are read along p, coalesced, from the (n, p) layout,
//   one chunk ahead into registers, so the loads overlap the arithmetic of
//   the chunk before; the squares are formed once while staging;
// - each thread owns a 4 x 2 micro-tile of pairs: five float64 sums and one
//   int32 count per pair in registers, six FP64 instructions per pair and
//   sample (four FMAs against a 0/1 mask, a multiply and an add);
// - Sxy adds the rounded product x*y (no FMA), so an exact copy has
//   Sxy == Sxx bit for bit and r == 1 exactly, as in the plain version;
// - the ragged edges are masked while staging: samples past n and variables
//   past the tile stage as 0, which the nonzero mask drops;
// - built without --use_fast_math: IEEE division and sqrt carry the NaN and
//   inf rules of the epilogue.
// DMMA (mma.sync f64), TMA and an int8 path for N are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;          // threads along the Y (column) axis
constexpr int TY = 16;          // threads along the X (row) axis
constexpr int RX = 4;           // X variables per thread
constexpr int RY = 2;           // Y variables per thread
constexpr int BX = TY * RX;     // X variables per block (64)
constexpr int BY = TX * RY;     // Y variables per block (32)
constexpr int CHUNK = 16;       // samples staged per step
constexpr int XPT = CHUNK * BX / (TX * TY);   // X values staged per thread (4)
constexpr int YPT = CHUNK * BY / (TX * TY);   // Y values staged per thread (2)

// Loads one thread's share of a chunk of V variables (samples k0..k0+CHUNK
// of columns col0..col0+V) into registers; entries past n or past `limit`
// variables load as 0, which the nonzero mask drops.
template <int V, int PER>
__device__ __forceinline__ void load_chunk(double (&out)[PER],
                                           const double* __restrict__ data,
                                           int n, int p, int k0, int col0,
                                           int v0, int limit, int tid) {
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int idx = tid + q * TX * TY;
    const int c = idx / V, v = idx % V;
    const int k = k0 + c;
    out[q] = (k < n && v0 + v < limit)
                 ? __ldg(&data[(size_t)k * p + col0 + v0 + v]) : 0.0;
  }
}

// Stores a loaded share and its squares into the staging buffers.
template <int V, int PER>
__device__ __forceinline__ void stage(const double (&in)[PER],
                                      double (*vals)[V], double (*sq)[V],
                                      int tid) {
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int idx = tid + q * TX * TY;
    vals[idx / V][idx % V] = in[q];
    sq[idx / V][idx % V] = __dmul_rn(in[q], in[q]);
  }
}

__global__ void __launch_bounds__(TX * TY)
fz_nz_stats_kernel(const double* __restrict__ data, int n, int p, int x_start,
                   int tile, int y_start, int y_len, double* __restrict__ r_out,
                   int* __restrict__ n_out) {
  __shared__ double sx[CHUNK][BX];
  __shared__ double sxx[CHUNK][BX];
  __shared__ double sy[CHUNK][BY];
  __shared__ double syy[CHUNK][BY];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int bx0 = blockIdx.y * BX;   // first X of the tile owned by this block
  const int by0 = blockIdx.x * BY;   // first Y of the slab owned by this block

  int cnt[RX][RY];
  double s_x[RX][RY], s_y[RX][RY], s_xx[RX][RY], s_yy[RX][RY], s_xy[RX][RY];
#pragma unroll
  for (int i = 0; i < RX; ++i)
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      cnt[i][j] = 0;
      s_x[i][j] = s_y[i][j] = s_xx[i][j] = s_yy[i][j] = s_xy[i][j] = 0.0;
    }

  // the next chunk's loads are in flight while this chunk is computed
  double px[XPT], py[YPT];
  load_chunk<BX, XPT>(px, data, n, p, 0, x_start, bx0, tile, tid);
  load_chunk<BY, YPT>(py, data, n, p, 0, y_start, by0, y_len, tid);
  for (int k0 = 0; k0 < n; k0 += CHUNK) {
    stage<BX, XPT>(px, sx, sxx, tid);
    stage<BY, YPT>(py, sy, syy, tid);
    __syncthreads();
    if (k0 + CHUNK < n) {
      load_chunk<BX, XPT>(px, data, n, p, k0 + CHUNK, x_start, bx0, tile, tid);
      load_chunk<BY, YPT>(py, data, n, p, k0 + CHUNK, y_start, by0, y_len, tid);
    }
#pragma unroll 4
    for (int c = 0; c < CHUNK; ++c) {
      double xv[RX], x2[RX], mx[RX], yv[RY], y2[RY], my[RY];
      int bxm[RX], bym[RY];
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        xv[i] = sx[c][ty + TY * i];
        x2[i] = sxx[c][ty + TY * i];
        bxm[i] = xv[i] != 0.0;
        mx[i] = bxm[i] ? 1.0 : 0.0;
      }
#pragma unroll
      for (int j = 0; j < RY; ++j) {
        yv[j] = sy[c][tx + TX * j];
        y2[j] = syy[c][tx + TX * j];
        bym[j] = yv[j] != 0.0;
        my[j] = bym[j] ? 1.0 : 0.0;
      }
#pragma unroll
      for (int i = 0; i < RX; ++i)
#pragma unroll
        for (int j = 0; j < RY; ++j) {
          cnt[i][j] += bxm[i] & bym[j];
          s_x[i][j] = fma(xv[i], my[j], s_x[i][j]);
          s_y[i][j] = fma(mx[i], yv[j], s_y[i][j]);
          s_xx[i][j] = fma(x2[i], my[j], s_xx[i][j]);
          s_yy[i][j] = fma(mx[i], y2[j], s_yy[i][j]);
          s_xy[i][j] = __dadd_rn(s_xy[i][j], __dmul_rn(xv[i], yv[j]));
        }
    }
    __syncthreads();
  }

  // epilogue (semantics of flashweave_tpu/ops/univariate.py:86-97)
#pragma unroll
  for (int i = 0; i < RX; ++i) {
#pragma unroll
    for (int j = 0; j < RY; ++j) {
      const int xi = bx0 + ty + TY * i;
      const int yj = by0 + tx + TX * j;
      if (xi < tile && yj < y_len) {
        const int N = cnt[i][j];
        const double safe_n = N > 0 ? (double)N : 1.0;
        const double Sx = s_x[i][j], Sy = s_y[i][j];
        const double cov = __dsub_rn(s_xy[i][j], __ddiv_rn(__dmul_rn(Sx, Sy), safe_n));
        const double varx = __dsub_rn(s_xx[i][j], __ddiv_rn(__dmul_rn(Sx, Sx), safe_n));
        const double vary = __dsub_rn(s_yy[i][j], __ddiv_rn(__dmul_rn(Sy, Sy), safe_n));
        double r = __ddiv_rn(cov, __dsqrt_rn(__dmul_rn(varx, vary)));
        if (r > 1.0) r = 1.0;    // +inf and rounding above 1; NaN stays
        if (r < -1.0) r = -1.0;
        if (N == 0) r = 0.0;
        const size_t o = (size_t)xi * y_len + yj;
        r_out[o] = r;
        n_out[o] = N;
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the cudaError_t of the launch
// (0 on success).  data: (n, p) float64 row-major contiguous; outputs
// r (tile, y_len) float64 and N (tile, y_len) int32, row-major.
int fw_fz_nz_stats(const void* data, int n, int p, int x_start, int tile,
                   int y_start, int y_len, void* r, void* nobs, void* stream) {
  const dim3 block(TX, TY);
  const dim3 grid((y_len + BY - 1) / BY, (tile + BX - 1) / BX);
  fz_nz_stats_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(data), n, p, x_start, tile, y_start, y_len,
      static_cast<double*>(r), static_cast<int*>(nobs));
  return (int)cudaGetLastError();
}

}  // extern "C"
