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
// What bounds it on this card: FP64 tensor-core arithmetic.  The five sums
// are five products over the samples (m = value != 0):
//   Sx = x . m_y, Sxx = x^2 . m_y, Sy = m_x . y, Syy = m_x . y^2, Sxy = x . y,
// and N = m_x . m_y, so one block of the slice (n = 2048, X-block 512
// against a 10,000-wide Y-slab) is 5 * 2 * 2048 * 5.12e6 = 1.05e11 FP64
// flop, 1.6 ms at the H100 SXM's 67 TFLOP/s FP64 tensor-core rate.  Its
// traffic is (512 + 10,000) * 2048 * 8 B = 172 MB read and 5.12e6 * 12 B =
// 61 MB written, 0.07 ms at 3.35 TB/s.  float64 because the card's
// univariate decisions must equal the CPU float64 path's: in f32 the
// cancellation Sxy - Sx*Sy/N loses most digits of a near-zero correlation.
//
// What the design does about it:
// - the five sums run on the FP64 tensor cores as
//   mma.sync.aligned.m16n8k4.row.col.f64 (sm_90; wgmma has no f64 form).
//   A warp owns a 16 x 16 pair tile: two m16n8 fragments, five sums each,
//   40 float64 accumulators a lane.  Each k-step loads the x and x^2
//   fragments (2 doubles each) and, per n8 half, the y and y^2 fragments
//   (1 double each) from shared memory, and forms the 0/1 masks from bit
//   masks on the integer pipe: scalar FP64 instructions (a square, a
//   compare) issue on the same FP64 pipe as the mma, so the loop has none;
// - once a stage has landed, the block squares each value once and packs
//   each variable's nonzero samples into a 32-bit mask; N is then exact
//   integer work off the tensor cores, the popcount of the AND of two
//   masks (a sixth FP64 product would cost a sixth more mma and 16
//   registers);
// - one block (16 warps, 4 x 4) owns a 64 x 64 pair tile and loops over all
//   n samples in 32-sample chunks (the TPU's sequential k grid axis and its
//   k == 0 accumulators become this loop; no reduction across blocks).
//   Chunks are read along p, coalesced, from the (n, p) layout with
//   cp.async into a 2-stage ring (values and squares, 137 KB), so chunk k+1
//   lands while chunk k multiplies.  One block an SM, 128 registers a
//   thread: the 16 warps of two 8-warp blocks, but a 64 x 64 tile reads a
//   third less from L2 than 64 x 32, and its conversion splits evenly (one
//   task a thread).  Measured on the card, this beat two 64 x 32 blocks an
//   SM, a 3-stage ring that converts one chunk ahead with one barrier a
//   chunk, 16 x 32 warp tiles at 254 registers and m16n8k8 (which spills);
// - a pair of neighbouring doubles moves as one 16-byte copy when its
//   source is 16-byte aligned, else as two 8-byte copies (p, x_start and
//   y_start may be odd); samples past n and variables past the tile stage
//   as 0 through the copies' zero fill (nothing is read there), which the
//   nonzero mask drops;
// - shared rows are padded to 68 doubles (4 mod 16), so the eight rows
//   and four k columns of a fragment load hit distinct banks;
// - built without --use_fast_math: IEEE division and sqrt carry the NaN and
//   inf rules of the epilogue.
// Precision: the sums are fused multiply-adds in the tensor cores' order, as
// in the plain version's cuBLAS products, so the two agree to rounding, not
// bit for bit; on data whose sums are exact (multiples of a power of two,
// small enough) both are exact, so an exact copy gives r == 1 and a negated
// copy r == -1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int WX = 4;             // warps along X
constexpr int WY = 4;             // warps along Y
constexpr int BX = WX * 16;       // X variables per block (64)
constexpr int BY = WY * 16;       // Y variables per block (64)
constexpr int BK = 32;            // samples per stage
constexpr int STAGES = 2;
constexpr int SX = BX + 4;        // padded row strides in doubles (4 mod 16)
constexpr int SY = BY + 4;
// a stage: the X and Y values of BK samples, then their squares
constexpr int PLANES = BK * (SX + SY);
constexpr int STAGE_DOUBLES = 2 * PLANES;
// the ring, then one nonzero bit mask a variable of the current chunk
// (139,776 bytes: one block an SM)
constexpr int SMEM_BYTES = STAGES * STAGE_DOUBLES * 8 + (BX + BY) * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// 8-byte copy; src_bytes == 0 reads nothing and writes zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c (16 x 8) += a (16 x 4) . b (4 x 8).  Lane (g = lane / 4, t = lane % 4):
// a0 = A[g][t], a1 = A[g + 8][t], b = B[t][g];
// c0, c1 = C[g][2t], C[g][2t + 1]; c2, c3 = C[g + 8][2t], C[g + 8][2t + 1].
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Copies columns [j, j + 2) of sample row k of a tile whose first column is
// col0 (valid columns: j < lim) into dst[j], dst[j + 1].
__device__ __forceinline__ void stage_pair(double* dst,
                                           const double* __restrict__ data,
                                           int n, int p, int k, int col0,
                                           int j, int lim, bool base16) {
  const bool row = k < n;
  const bool v0 = row && j < lim, v1 = row && j + 1 < lim;
  const size_t gi = (size_t)k * p + col0 + j;
  if (v0 && v1 && base16 && !(gi & 1)) {
    cp_async16(dst + j, data + gi);
  } else {
    cp_async8(dst + j, v0 ? data + gi : data, v0 ? 8 : 0);
    cp_async8(dst + j + 1, v1 ? data + gi + 1 : data, v1 ? 8 : 0);
  }
}

// Issues the copies of samples [k0, k0 + BK) into one stage of the ring.
__device__ __forceinline__ void load_stage(double* stage,
                                           const double* __restrict__ data,
                                           int n, int p, int k0, int x0,
                                           int xlim, int y0, int ylim,
                                           bool base16) {
  double* sx = stage;
  double* sy = stage + BK * SX;
  constexpr int XP = BK * BX / 2 / THREADS;   // column pairs per thread (2)
  constexpr int YP = BK * BY / 2 / THREADS;   // (2)
#pragma unroll
  for (int q = 0; q < XP; ++q) {
    const int idx = threadIdx.x + q * THREADS;
    const int r = idx / (BX / 2), j = (idx % (BX / 2)) * 2;
    stage_pair(sx + r * SX, data, n, p, k0 + r, x0, j, xlim, base16);
  }
#pragma unroll
  for (int q = 0; q < YP; ++q) {
    const int idx = threadIdx.x + q * THREADS;
    const int r = idx / (BY / 2), j = (idx % (BY / 2)) * 2;
    stage_pair(sy + r * SY, data, n, p, k0 + r, y0, j, ylim, base16);
  }
}

// value != 0 (so NaN counts, -0.0 does not), on the integer pipe
__device__ __forceinline__ bool nonzero(double d) {
  return ((static_cast<uint32_t>(__double2hiint(d)) << 1) |
          static_cast<uint32_t>(__double2loint(d))) != 0u;
}

// 1.0 where bit k of w is set, else 0.0, on the integer pipe
__device__ __forceinline__ double bit_double(uint32_t w, int k) {
  return __hiloint2double(((w >> k) & 1u) ? 0x3ff00000 : 0, 0);
}

// Writes the squares of a landed stage into its square planes, and the
// chunk's nonzero bit masks: bit k of masks[v] is set where sample k of
// block-tile variable v (X first, then Y) is nonzero.  A task is 8 samples
// of one variable, whose bits are byte k / 8 of masks[v]; neighbouring
// lanes take neighbouring variables of a row, so the loads do not conflict.
__device__ __forceinline__ void convert_stage(double* stage, uint32_t* masks) {
  constexpr int GROUPS = BK / 8;
  static_assert(BK == 32, "one 32-bit mask a variable and chunk");
  uint8_t* mbytes = reinterpret_cast<uint8_t*>(masks);
  for (int task = threadIdx.x; task < (BX + BY) * GROUPS; task += THREADS) {
    const int v = task % (BX + BY), kg = task / (BX + BY);
    const bool isx = v < BX;
    const int stride = isx ? SX : SY;
    double* val = stage + (isx ? v : BK * SX + v - BX);
    double* sq = val + PLANES;
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const double d = val[(kg * 8 + i) * stride];
      sq[(kg * 8 + i) * stride] = __dmul_rn(d, d);
      bits |= (uint32_t)nonzero(d) << i;
    }
    mbytes[4 * v + kg] = (uint8_t)bits;
  }
}

// N of the lane's eight pairs += joint nonzero samples of one chunk
__device__ __forceinline__ void add_counts(int (&cnt)[2][4],
                                           const uint32_t* masks, int xr,
                                           int yc) {
  const uint32_t mx0 = masks[xr], mx1 = masks[xr + 8];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint32_t my = masks[BX + yc + 8 * j + c];
      cnt[j][c] += __popc(mx0 & my);
      cnt[j][2 + c] += __popc(mx1 & my);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
fz_nz_stats_kernel(const double* __restrict__ data, int n, int p, int x_start,
                   int tile, int y_start, int y_len, double* __restrict__ r_out,
                   int* __restrict__ n_out) {
  extern __shared__ __align__(16) double smem[];
  const int ntx = (tile + BX - 1) / BX;
  const int bx0 = (blockIdx.x % ntx) * BX;   // first X of the block's tile
  const int by0 = (blockIdx.x / ntx) * BY;   // first Y of the block's tile
  const int xlim = min(BX, tile - bx0), ylim = min(BY, y_len - by0);
  const bool base16 = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  const int x0 = x_start + bx0, y0 = y_start + by0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wx = warp % WX, wy = warp / WX;

  uint32_t* masks = reinterpret_cast<uint32_t*>(smem + STAGES * STAGE_DOUBLES);
  const int xr = wx * 16 + g;              // the lane's A-fragment rows
  const int yc = wy * 16 + 2 * t;          // the lane's first C column

  // accumulators [n8 half][fragment element]
  double s_x[2][4], s_xx[2][4], s_y[2][4], s_yy[2][4], s_xy[2][4];
  int cnt[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s_x[j][e] = s_xx[j][e] = s_y[j][e] = s_yy[j][e] = s_xy[j][e] = 0.0;
      cnt[j][e] = 0;
    }

  const int chunks = (n + BK - 1) / BK;
  load_stage(smem, data, n, p, 0, x0, xlim, y0, ylim, base16);
  cp_async_commit();
  for (int kc = 0; kc < chunks; ++kc) {
    cp_async_wait<0>();            // chunk kc has landed
    __syncthreads();               // ... for every thread; chunk kc-1 is read
    if (kc + 1 < chunks)           // chunk kc+1 lands while kc multiplies
      load_stage(smem + ((kc + 1) % STAGES) * STAGE_DOUBLES, data, n, p,
                 (kc + 1) * BK, x0, xlim, y0, ylim, base16);
    cp_async_commit();
    double* stage = smem + (kc % STAGES) * STAGE_DOUBLES;
    convert_stage(stage, masks);
    __syncthreads();               // squares and masks of chunk kc are written

    add_counts(cnt, masks, xr, yc);
    const uint32_t ma0 = masks[xr], ma1 = masks[xr + 8];
    const uint32_t mb0 = masks[BX + wy * 16 + g], mb1 = masks[BX + wy * 16 + 8 + g];
    const double* sx = stage;
    const double* sy = stage + BK * SX;
    const double* qx = sx + PLANES;
    const double* qy = sy + PLANES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const int k = kk + t;
      const double a0 = sx[k * SX + xr], a1 = sx[k * SX + xr + 8];
      const double q0 = qx[k * SX + xr], q1 = qx[k * SX + xr + 8];
      const double m0 = bit_double(ma0, k), m1 = bit_double(ma1, k);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int yb = k * SY + wy * 16 + 8 * j + g;
        const double b = sy[yb], bq = qy[yb];
        const double bm = bit_double(j ? mb1 : mb0, k);
        dmma(s_x[j], a0, a1, bm);
        dmma(s_xx[j], q0, q1, bm);
        dmma(s_y[j], m0, m1, b);
        dmma(s_yy[j], m0, m1, bq);
        dmma(s_xy[j], a0, a1, b);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue (semantics of flashweave_tpu/ops/univariate.py:86-97)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int xi = bx0 + wx * 16 + g + 8 * (e >> 1);
      const int yj = by0 + wy * 16 + 8 * j + 2 * t + (e & 1);
      if (xi < tile && yj < y_len) {
        const int N = cnt[j][e];
        const double safe_n = N > 0 ? (double)N : 1.0;
        const double Sx = s_x[j][e], Sy = s_y[j][e];
        const double cov = __dsub_rn(s_xy[j][e], __ddiv_rn(__dmul_rn(Sx, Sy), safe_n));
        const double varx = __dsub_rn(s_xx[j][e], __ddiv_rn(__dmul_rn(Sx, Sx), safe_n));
        const double vary = __dsub_rn(s_yy[j][e], __ddiv_rn(__dmul_rn(Sy, Sy), safe_n));
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
  static cudaError_t attr = cudaFuncSetAttribute(
      fz_nz_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = ((tile + BX - 1) / BX) * ((y_len + BY - 1) / BY);
  fz_nz_stats_kernel<<<blocks, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(data), n, p, x_start, tile, y_start, y_len,
      static_cast<double*>(r), static_cast<int*>(nobs));
  return (int)cudaGetLastError();
}

}  // extern "C"
