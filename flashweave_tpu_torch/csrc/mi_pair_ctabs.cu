// Contingency planes of an X-block against a Y-slab: for every pair (X, Y)
// and every level pair (a, b), the number of samples with X == a and Y == b.
//
// Replaces the TPU kernel flashweave_tpu/ops/pallas_kernels.py:163
// `mi_pair_ctabs` (body `_make_ctab_kernel`), reached through
// `pair_ctab_planes_pallas` :193 and `pair_ctab_block_pallas` :695.  Same
// function and layout: (L * L, tile, y_len) int32, plane a * L + b.  Its
// consumer is ops/univariate.py:mi_planes_stats (the "planes" block route of
// the univariate pass).
//
// What bounds it on this card: at the 3-level slice's block (n = 2048,
// X-block 512 against a 10,000-wide Y-slab) the nine count planes are
// 2 * 9 * 2048 * 5.12e6 = 1.9e11 int8 tensor-core ops, 0.095 ms at
// 1,979 TOPS; writing them is 4 * 9 * 5.12e6 = 184 MB, 0.055 ms at
// 3.35 TB/s, and reading the table 21.5 MB.  Both grow with L^2.  Below
// those, forming the indicators costs integer instructions in step with the
// mma: about three per indicator word, L of them per raw word and side.
//
// What the design does about it: the pipelined loop of
// int8_indicator_pipe.cuh (a 3-stage cp.async ring of aligned windows for
// any n, each warp owning all level products of a 16 x 16 pair sub-tile so
// every warp works at every L, each raw word loaded once per sweep and
// turned into its indicators in registers, two blocks an SM).  The
// epilogue passes each warp's 16 x 16 counts of a level pair through a
// warp-private shared buffer, so a plane is written in 16-byte stores of
// four neighbouring pairs (scalar stores when y_len % 4 != 0).  The TPU's
// L * L separate dots per grid cell become the tile loop's products; its
// pad value -1 is the pad 0x7f here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_indicator_pipe.cuh"

namespace {

constexpr int ESTRIDE = 20;   // ints a row of a warp's epilogue buffer
constexpr int SMEM_BYTES =
    fw_pipe::RING_BYTES + fw_pipe::WARPS * 16 * ESTRIDE * 4;

__global__ void __launch_bounds__(fw_pipe::THREADS, 2)
mi_pair_ctabs_kernel(const int8_t* __restrict__ dataT, int n, int p,
                     int x_start, int tile, int y_start, int y_len, int L,
                     int* __restrict__ planes) {
  extern __shared__ __align__(16) uint8_t smem[];
  using namespace fw_pipe;
  const int ntx = (tile + BX - 1) / BX;
  const int xt = (blockIdx.x % ntx) * BX;   // tile origin inside the block
  const int yt = (blockIdx.x / ntx) * BY;
  const Tile t{dataT, n, (size_t)p * n, x_start + xt, min(BX, tile - xt),
               y_start + yt, min(BY, y_len - yt)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  int* buf = reinterpret_cast<int*>(smem + RING_BYTES) + warp * 16 * ESTRIDE;
  const int wx = xt + 16 * (warp % WXN), wy = yt + 16 * (warp / WXN);
  const size_t plane = (size_t)tile * y_len;
  const bool vec = y_len % 4 == 0;

  auto epi = [&](int a0, int na, int b0, int nb,
                 const int (&acc)[G][G][2][4]) {
#pragma unroll
    for (int a = 0; a < G; ++a)
#pragma unroll
      for (int b = 0; b < G; ++b) {
        if (a >= na || b >= nb) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            buf[(g + 8 * (e >> 1)) * ESTRIDE + 8 * j + 2 * q + (e & 1)] =
                acc[a][b][j][e] >> 7;
        __syncwarp();
        int* out = planes + ((a0 + a) * L + b0 + b) * plane;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = (lane >> 2) + 8 * i, c = 4 * (lane & 3);
          const int x = wx + r, y = wy + c;
          if (x < tile) {
            const int4 v = *reinterpret_cast<const int4*>(buf + r * ESTRIDE + c);
            int* o = out + (size_t)x * y_len + y;
            if (vec && y + 3 < y_len) {
              *reinterpret_cast<int4*>(o) = v;
            } else {
              if (y < y_len) o[0] = v.x;
              if (y + 1 < y_len) o[1] = v.y;
              if (y + 2 < y_len) o[2] = v.z;
              if (y + 3 < y_len) o[3] = v.w;
            }
          }
        }
        __syncwarp();
      }
  };
  level_products<0>(t, L, 0, L, smem, epi);
}

}  // namespace

extern "C" {

// Launches K3 on `stream` and returns the cudaError_t of the launch (0 on
// success).  dataT: (p, n) int8 contiguous, 16-byte aligned, values in
// 0..L-1, n < 2^24; planes: (L * L, tile, y_len) int32 row-major.
int fw_mi_pair_ctabs(const void* dataT, int n, int p, int x_start, int tile,
                     int y_start, int y_len, int L, void* planes,
                     void* stream) {
  if (L < 2 || L > 127 || n <= 0 || n >= (1 << 24) ||
      (reinterpret_cast<uintptr_t>(dataT) & 15))
    return (int)cudaErrorInvalidValue;
  static cudaError_t attr = cudaFuncSetAttribute(
      mi_pair_ctabs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int blocks = ((tile + fw_pipe::BX - 1) / fw_pipe::BX) *
                     ((y_len + fw_pipe::BY - 1) / fw_pipe::BY);
  mi_pair_ctabs_kernel<<<blocks, fw_pipe::THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dataT), n, p, x_start, tile, y_start, y_len,
      L, static_cast<int*>(planes));
  return (int)cudaGetLastError();
}

}  // extern "C"
