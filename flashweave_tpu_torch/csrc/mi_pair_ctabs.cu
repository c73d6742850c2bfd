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
// 3.35 TB/s, and reading the table 21.5 MB.  Both grow with L^2.
//
// What the design does about it: the tile loop of int8_indicator_mma.cuh
// (indicators of all L levels formed in shared memory while loading the
// mma fragments, int32 counts in registers), and each count goes from its
// accumulator register straight to its plane, with no epilogue.  The TPU's
// L * L separate dots per grid cell become one (L * bx x n) . (n x L * by)
// product per tile; its pad value -1 is the staging pad here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_indicator_mma.cuh"

namespace {

__global__ void __launch_bounds__(fw_mma::THREADS, 1)
mi_pair_ctabs_kernel(const int8_t* __restrict__ dataT, int n, int x_start,
                     int tile, int y_start, int y_len, int L, int bx, int by,
                     int* __restrict__ planes) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sx = smem;
  uint8_t* sy = smem + bx * fw_mma::STRIDE;
  const int nty = (y_len + by - 1) / by;
  const int tx = blockIdx.x / nty, ty = blockIdx.x % nty;
  const int xt = tx * bx, yt = ty * by;   // tile origin inside the block
  fw_mma::Tile t{dataT, n, x_start + xt, min(bx, tile - xt),
                 y_start + yt, min(by, y_len - yt), bx, by};
  const size_t plane = (size_t)tile * y_len;
  fw_mma::tile_counts(t, L, L, 0, sx, sy, [&](int row, int col, int v) {
    const int a = row / bx, x = row % bx, b = col / by, y = col % by;
    if (x < t.nx && y < t.ny)
      planes[(a * L + b) * plane + (size_t)(xt + x) * y_len + yt + y] = v;
  });
}

}  // namespace

extern "C" {

// Launches K3 on `stream` and returns the cudaError_t of the launch (0 on
// success).  dataT: (p, n) int8 contiguous with values in 0..L-1; planes:
// (L * L, tile, y_len) int32 row-major; bx x by is the pair tile of a block
// (bx % 16 == 0, by % 8 == 0, both <= 128).
int fw_mi_pair_ctabs(const void* dataT, int n, int x_start, int tile,
                     int y_start, int y_len, int L, int bx, int by,
                     void* planes, void* stream) {
  if (L < 2 || L > 127 || bx % 16 || by % 8 || bx <= 0 || by <= 0 ||
      bx > fw_mma::MAX_TILE || by > fw_mma::MAX_TILE)
    return (int)cudaErrorInvalidValue;
  const int smem = fw_mma::staging_bytes(bx, by);
  cudaError_t err = cudaFuncSetAttribute(
      mi_pair_ctabs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = ((tile + bx - 1) / bx) * ((y_len + by - 1) / by);
  mi_pair_ctabs_kernel<<<blocks, fw_mma::THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(dataT), n, x_start, tile, y_start, y_len, L,
      bx, by, static_cast<int*>(planes));
  return (int)cudaGetLastError();
}

}  // extern "C"
