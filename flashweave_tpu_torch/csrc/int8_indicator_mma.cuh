// Tile loop shared by K3 (mi_pair_ctabs.cu) and K4 (mi_univar_stats_planes.cu):
// joint counts of level indicators as int8 tensor-core products.
//
// One block owns a pair tile of `bx` X variables against `by` Y variables
// (rows of the (p, n) int8 table dataT).  Read as a matrix product, row
// r = ia * bx + x of the left operand is the 0/1 indicator of
// "X_x == level ia + base" over the samples, and column c = ib * by + y of
// the right operand the indicator of "Y_y == level ib + base"; entry (r, c)
// of the product is the number of samples where both hold.  K4 counts the
// levels 1..L-1 (base 1), K3 all levels 0..L-1 (base 0).
//
// The TPU kernels read indicator planes packed in HBM (K4) or formed them
// with f32 compares in VMEM (K3).  Here the raw int8 samples are staged in
// shared memory, 128 samples of every variable of the tile at a time, and
// each thread forms the indicators of its fragment registers while loading
// them: one 32-bit shared load holds four samples, and __vcmpeq4 + AND turns
// them into four 0/1 bytes.  So no K-fold copy of the table is ever written
// and the extra work is two integer instructions per register.  Counts are
// exact int32 sums from mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32.
//
// Work split: the product is cut into 32 x 32 regions (2 m16 x 4 n8
// fragments); each of the 8 warps owns RPW regions per sweep over the
// samples, with their 32 * RPW accumulators in registers.  A product with
// more regions than one sweep covers takes several sweeps, each re-staging
// the tile's samples (they stay in L2).  Samples past n and variables past
// the tile's valid range stage as -1, which matches no level.
// TMA staging, wgmma and a double-buffered ring are later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fw_mma {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 2;               // 32 x 32 regions per warp per sweep
constexpr int CHUNK = 128;           // samples staged per step
// Row stride in bytes: 36 words, so the eight rows g = 0..7 that a fragment
// load touches start on banks 4g apart and the four word columns of a row
// fill the gaps -- conflict-free.  A multiple of 16 keeps uint4 stores aligned.
constexpr int STRIDE = CHUNK + 16;
constexpr int MAX_TILE = 128;        // bx, by <= 128

// Shared memory of the staging area for a bx x by tile.
__host__ __device__ constexpr int staging_bytes(int bx, int by) {
  return (bx + by) * STRIDE;
}

struct Tile {
  const int8_t* dataT;   // (p, n) int8, contiguous
  int n;
  int x0, nx;            // first X variable (row of dataT), valid X rows
  int y0, ny;            // first Y variable, valid Y rows
  int bx, by;            // tile shape: bx % 16 == 0, by % 8 == 0
};

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// four 0/1 bytes: byte i is 1 iff byte i of w equals the level in code4
__device__ __forceinline__ uint32_t indicator(uint32_t w, uint32_t code4) {
  return __vcmpeq4(w, code4) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage samples [k0, k0 + CHUNK) of the tile's X rows into sx and its Y rows
// into sy (row-major, STRIDE bytes a row).
__device__ __forceinline__ void stage(const Tile& t, int k0, uint8_t* sx,
                                      uint8_t* sy) {
  const int rows = t.bx + t.by;
  if (t.n % 16 == 0) {
    // rows start 16-byte aligned and a 16-sample group is all in or all out
    constexpr int V = CHUNK / 16;
    for (int idx = threadIdx.x; idx < rows * V; idx += THREADS) {
      const int r = idx / V, c = (idx % V) * 16;
      const bool isx = r < t.bx;
      const int v = isx ? r : r - t.bx;
      const int gv = isx ? t.x0 + v : t.y0 + v;
      const bool ok = v < (isx ? t.nx : t.ny) && k0 + c < t.n;
      uint4 w = make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);
      if (ok) w = __ldg(reinterpret_cast<const uint4*>(t.dataT + (size_t)gv * t.n + k0 + c));
      *reinterpret_cast<uint4*>((isx ? sx : sy) + v * STRIDE + c) = w;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * CHUNK; idx += THREADS) {
      const int r = idx / CHUNK, c = idx % CHUNK;
      const bool isx = r < t.bx;
      const int v = isx ? r : r - t.bx;
      const int gv = isx ? t.x0 + v : t.y0 + v;
      const bool ok = v < (isx ? t.nx : t.ny) && k0 + c < t.n;
      (isx ? sx : sy)[v * STRIDE + c] =
          ok ? (uint8_t)t.dataT[(size_t)gv * t.n + k0 + c] : (uint8_t)0xff;
    }
  }
}

// One sweep over all samples for the regions [reg0, reg0 + WARPS * RPW) of
// the (na * bx) x (nb * by) product; emit(row, col, count) receives every
// entry of those regions once.  Must be called by all threads of the block.
template <class Emit>
__device__ __forceinline__ void sweep(const Tile& t, int na, int nb, int base,
                                      int reg0, uint8_t* sx, uint8_t* sy,
                                      Emit& emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;   // mma groupID, thread in group
  const int M = na * t.bx, N = nb * t.by;
  const int rcols = (N + 31) / 32;
  const int nreg = ((M + 31) / 32) * rcols;

  // fragment bookkeeping, fixed for the sweep (all warp-uniform)
  int arow[RPW][2], brow[RPW][4];
  uint32_t acode[RPW][2], bcode[RPW][4];
  bool aok[RPW][2], bok[RPW][4];
  int acc[RPW][2][4][4];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int reg = reg0 + warp + WARPS * j;
    const bool valid = reg < nreg;
    const int rm = valid ? reg / rcols : 0, rn = valid ? reg % rcols : 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = rm * 32 + 16 * i;
      aok[j][i] = valid && row < M;
      arow[j][i] = row % t.bx;
      acode[j][i] = 0x01010101u * (uint32_t)(row / t.bx + base);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = rn * 32 + 8 * jj;
      bok[j][jj] = valid && col < N;
      brow[j][jj] = col % t.by;
      bcode[j][jj] = 0x01010101u * (uint32_t)(col / t.by + base);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][i][jj][e] = 0;
  }

  for (int k0 = 0; k0 < t.n; k0 += CHUNK) {
    __syncthreads();               // the previous chunk has been read
    stage(t, k0, sx, sy);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CHUNK; kk += 32) {
      const int wc = kk + 4 * q;   // this thread's first sample of the step
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (aok[j][i]) {
            // rows g and g + 8 of the fragment; samples wc.. and wc + 16..
            const uint8_t* r0 = sx + (arow[j][i] + g) * STRIDE + wc;
            const uint8_t* r1 = r0 + 8 * STRIDE;
            a[i][0] = indicator(lds32(r0), acode[j][i]);
            a[i][1] = indicator(lds32(r1), acode[j][i]);
            a[i][2] = indicator(lds32(r0 + 16), acode[j][i]);
            a[i][3] = indicator(lds32(r1 + 16), acode[j][i]);
          }
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (!bok[j][jj]) continue;
          // column g of the fragment; samples wc.. and wc + 16..
          const uint8_t* c0 = sy + (brow[j][jj] + g) * STRIDE + wc;
          const uint32_t b0 = indicator(lds32(c0), bcode[j][jj]);
          const uint32_t b1 = indicator(lds32(c0 + 16), bcode[j][jj]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (aok[j][i]) mma_s8(acc[j][i][jj], a[i], b0, b1);
        }
      }
    }
  }

  // accumulator e of a fragment: row g (+8 for e >= 2), column 2q (+1 if odd)
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int reg = reg0 + warp + WARPS * j;
    const int rm = reg / rcols, rn = reg % rcols;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (!(aok[j][i] && bok[j][jj])) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          emit(rm * 32 + 16 * i + g + 8 * (e >> 1),
               rn * 32 + 8 * jj + 2 * q + (e & 1), acc[j][i][jj][e]);
      }
  }
}

// All entries of the (na * bx) x (nb * by) product of one tile, in as many
// sweeps as its regions need.  Returns after a barrier, so the staging area
// and whatever emit wrote to shared memory are safe to reuse.
template <class Emit>
__device__ __forceinline__ void tile_counts(const Tile& t, int na, int nb,
                                            int base, uint8_t* sx, uint8_t* sy,
                                            Emit emit) {
  const int M = na * t.bx, N = nb * t.by;
  const int nreg = ((M + 31) / 32) * ((N + 31) / 32);
  for (int reg0 = 0; reg0 < nreg; reg0 += WARPS * RPW)
    sweep(t, na, nb, base, reg0, sx, sy, emit);
  __syncthreads();
}

}  // namespace fw_mma
