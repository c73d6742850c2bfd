// Pipelined tile loop of level-indicator products on the int8 tensor cores,
// shared by K3 (mi_pair_ctabs.cu, levels 0..L-1), K4
// (mi_univar_stats_planes.cu, levels 1..L-1) and K1 (mi_univar_stats.cu,
// levels 1..L-1 in one sweep, L <= 4).
//
// One block owns a pair tile of BX X variables against BY Y variables (rows
// of the (p, n) int8 table dataT).  Read as matrix products, the 0/1
// indicator of "X_x == a" over the samples times the indicator of
// "Y_y == b" counts the samples where both hold, for every level pair
// (a, b) of the tile's pairs.
//
// Work split: every warp owns a 16 x 16 pair sub-tile (warps 2 x 4, so the
// block tile is 32 x 64) and every level product of its pairs, so all eight
// warps do the same work at every L.  The level pairs are taken GW x GW at
// a time, GW a template argument (default G = 3: 72 int32 accumulators a
// lane); the levels FIRST..L-1 take ceil((L - FIRST) / GW)^2 sweeps over the
// samples, which a caller may split between blocks by X level groups.  A
// caller whose levels fit one group passes their number as GW, so that no
// indicator is formed for a level it does not count.
//
// Staging: 128-sample chunks of the tile's 96 rows go through a 3-stage
// cp.async ring (16-byte copies), so two chunks are in flight while one
// multiplies; two blocks fit on an SM.  A row of dataT starts at byte v * n,
// unaligned when n % 16 != 0, so each row's chunk is staged as the 144-byte
// aligned window that covers it, and a fragment word is read at the row's
// byte offset with a funnel shift of the two shared words it straddles.  No
// byte-wise staging for any n.  Copies that would pass the table's end read
// only the bytes before it (cp.async zero fill); samples past n are masked
// to the pad value 0x7F in the last chunk, and rows past the tile's valid
// range repeat its last valid row, whose counts are never written.
//
// Indicators: each raw word (four samples) of a fragment is loaded once per
// sweep and turned into one indicator register per level of the group in
// three integer instructions: v = (w & 0x7f7f7f7f) ^ (a * 0x01010101) has a
// zero byte exactly where a sample equals a; v + 0x7f7f7f7f sets bit 7 of
// every nonzero byte without carrying across bytes (v's bytes are < 0x80),
// so ~(v + 0x7f7f7f7f) & 0x80808080 is 0x80 per matching sample.  The X
// side keeps 0x80, the Y side shifts to 0x01, and
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 sums 128 per joint
// match: exact for n < 2^24; the count is the sum >> 7.  Table values must
// lie in 0..126 (the wrapper's contract 0..L-1 with L <= 127); 0x7f is the
// pad, which matches no level.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fw_pipe {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int WXN = 2;                 // warps along X
constexpr int WYN = 4;                 // warps along Y
constexpr int BX = WXN * 16;           // X variables per block (32)
constexpr int BY = WYN * 16;           // Y variables per block (64)
constexpr int G = 3;                   // levels a side per sweep (default width)
constexpr int CHUNK = 128;             // samples per stage
constexpr int WINDOW = CHUNK + 16;     // aligned window of a row's chunk, bytes
constexpr int WORDS16 = WINDOW / 16;   // 16-byte copies per row (9)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = (BX + BY) * WINDOW;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr uint32_t PAD = 0x7f7f7f7fu;  // four pad samples

struct Tile {
  const int8_t* dataT;   // (p, n) int8, contiguous, 16-byte aligned
  int n;
  size_t total;          // p * n, the table's bytes
  int x0, nx;            // first X variable (row of dataT), valid X rows
  int y0, ny;            // first Y variable, valid Y rows
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_u8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 0x80 in each byte of the 7-bit word v7 that equals the level in code4
__device__ __forceinline__ uint32_t match80(uint32_t v7, uint32_t code4) {
  return ~((v7 ^ code4) + 0x7f7f7f7fu) & 0x80808080u;
}

// Row (of dataT) staged in block-tile row r: rows past the valid range
// repeat the last valid one.
__device__ __forceinline__ int tile_row(const Tile& t, int r) {
  return r < BX ? t.x0 + min(r, t.nx - 1) : t.y0 + min(r - BX, t.ny - 1);
}

// Issues the copies of the aligned windows of samples [k0, k0 + CHUNK) of
// the tile's BX + BY rows into one stage.
__device__ __forceinline__ void load_stage(const Tile& t, int k0,
                                           uint8_t* stage) {
  for (int idx = threadIdx.x; idx < (BX + BY) * WORDS16; idx += THREADS) {
    const int r = idx / WORDS16, w = idx % WORDS16;
    const size_t a = (((size_t)tile_row(t, r) * t.n + k0) & ~(size_t)15) + 16 * w;
    const int bytes = a >= t.total ? 0 : t.total - a >= 16 ? 16 : (int)(t.total - a);
    cp_async16(stage + r * WINDOW + 16 * w, bytes ? t.dataT + a : t.dataT,
               bytes);
  }
}

// Where a fragment row's samples start in a stage: 32-bit word index of the
// row's aligned window plus its byte offset, and the funnel shift.
struct RowRef {
  int word;
  int shift;
};

__device__ __forceinline__ RowRef row_ref(const Tile& t, int r) {
  const int off = (int)(((size_t)tile_row(t, r) * t.n) & 15);
  return RowRef{r * (WINDOW / 4) + (off >> 2), 8 * (off & 3)};
}

// The word of four samples [k0 + pos, k0 + pos + 4) of a row (pos % 4 == 0),
// 7 bits a sample, with samples past n set to the pad.
__device__ __forceinline__ uint32_t load_word(const uint32_t* stage, RowRef rr,
                                             int pos, int rem) {
  const int wi = rr.word + (pos >> 2);
  uint32_t w = __funnelshift_r(stage[wi], stage[wi + 1], rr.shift) & PAD;
  if (rem - pos < 4) {   // only in the chunk that holds sample n
    const int keep = max(0, rem - pos);
    const uint32_t m = keep == 0 ? 0u : (0xffffffffu >> (32 - 8 * keep));
    w = (w & m) | (PAD & ~m);
  }
  return w;
}

// All products of X levels [a_lo, a_hi) and Y levels FIRST..L-1 of one
// block tile, GW x GW levels a sweep (a_lo - FIRST a multiple of GW;
// a_lo = FIRST, a_hi = L for all of them).  Called by every thread of the
// block; epi(a0, na, b0, nb, acc) is called by every warp after each sweep
// with the counts of levels [a0, a0 + na) x [b0, b0 + nb) of its 16 x 16
// pair sub-tile: acc[a][b][j][e] >> 7 is the count of X row
// 16 * (warp % WXN) + g + 8 * (e >> 1) and Y row
// 16 * (warp / WXN) + 8 * j + 2 * q + (e & 1) of the block tile
// (g = lane / 4, q = lane % 4), at levels a0 + a and b0 + b.
template <int FIRST, int GW = G, class Epi>
__device__ __forceinline__ void level_products(const Tile& t, int L, int a_lo,
                                               int a_hi, uint8_t* ring,
                                               Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int xr = 16 * (warp % WXN) + g, yr = BX + 16 * (warp / WXN) + g;
  const RowRef ra0 = row_ref(t, xr), ra1 = row_ref(t, xr + 8);
  const RowRef rb0 = row_ref(t, yr), rb1 = row_ref(t, yr + 8);
  const int chunks = (t.n + CHUNK - 1) / CHUNK;

  for (int a0 = a_lo; a0 < a_hi; a0 += GW) {
    const int na = min(GW, a_hi - a0);
    for (int b0 = FIRST; b0 < L; b0 += GW) {
      const int nb = min(GW, L - b0);
      int acc[GW][GW][2][4];
#pragma unroll
      for (int a = 0; a < GW; ++a)
#pragma unroll
        for (int b = 0; b < GW; ++b)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[a][b][j][e] = 0;

      __syncthreads();   // the ring of the previous sweep has been read
#pragma unroll
      for (int s = 0; s < STAGES - 1; ++s) {
        if (s < chunks) load_stage(t, s * CHUNK, ring + s * STAGE_BYTES);
        cp_async_commit();
      }
      for (int kc = 0; kc < chunks; ++kc) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int next = kc + STAGES - 1;
        if (next < chunks)
          load_stage(t, next * CHUNK, ring + (next % STAGES) * STAGE_BYTES);
        cp_async_commit();

        const uint32_t* st =
            reinterpret_cast<const uint32_t*>(ring + (kc % STAGES) * STAGE_BYTES);
        const int rem = t.n - kc * CHUNK;   // valid samples from the chunk's start
#pragma unroll 2
        for (int kk = 0; kk < CHUNK; kk += 32) {
          const int p0 = kk + 4 * q, p1 = p0 + 16;
          const uint32_t w[4] = {load_word(st, ra0, p0, rem),
                                 load_word(st, ra1, p0, rem),
                                 load_word(st, ra0, p1, rem),
                                 load_word(st, ra1, p1, rem)};
          uint32_t ai[GW][4];
#pragma unroll
          for (int a = 0; a < GW; ++a) {
            const uint32_t code = 0x01010101u * (uint32_t)(a0 + a);
#pragma unroll
            for (int i = 0; i < 4; ++i) ai[a][i] = match80(w[i], code);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const RowRef rb = j ? rb1 : rb0;
            const uint32_t v0 = load_word(st, rb, p0, rem);
            const uint32_t v1 = load_word(st, rb, p1, rem);
#pragma unroll
            for (int b = 0; b < GW; ++b) {
              if (b >= nb) continue;
              const uint32_t code = 0x01010101u * (uint32_t)(b0 + b);
              const uint32_t bi0 = match80(v0, code) >> 7;
              const uint32_t bi1 = match80(v1, code) >> 7;
#pragma unroll
              for (int a = 0; a < GW; ++a)
                if (a < na) mma_u8(acc[a][b][j], ai[a], bi0, bi1);
            }
          }
        }
      }
      cp_async_wait<0>();
      epi(a0, na, b0, nb, acc);
    }
  }
}

}  // namespace fw_pipe
