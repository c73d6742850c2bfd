// K6: the mi / mi_nz window digest: the float64 log p of every test of a
// round and, for each candidate's contiguous segment of tests, the first
// non-significant test, the weakest significant test's stat and its p.
//
// Replaces the tail of the JAX package's window digest,
// flashweave_tpu/ops/condtests.py:221 `_mi_cond_digest_scan_fn` (its log p
// and segment reductions, :255-284), over
// flashweave_tpu/ops/statfuns.py:146 `mi_logpval_smalldf`: an XLA function
// there, not a `pl.pallas_call`.  Same function as the port's plain
// version, ops/condtests.py:_mi_digest (ops/statfuns.py:mi_logpval_smalldf,
// then _digest_reduce).
//
// Inputs: per test (stat float64, df int64, n_obs float64, suff bool) of B
// tests in NC contiguous segments of `counts` (NC,) int64 tests, and their
// running sums `ends` (NC,) int64.  Output (3, NC) float64 [exit_e, wstat,
// exp(M)]: exit_e the first local index whose log p is not below log alpha
// (-1: none), M the largest significant log p (-inf: none), wstat the stat
// at the last local index attaining it (at the segment's first test
// without one).  A test whose power check failed has log p 0.  A segment
// whose length by `ends` is not its count gets NaN in all three rows.
//
// What bounds it on this card: the float64 pipe.  A test of df d runs
// d / 2 steps of the logsumexp chain, each an exp, a log and a few float64
// operations, while it reads 25 bytes; at the headline's max_df = 108 a
// test runs up to 54 steps, and the steps of a batch's tests differ by up
// to 13x (df 1 .. 27 at the headline).
//
// What the design does about it:
// - a block a tile of consecutive tests (`tile`: TILE_MAX, halved by the
//   wrapper down to TILE_MIN while the tiles would fill fewer than two
//   blocks an SM), staged in shared memory with coalesced loads as
//   x = |stat| n_obs and df;
// - the tile's tests counting-sorted by chain class (df / 2, evens before
//   odds: a class's tests run the same code for the same steps), and a
//   warp 32 neighbouring sorted tests, the warps' groups dealt in snake
//   order, so no lane waits on a longer chain and no warp on the others;
// - one exp a logsumexp step, through libdevice's exp and log main paths
//   transcribed with their constants in constant memory and no branch
//   (csrc/mi_digest.cuh's lse2 and core::), the lgamma offsets in shared
//   memory; the chain's operations otherwise the plain chain's in its
//   order, explicitly rounded, so its log p is the plain version's bit for
//   bit; 64 registers a thread (4 blocks an SM, 32 warps; two chains a
//   thread interleaved were slower for want of registers);
// - each log p back at its test's place, then the tile's segments reduced
//   there (a thread a segment of up to SHORT tests in the tile, a warp a
//   longer one, finished by a thread each) with fw_digest::Best: compare
//   and select only, associative and commutative, so any order gives the
//   plain version's bits;
// - a segment that crosses a tile edge leaves a partial Best in each of its
//   tiles (the first tile's `spill`, the last one's `head`); a second small
//   kernel, a warp a segment, merges them.  A tile finds its segments by a
//   32-way warp search of `ends`, which the caller uploads with the counts,
//   and stages the bounds of its first SEG_SMEM segments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mi_digest.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_MAX = 2048;        // tests a block at most
constexpr int TILE_MIN = 256;
constexpr int PER_THREAD = TILE_MAX / THREADS;
constexpr int HALF = 128;             // chain classes of each parity
constexpr int CLASSES = 2 * HALF;     // evens 0..127, odds 128..254
constexpr int PAD = CLASSES - 1;      // a position past the tile's tests
constexpr int SHORT = 32;             // tile-local tests a thread reduces
constexpr int LONGS = TILE_MAX / (SHORT + 1) + 1;
constexpr int LG_SMEM = 256;          // lgamma offsets held in shared memory
constexpr int SEG_SMEM = 256;         // segment bounds held in shared memory
constexpr int MERGE_WARPS = 4;        // head tiles a merge block
constexpr int MIN_BLOCKS = 4;         // blocks an SM: 64 registers a thread

static_assert(THREADS == CLASSES, "the class scan takes a class a thread");
static_assert(TILE_MAX % THREADS == 0 && TILE_MIN % THREADS == 0,
              "a tile is whole rows of the block");

// a partial digest of a segment over one tile
struct Part {
  double M;
  int exit;
  int w;
};

struct Args {
  const double* stat;
  const long long* df;
  const double* nobs;
  const uint8_t* suff;
  const long long* counts;            // (NC,) the segments' tests
  const long long* ends;              // (NC,) running sums of the counts
  long long B;
  int NC, max_df, tile, tiles;
  double log_alpha;
  const double* lg;                   // (max_df / 2, 2) lgamma offsets
  Part* spill;                        // (tiles,) the segment past the end
  Part* head;                         // (tiles,) the segment from before
  int* head_seg;                      // (tiles,) that segment, -1: none
  double* out;                        // (3, NC)
};

__device__ __forceinline__ long long seg_start(const long long* ends,
                                               int c) {
  return c > 0 ? ends[c - 1] : 0;
}

// the first segment c whose end ends[c] passes t (NC: none), by the whole
// warp: each round 32 lanes probe evenly spaced segments of the range
// left, which shrinks 32-fold
__device__ int first_end_past(const long long* ends, int NC, long long t,
                              int lane) {
  int lo = 0, hi = NC;                // the answer lies in [lo, hi]
  while (lo < hi) {
    const int s = (hi - lo + 31) / 32;
    const int q = lo + (lane + 1) * s - 1;
    const bool valid = q < hi;
    const unsigned past = __ballot_sync(fw_digest::FULL,
                                        valid && ends[q] > t);
    if (past) {
      const int j = __ffs(past) - 1;
      hi = lo + (j + 1) * s - 1;
      lo += j * s;
    } else {
      const int j = 31 - __clz(__ballot_sync(fw_digest::FULL, valid));
      lo += (j + 1) * s;
    }
  }
  return lo;
}

__device__ __forceinline__ void write_out(const Args& a, int c,
                                          const fw_digest::Best& b,
                                          long long s0) {
  if (a.ends[c] - s0 != a.counts[c]) {        // ends are not the counts'
    a.out[c] = a.out[a.NC + c] = a.out[2 * (long long)a.NC + c] = NAN;
    return;
  }
  // the plain version's clamp of the weakest test's place into the batch
  const long long at = min(s0 + max(b.w, 0), a.B - 1);
  a.out[c] = b.exit == INT_MAX ? -1.0 : (double)b.exit;
  a.out[a.NC + c] = a.stat[at];
  a.out[2 * (long long)a.NC + c] = exp(b.M);
}

__device__ __forceinline__ Part to_part(const fw_digest::Best& b) {
  return {b.M, b.exit, b.w};
}

__device__ __forceinline__ fw_digest::Best from_part(const Part& p) {
  return {p.exit, p.M, p.w};
}

// a segment's digest over the tile: the spill's and a head's (a segment
// that began in an earlier tile) as partials, any other one whole
__device__ __forceinline__ void finish(const Args& a, int c,
                                       const fw_digest::Best& b,
                                       long long s0, long long t0, int hi) {
  if (c == hi) {
    a.spill[blockIdx.x] = to_part(b);
  } else if (s0 < t0) {
    a.head[blockIdx.x] = to_part(b);
    a.head_seg[blockIdx.x] = c;
  } else {
    write_out(a, c, b, s0);
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
mi_window_digest_kernel(Args a) {
  __shared__ double xs[TILE_MAX];             // x = |stat| n_obs, then log p
  __shared__ int dfs[TILE_MAX];               // df where the chain runs, 0
  __shared__ unsigned short order[TILE_MAX];  // positions by chain class
  __shared__ int start[CLASSES];              // counts, then first places
  __shared__ double lgs[LG_SMEM];
  __shared__ int wsum[WARPS];
  __shared__ int segs[3];                     // first, past last, spill
  __shared__ long long sb[SEG_SMEM + 1];      // segment starts from lo
  __shared__ int longs[LONGS];
  __shared__ fw_digest::Best lbest[LONGS];
  __shared__ int nlong;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long t0 = (long long)blockIdx.x * a.tile;
  const long long t1 = min(t0 + a.tile, a.B);
  const int n = (int)(t1 - t0);
  const bool last = (int)blockIdx.x == a.tiles - 1;

  start[tid] = 0;
  if (tid == 0) nlong = 0;
  // the tile's segments: those ending in (t0, t1] (from the first tile
  // also those ending at 0; to the last every one left), and the spill,
  // the segment holding test t1 - 1 that ends past t1
  if (warp == 0) {
    const int lo = blockIdx.x == 0 ? 0 : first_end_past(a.ends, a.NC, t0,
                                                        lane);
    if (lane == 0) {
      segs[0] = lo;
      a.head_seg[blockIdx.x] = -1;
    }
  } else if (warp == 1) {
    const int hi = last ? a.NC : first_end_past(a.ends, a.NC, t1, lane);
    if (lane == 0) {
      segs[1] = hi;
      segs[2] = !last && seg_start(a.ends, hi) < t1;
    }
  }
  const int lg_n = 2 * (a.max_df / 2);
  const bool lg_smem = lg_n <= LG_SMEM;
  if (lg_smem)
    for (int i = tid; i < lg_n; i += THREADS) lgs[i] = a.lg[i];
  __syncthreads();

  // the starts of the tile's first SEG_SMEM + 1 segments (B past the last)
  {
    const int lo = segs[0];
    for (int j = tid; j <= SEG_SMEM; j += THREADS)
      sb[j] = lo + j <= a.NC ? seg_start(a.ends, lo + j) : a.B;
  }
  // stage the tile, and rank each test within its class (warp-aggregated
  // shared atomics); positions past the tile's tests take the last class
  int code[PER_THREAD];                       // class << 16 | rank
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    if (r * THREADS >= a.tile) break;
    const int p = r * THREADS + tid;
    int cls = PAD;
    if (p < n) {
      const long long t = t0 + p;
      const long long d = a.df[t];
      const int dv = a.suff[t] && d >= 1 && d <= a.max_df ? (int)d : 0;
      xs[p] = __dmul_rn(fabs(a.stat[t]), a.nobs[t]);
      dfs[p] = dv;
      cls = fw_digest::chain_class<HALF>(dv);
    }
    const unsigned peers = __match_any_sync(fw_digest::FULL, cls);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(&start[cls], __popc(peers));
    base = __shfl_sync(fw_digest::FULL, base, leader);
    code[r] = cls << 16 | (base + __popc(peers & ((1u << lane) - 1)));
  }
  __syncthreads();

  // the classes' first places in sorted order: a block-wide exclusive scan
  {
    const int v = start[tid];
    int inc = v;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int u = __shfl_up_sync(fw_digest::FULL, inc, s);
      if (lane >= s) inc += u;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += wsum[w];
    start[tid] = before + inc - v;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < PER_THREAD; ++r) {
    if (r * THREADS >= a.tile) break;
    order[start[code[r] >> 16] + (code[r] & 0xffff)] =
        (unsigned short)(r * THREADS + tid);
  }
  __syncthreads();

  // the chains: a warp 32 neighbouring sorted tests, the groups dealt in
  // snake order (cheap to dear, then back); each log p to its test's place
  {
    const double* lg = lg_smem ? lgs : a.lg;
    const int groups = (n + 31) / 32;
    for (int g0 = 0; g0 < groups; g0 += WARPS) {
      const int g = g0 + (((g0 / WARPS) & 1) ? WARPS - 1 - warp : warp);
      const int q = g * 32 + lane;
      if (g < groups && q < n) {
        const int p = order[q];
        const int d = dfs[p];
        xs[p] = d ? fw_digest::mi_logp_x(xs[p], d, lg) : 0.0;
      }
    }
  }
  __syncthreads();

  // the tile's segments: a thread each, the longer ones listed for a warp
  // each and then finished a thread each, so that the reads of their
  // weakest tests' stat overlap
  const int lo = segs[0], hi = segs[1], cend = hi + segs[2];
  for (int c = lo + tid; c < cend; c += THREADS) {
    const long long s0 = c - lo < SEG_SMEM ? sb[c - lo] : seg_start(a.ends, c);
    const long long e = c - lo < SEG_SMEM ? sb[c - lo + 1] : a.ends[c];
    const int q0 = (int)(max(s0, t0) - t0), q1 = (int)(min(e, t1) - t0);
    if (q1 - q0 > SHORT) {
      longs[atomicAdd(&nlong, 1)] = c;
      continue;
    }
    fw_digest::Best b = fw_digest::best_init();
    for (int q = q0; q < q1; ++q)
      fw_digest::best_add(b, (int)(t0 + q - s0), xs[q], a.log_alpha);
    finish(a, c, b, s0, t0, hi);
  }
  __syncthreads();
  for (int j = warp; j < nlong; j += WARPS) {
    const int c = longs[j];
    const long long s0 = c - lo < SEG_SMEM ? sb[c - lo] : seg_start(a.ends, c);
    const long long e = c - lo < SEG_SMEM ? sb[c - lo + 1] : a.ends[c];
    const int q0 = (int)(max(s0, t0) - t0), q1 = (int)(min(e, t1) - t0);
    fw_digest::Best b = fw_digest::best_init();
    for (int q = q0 + lane; q < q1; q += 32)
      fw_digest::best_add(b, (int)(t0 + q - s0), xs[q], a.log_alpha);
    b = fw_digest::best_warp(b);
    if (lane == 0) lbest[j] = b;
  }
  __syncthreads();
  for (int j = tid; j < nlong; j += THREADS) {
    const int c = longs[j];
    finish(a, c, lbest[j],
           c - lo < SEG_SMEM ? sb[c - lo] : seg_start(a.ends, c), t0, hi);
  }
}

// the segments that cross tile edges: a warp a tile whose head segment
// began in an earlier tile, merging that segment's spills from its first
// tile on with the head
__global__ void __launch_bounds__(MERGE_WARPS * 32)
mi_window_digest_merge_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  if (i >= a.tiles) return;                    // whole warps only
  const int c = a.head_seg[i];
  if (c < 0) return;
  const long long s0 = seg_start(a.ends, c);
  fw_digest::Best b = fw_digest::best_init();
  for (int j = (int)(s0 / a.tile) + lane; j < i; j += 32)
    fw_digest::best_merge(b, from_part(a.spill[j]));
  b = fw_digest::best_warp(b);
  if (lane != 0) return;
  fw_digest::best_merge(b, from_part(a.head[i]));
  write_out(a, c, b, s0);
}

}  // namespace

extern "C" {

// Launches K6 on `stream` (the tile kernel, then the merge kernel where
// there is more than one tile) and returns the cudaError_t of the launches
// (0 on success).  stat, nobs: float64, df: int64, suff: uint8, each (B,);
// counts: (NC,) int64 the segments' tests; ends: (NC,) int64 their running
// sums, ends[NC - 1] == B (where a segment's length by ends is not its
// count, its three outputs are NaN); lg: (max_df / 2, 2) float64; tile: tests a block, a multiple of 256 in
// 256..2048; scratch: 36 bytes a tile, 16-byte aligned; out: (3, NC)
// float64.
int fw_mi_window_digest(const void* stat, const void* df, const void* nobs,
                        const void* suff, const void* counts,
                        const void* ends, long long B,
                        int NC, int max_df, int tile, double log_alpha,
                        const void* lg, void* scratch, void* out,
                        void* stream) {
  if (B <= 0 || NC <= 0 || max_df < 0 || tile < TILE_MIN ||
      tile > TILE_MAX || tile % THREADS)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (B + tile - 1) / tile;
  if (tiles > INT_MAX / MERGE_WARPS) return (int)cudaErrorInvalidValue;
  Part* parts = static_cast<Part*>(scratch);
  Args a{static_cast<const double*>(stat), static_cast<const long long*>(df),
         static_cast<const double*>(nobs), static_cast<const uint8_t*>(suff),
         static_cast<const long long*>(counts),
         static_cast<const long long*>(ends), B, NC, max_df, tile,
         (int)tiles, log_alpha, static_cast<const double*>(lg), parts,
         parts + tiles, reinterpret_cast<int*>(parts + 2 * tiles),
         static_cast<double*>(out)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  mi_window_digest_kernel<<<(unsigned)tiles, THREADS, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return (int)err;
  mi_window_digest_merge_kernel<<<
      (unsigned)((tiles + MERGE_WARPS - 1) / MERGE_WARPS), MERGE_WARPS * 32,
      0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
