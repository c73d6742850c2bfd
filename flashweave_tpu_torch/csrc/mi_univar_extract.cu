// K8: the univariate extraction sweep: one block of the all-pairs pass
// reduced to its candidates, in one launch and with no host sync.
//
// Replaces the per-block bodies of the JAX package's extraction passes,
// flashweave_tpu/ops/univariate.py:576 `_passA_fn` (log p, the counts under
// the bin edges and the unreliable count, the candidates below the
// threshold) and :629 `_passB_fn` (the candidates below the chosen edge),
// driven by :772 `_extract_scan`: XLA functions there, not a
// `pl.pallas_call`.  Same function as the port's plain version,
// ops/kernels.py:univar_extract_ref (ops/univariate.py:_pair_scores, then
// torch.nonzero, the compaction and the edge counts).
//
// Inputs: the (t, q) outputs of a block function for the X rows s.. and the
// Y columns y0.., row-major.  Front MI reads (stat float64, df int32, n_obs
// int32, suff bool) and computes each pair's log p with
// fw_digest::mi_logp's chain (csrc/mi_digest.cuh: statfuns.
// mi_logpval_smalldf bit for bit); front GIVEN reads (log p float64, stat
// float64, suff bool) that the plain Fisher-z chain computed (suff one
// value for the whole block where `suff_all`).  Per pair, the plain
// version's rules: a pair only where X < Y; unreliable where not suff or
// log p is NaN, then log p +inf (`reliable`, correct_reliable_only) or 0;
// a candidate where log p < thresh.  Outputs, accumulated over the
// launches of a sweep: tally[0] the candidates so far (the cursor),
// tally[1] the unreliable pairs, tally[2 + j] the candidates with log p <
// edges[j] (only with `edges`); each candidate's (X int32, Y int32, log p
// float64, stat float64) at its cursor slot, where the slot is below `cap`
// (the cursor counts on past it, so the caller sees the total and refuses
// or sweeps again).  Candidates land in no fixed order; the caller's sort
// and BH depend only on their values.
//
// What bounds it on this card: the float64 pipe (front MI) or device
// memory (front GIVEN).  A pair reads its power flag (one byte, or none
// where one flag serves the block); front MI reads a pair's df, and its
// stat and n_obs where it has power, and there runs its log p chain: at
// the headline's df <= 4 an erfc (odd df) or a logsumexp step (df >= 3),
// 46-301 float64 operations by df, and up to 60 steps at 12 levels (max_df
// 121); front GIVEN reads the log p (8 bytes) where it has power and the
// stat only of a candidate.  A candidate (about 1% of the pairs at alpha =
// 0.01) writes 24 bytes.
//
// What the design does about it:
// - a block takes a tile of TILE consecutive pairs of one row at a time;
//   a grid of as many blocks as the SMs hold at once asks one counter for
//   the tiles in turn (each block asks for its next while it works on
//   one), so a block of dear rows holds up no other; the last block to
//   finish leaves the counter at 0 for the next launch; a tile wholly at
//   X >= Y is skipped without a load;
// - the tile is staged in shared memory with wide loads, VEC consecutive
//   pairs a thread a load, every load of a group issued at once (uchar4
//   power flags, int4 df and n_obs, double2 stat or log p, where the rows
//   and pointers are aligned for them, and scalar loads otherwise): front
//   MI as x = |stat| n_obs (the first product of mi_logp) and the df of a
//   pair that runs a chain (0: none), front GIVEN as its log p; NaN for a
//   pair without power, +inf where no pair; the tile's least and greatest
//   chain class (K6's df / 2, evens first) by warp reductions;
// - a tile of one chain class (the headline's and phase 6's blocks hold one
//   df) runs its chains in tile order, a lane a pair; any other tile is
//   counting-sorted by class (a pass counting each class with one shared
//   atomic a warp's lanes of a class, a block-wide shuffle scan, a pass
//   scattering the positions to `order[]`) and a warp runs 32 neighbouring
//   sorted chains, the warps' groups dealt in snake order, so no lane
//   issues another class's branch and no warp waits on the others; each
//   log p back at its pair's place (mi_logp_x after mi_logp's range
//   check, so the same bits);
// - the compaction in tile order from shared memory: a warp's candidates by
//   ballots, the warps' counts scanned by one warp's shuffles, and one
//   global atomic a tile on the cursor; a lane's slot is its warp's base
//   plus the candidates of the lanes and items before it;
// - a candidate's bin is the number of edges its log p is below, by
//   float64 comparisons against the edges in shared memory (the edges
//   strictly decrease, which the wrapper checks, so the candidate is below
//   exactly edges 0..bin-1); bins go to a shared histogram, and at the end
//   each edge's count (the candidates in the bins past it) to the global
//   tally with one 64-bit atomic, as does the block's unreliable count
//   (a warp's by ballots, one shared atomic a tile);
// - 64 registers a thread (where the tile lies is read again after the
//   chains, so no register holds it through them) and 26 KB of shared
//   memory a block, so 4 blocks of 256 threads an SM (`__launch_bounds__`;
//   tiles of 2,048 pairs: `k8_variants.py` found 4,096 no faster at the
//   headline and 20% slower on mixed df); the wrapper asks the grid (SMs
//   times resident blocks) once a device.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mi_digest.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 2048;               // consecutive pairs of a row
constexpr int ITEMS = TILE / THREADS;    // pairs a thread a tile
constexpr int VEC = 4;                   // consecutive pairs a wide load
constexpr int GROUPS = ITEMS / VEC;      // wide loads a thread a tile
constexpr int HALF = 128;                // chain classes of each parity
constexpr int CLASSES = 2 * HALF;        // evens 0..127, odds 128..254
constexpr int PAD = CLASSES - 1;         // pairs without a chain
constexpr int MIN_BLOCKS = 4;            // blocks an SM: 64 registers
constexpr int N_EDGES = 48;              // ops/univariate.py:N_EXTRACT_BINS
constexpr int TALLY = 2 + N_EDGES;       // cursor, unreliable, edge counts
constexpr int FRONT_MI = 0;
constexpr int FRONT_GIVEN = 1;

static_assert(THREADS == CLASSES, "the class scan takes a class a thread");
static_assert(TILE % (THREADS * VEC) == 0, "a tile is whole wide loads");
static_assert(TILE <= 65536, "order[] holds a tile position in 16 bits");
static_assert(N_EDGES < THREADS, "the fold takes an edge a thread");
static_assert(WARPS <= 32, "one warp scans the warps' counts");

struct Args {
  int front;
  const double* stat;      // (t, q)
  const double* logp;      // (t, q), front GIVEN
  const int* df;           // (t, q), front MI
  const int* nobs;         // (t, q), front MI
  const uint8_t* suff;     // (t, q), or one value where suff_all
  int suff_all;
  int vec;                 // rows and pointers aligned for wide loads
  int q;
  int s, y0;
  unsigned tiles;          // t * tiles_row
  int tiles_row;
  double thresh;
  int reliable;
  int max_df;
  const double* lg;        // (max_df / 2, 2), front MI
  const double* edges;     // (N_EDGES,) strictly decreasing, or null
  long long cap;
  unsigned long long* tally;  // (TALLY,)
  unsigned* sched;         // (2,) the tiles asked for, the blocks done
  int* X;
  int* Y;
  double* lp;
  double* st;
};

// a pair's log p after the unreliable rule: NaN (no power, or a NaN log
// p) becomes +inf where `reliable`, else 0
__device__ __forceinline__ double ruled(double v, const Args& a) {
  return isnan(v) ? (a.reliable ? INFINITY : 0.0) : v;
}

// VEC consecutive values at element e (aligned where `vec`), of which the
// first `n` lie in the row
__device__ __forceinline__ void load_vec(const double* p, long long e,
                                         bool vec, int n, double (&v)[VEC]) {
  if (vec) {
    const double2 a = *reinterpret_cast<const double2*>(p + e);
    const double2 b = *reinterpret_cast<const double2*>(p + e + 2);
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < n ? p[e + j] : 0.0;
  }
}

__device__ __forceinline__ void load_vec(const int* p, long long e, bool vec,
                                         int n, int (&v)[VEC]) {
  if (vec) {
    const int4 a = *reinterpret_cast<const int4*>(p + e);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < n ? p[e + j] : 0;
  }
}

// where a tile lies: its row's X, its first column and its first element
struct TileAt {
  int x, col0;
  long long base;
};

__device__ __forceinline__ TileAt tile_at(const Args& a, unsigned c) {
  const int row = (int)(c / a.tiles_row);
  const int col0 = (int)(c % a.tiles_row) * TILE;
  return {a.s + row, col0, (long long)row * a.q + col0};
}

// a chain pair's log p from its x = |stat| n_obs: mi_logp after its range
// check, so the same bits (the one place both chain loops call, which
// k8_variants.py's build without chains replaces)
__device__ __forceinline__ double chain_logp(double x, int df,
                                             const double* lg) {
  return fw_digest::mi_logp_x(x, df, lg);
}

// the sort's class of a pair whose chain runs to df (0: none, PAD)
__device__ __forceinline__ int class_of(int df) {
  return df ? fw_digest::chain_class<HALF>(df) : PAD;
}

// threadIdx.x, read where it is used: the tile loop keeps no address of a
// thread's shared words in a register
__device__ __forceinline__ int this_thread() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// the lanes below this one in its warp
__device__ __forceinline__ unsigned lanes_before() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// a warp's lanes grouped by class: every lane where they share one (the
// common case, without a match), else the lanes of its own class
__device__ __forceinline__ unsigned class_peers(int cls) {
  const bool one = __all_sync(fw_digest::FULL,
                              cls == __shfl_sync(fw_digest::FULL, cls, 0));
  return one ? fw_digest::FULL : __match_any_sync(fw_digest::FULL, cls);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    mi_univar_extract_kernel(const Args a) {
  // the tile: x (front MI, a chain), 0 (front MI, power and no chain) or
  // log p (GIVEN); NaN: no power; +inf: no pair.  After the chains, log p.
  __shared__ double lp[TILE];
  __shared__ unsigned short dfs[TILE];    // a chain's df, 0: no chain
  __shared__ unsigned short order[TILE];  // tile positions by chain class
  __shared__ int start[CLASSES];  // a class's pairs, then its first place
  __shared__ int wsum[WARPS];
  __shared__ int n_chains;        // the tile's pairs with a chain
  __shared__ double edges[N_EDGES];
  __shared__ unsigned hist[N_EDGES + 1];
  __shared__ unsigned warp_n[WARPS];
  __shared__ unsigned long long warp_base[WARPS];
  __shared__ unsigned long long block_unrel;
  __shared__ unsigned next_tile;  // the tile the block takes next
  __shared__ unsigned this_tile;  // the tile it works on
  __shared__ int span[2];         // the tile's least and greatest class
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool counting = a.edges != nullptr;
  const bool mi = a.front == FRONT_MI;
  const bool vec = a.vec != 0;
  if (counting) {
    if (tid < N_EDGES) edges[tid] = a.edges[tid];
    if (tid <= N_EDGES) hist[tid] = 0;
  }
  const bool one_flag = a.suff_all != 0;
  start[tid] = 0;
  if (tid == 0) {
    block_unrel = 0;
    next_tile = atomicAdd(a.sched, 1u);
    span[0] = PAD;
    span[1] = 0;
  }
  __syncthreads();
  for (;;) {
    // tiles in the order the blocks ask for them: the block asks for its
    // next while it works on this one
    const unsigned c = next_tile;
    if (c >= a.tiles) break;
    TileAt at = tile_at(a, c);
    const int n = min(TILE, a.q - at.col0);  // the tile's positions in the row
    const int lo = at.x - a.y0 - at.col0;    // a pair where position > lo
    if (lo >= n - 1) {                       // wholly at X >= Y
      __syncthreads();
      if (tid == 0) next_tile = atomicAdd(a.sched, 1u);
      __syncthreads();
      continue;
    }
    if (tid == 0) this_tile = c;

    // stage: VEC consecutive positions a load, every load of a group at
    // once; each position's value and class, and the tile's least and
    // greatest class
    int cmin = PAD, cmax = 0;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      const int p0 = (g * THREADS + tid) * VEC;
      const long long e0 = at.base + p0;
      const int m = min(VEC, n - p0);       // positions in the row
      bool power[VEC];
      int dv[VEC];
      double v[VEC], sv[VEC];
      int nv[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        power[j] = false;
        dv[j] = nv[j] = 0;
        v[j] = sv[j] = 0.0;
      }
      if (m > 0 && p0 + m - 1 > lo) {
        if (one_flag) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) power[j] = a.suff[0];
        } else if (vec) {
          const uchar4 f = *reinterpret_cast<const uchar4*>(a.suff + e0);
          power[0] = f.x, power[1] = f.y, power[2] = f.z, power[3] = f.w;
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) power[j] = j < m && a.suff[e0 + j];
        }
        if (mi) {
          load_vec(a.df, e0, vec, m, dv);
          load_vec(a.stat, e0, vec, m, sv);
          load_vec(a.nobs, e0, vec, m, nv);
        } else {
          load_vec(a.logp, e0, vec, m, v);
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int p = p0 + j;
        const bool pair = j < m && p > lo;
        const bool pw = pair && power[j];
        const bool chain = mi && pw && dv[j] >= 1 && dv[j] <= a.max_df;
        double val = v[j];
        if (mi) val = chain ? __dmul_rn(fabs(sv[j]), (double)nv[j]) : 0.0;
        if (!pw) val = pair ? NAN : INFINITY;
        lp[p] = val;
        const int cls = chain ? fw_digest::chain_class<HALF>(dv[j]) : PAD;
        dfs[p] = (unsigned short)(chain ? dv[j] : 0);
        if (chain) {
          cmin = min(cmin, cls);
          cmax = max(cmax, cls);
        }
      }
    }
    if (mi) {
      cmin = __reduce_min_sync(fw_digest::FULL, cmin);
      cmax = __reduce_max_sync(fw_digest::FULL, cmax);
      if (lane == 0 && cmax) {
        atomicMin(&span[0], cmin);
        atomicMax(&span[1], cmax);
      }
    }
    __syncthreads();

    // every thread has read next_tile: ask for the tile after this one
    if (tid == 0) next_tile = atomicAdd(a.sched, 1u);

    if (mi && span[1]) {
      if (span[0] == span[1]) {
        // one chain class: the chains in tile order, as they lie
#pragma unroll 1
        for (int k = 0; k < ITEMS; ++k) {
          const int p = k * THREADS + tid;
          const int d = dfs[p];
          if (d) lp[p] = chain_logp(lp[p], d, a.lg);
        }
      } else {
        // counting-sort the tile by chain class: count (a warp's lanes of
        // a class with one shared atomic), scan, scatter
#pragma unroll 4
        for (int k = 0; k < ITEMS; ++k) {
          const int cls = class_of(dfs[k * THREADS + tid]);
          const unsigned peers = class_peers(cls);
          if (lane == __ffs(peers) - 1) atomicAdd(&start[cls], __popc(peers));
        }
        __syncthreads();
        // the classes' first places in sorted order: a block-wide
        // exclusive scan, a class a thread
        const int own = start[this_thread()];
        int inc = own;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(fw_digest::FULL, inc, o);
          if (lane >= o) inc += u;
        }
        if (lane == 31) wsum[warp] = inc;
        __syncthreads();
        int before = 0;
        for (int w = 0; w < warp; ++w) before += wsum[w];
        start[this_thread()] = before + inc - own;
        if (tid == PAD) n_chains = before + inc - own;
        __syncthreads();
        const int chains = n_chains;
#pragma unroll 4
        for (int k = 0; k < ITEMS; ++k) {
          const int p = k * THREADS + tid;
          const int cls = class_of(dfs[p]);
          const unsigned peers = class_peers(cls);
          const int leader = __ffs(peers) - 1;
          int at = 0;
          if (lane == leader) at = atomicAdd(&start[cls], __popc(peers));
          at = __shfl_sync(fw_digest::FULL, at, leader);
          order[at + __popc(peers & lanes_before())] = (unsigned short)p;
        }
        __syncthreads();
        start[this_thread()] = 0;            // for the next tile
        // the chains: a warp 32 neighbouring sorted pairs, the groups dealt
        // in snake order (cheap to dear, then back); each log p to its place
        const int groups = (chains + 31) / 32;
#pragma unroll 1
        for (int g0 = 0; g0 < groups; g0 += WARPS) {
          const int g = g0 + (((g0 / WARPS) & 1) ? WARPS - 1 - warp : warp);
          const int sp = g * 32 + lane;
          if (sp < chains) {
            const int p = order[sp];
            lp[p] = chain_logp(lp[p], dfs[p], a.lg);
          }
        }
      }
      __syncthreads();
    }

    // where the tile lies, again from shared memory: no register holds it
    // through the chains
    at = tile_at(a, this_tile);
    // the candidates, in tile order: a warp's counted by ballots (and
    // ballotted again when their slots are known, which keeps no mask)
    unsigned cnt = 0, unrel = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const double v = lp[k * THREADS + tid];
      unrel += __popc(__ballot_sync(fw_digest::FULL, isnan(v)));
      cnt += __popc(__ballot_sync(fw_digest::FULL, ruled(v, a) < a.thresh));
    }
    // the warp's unreliable pairs, one shared atomic a tile (no register
    // carries them from tile to tile)
    if (lane == 0 && unrel)
      atomicAdd(&block_unrel, (unsigned long long)unrel);
    if (lane == 0) warp_n[warp] = cnt;
    __syncthreads();
    // the warps' counts scanned by one warp's shuffles; one global atomic
    // a tile takes their slots
    if (warp == 0) {
      const unsigned long long own = lane < WARPS ? warp_n[lane] : 0;
      unsigned long long inc = own;
#pragma unroll
      for (int o = 1; o < WARPS; o <<= 1) {
        const unsigned long long u = __shfl_up_sync(fw_digest::FULL, inc, o);
        if (lane >= o) inc += u;
      }
      const unsigned long long total =
          __shfl_sync(fw_digest::FULL, inc, WARPS - 1);
      unsigned long long first = 0;
      if (lane == 0 && total) first = atomicAdd(a.tally, total);
      first = __shfl_sync(fw_digest::FULL, first, 0);
      if (lane < WARPS) warp_base[lane] = first + inc - own;
      if (lane == 0) {                       // every thread has read span
        span[0] = PAD;
        span[1] = 0;
      }
    }
    __syncthreads();
    if (cnt) {
      unsigned long long slot = warp_base[warp];
#pragma unroll 4
      for (int k = 0; k < ITEMS; ++k) {
        const int p = k * THREADS + tid;
        const double v = ruled(lp[p], a);
        const unsigned mask = __ballot_sync(fw_digest::FULL, v < a.thresh);
        if (mask >> lane & 1u) {
          const unsigned long long i = slot + __popc(mask & lanes_before());
          if (i < (unsigned long long)a.cap) {
            a.X[i] = at.x;
            a.Y[i] = a.y0 + at.col0 + p;
            a.lp[i] = v;
            a.st[i] = a.stat[at.base + p];
          }
          if (counting) {
            int bin = 0;
#pragma unroll 8
            for (int j = 0; j < N_EDGES; ++j) bin += v < edges[j];
            atomicAdd(&hist[bin], 1u);
          }
        }
        slot += __popc(mask);
      }
    }
    __syncthreads();                         // the tile's arrays are free
  }
  // the block's unreliable pairs and edge counts, one 64-bit atomic each
  __syncthreads();
  if (tid == 0) {
    if (block_unrel) atomicAdd(a.tally + 1, block_unrel);
    // the last block to finish leaves the tile counters at 0 for the next
    // launch: every block has asked for its last tile by now
    __threadfence();
    if (atomicAdd(a.sched + 1, 1u) == gridDim.x - 1) {
      a.sched[0] = 0;
      a.sched[1] = 0;
    }
  }
  if (counting && tid < N_EDGES) {
    unsigned long long below = 0;
    for (int b = tid + 1; b <= N_EDGES; ++b) below += hist[b];
    if (below) atomicAdd(a.tally + 2 + tid, below);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

// The blocks of K8 that one SM of the current device holds at once.
int fw_univar_extract_blocks_per_sm(int* per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, mi_univar_extract_kernel, THREADS, 0);
}

// Launches K8 on `stream` for one (t, q) block and returns the
// cudaError_t of the launch (0 on success).  front 0 (MI): stat float64,
// df and nobs int32; front 1 (GIVEN): logp and stat float64; suff uint8,
// (t, q) or one value where suff_all; lg: (max_df / 2, 2) float64 (front
// MI); edges: N_EDGES float64 strictly decreasing, or null (no counts);
// tally: TALLY uint64 accumulated over a sweep's launches; sched: 2
// uint32, 0 before the first launch, which each launch leaves at 0; X, Y
// int32 and lp, st float64, each `cap` slots.  grid: the blocks the card
// holds at once (fw_univar_extract_blocks_per_sm times its SMs); at most
// one a tile is launched.
int fw_univar_extract(int front, const void* stat, const void* logp,
                      const void* df, const void* nobs, const void* suff,
                      int suff_all, int t, int q, int s, int y0,
                      double thresh, int reliable, int max_df, const void* lg,
                      const void* edges, long long cap, void* tally,
                      void* sched, void* X, void* Y, void* lp, void* st,
                      int grid, void* stream) {
  if ((front != FRONT_MI && front != FRONT_GIVEN) || t <= 0 || q <= 0 ||
      cap < 0 || grid <= 0 || max_df < 0 || max_df > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_row = (q + TILE - 1) / TILE;
  const long long tiles = (long long)t * tiles_row;
  if (tiles + grid >= (1ll << 32)) return (int)cudaErrorInvalidValue;
  const int vec = q % VEC == 0 && aligned(stat, 16) && aligned(logp, 16) &&
                  aligned(df, 16) && aligned(nobs, 16) &&
                  (suff_all || aligned(suff, 4));
  const unsigned blocks = (unsigned)(tiles < grid ? tiles : grid);
  Args a{front,
         static_cast<const double*>(stat),
         static_cast<const double*>(logp),
         static_cast<const int*>(df),
         static_cast<const int*>(nobs),
         static_cast<const uint8_t*>(suff),
         suff_all,
         vec,
         q,
         s,
         y0,
         (unsigned)tiles,
         tiles_row,
         thresh,
         reliable,
         max_df,
         static_cast<const double*>(lg),
         static_cast<const double*>(edges),
         cap,
         static_cast<unsigned long long*>(tally),
         static_cast<unsigned*>(sched),
         static_cast<int*>(X),
         static_cast<int*>(Y),
         static_cast<double*>(lp),
         static_cast<double*>(st)};
  mi_univar_extract_kernel<<<blocks, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
