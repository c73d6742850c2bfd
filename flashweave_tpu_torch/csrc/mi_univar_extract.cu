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
// fw_digest::mi_logp (csrc/mi_digest.cuh: statfuns.mi_logpval_smalldf bit
// for bit); front GIVEN reads (log p float64, stat float64, suff bool)
// that the plain Fisher-z chain computed (suff one value for the whole
// block where `suff_all`).  Per pair, the plain version's rules: a pair
// only where X < Y; unreliable where not suff or log p is NaN, then log p
// +inf (`reliable`, correct_reliable_only) or 0; a candidate where log p <
// thresh.  Outputs, accumulated over the launches of a sweep:
// tally[0] the candidates so far (the cursor), tally[1] the unreliable
// pairs, tally[2 + j] the candidates with log p < edges[j] (only with
// `edges`); each candidate's (X int32, Y int32, log p float64, stat
// float64) at its cursor slot, where the slot is below `cap` (the cursor
// counts on past it, so the caller sees the total and refuses or sweeps
// again).  Candidates land in no fixed order; the caller's sort and BH
// depend only on their values.
//
// What bounds it on this card: device memory or the float64 pipe.  A pair
// reads its power flag (one byte, or none where one flag serves the
// block); front MI reads a pair's stat, df and n_obs (16 bytes) only where
// it has power, and there runs its log p chain: at the headline's df <= 4
// an erfc or a logsumexp step, a few hundred float64 operations; front
// GIVEN reads the log p (8 bytes) where it has power and the stat only of
// a candidate.  A candidate (about 1% of the pairs at alpha = 0.01) writes
// 24 bytes.
//
// What the design does about it:
// - a block walks chunks of CHUNK consecutive pairs of one row (a grid of
//   as many blocks as the SMs hold at once strides over the chunks),
//   ITEMS pairs a thread at stride THREADS, so every load is coalesced and
//   X is one value a chunk;
// - the log p chain runs only for the pairs with power (the others are
//   unreliable whatever their log p), the loads of stat, df and n_obs only
//   there; elsewhere a candidate alone loads its stat;
// - the candidates of a chunk take their slots with one global atomic a
//   block: a warp's count from its ballots, the warps' counts scanned in
//   shared memory; a lane's slot is its warp's base plus the candidates of
//   the lanes and items before it;
// - a candidate's bin is the number of edges its log p is below, by
//   float64 comparisons against the edges in shared memory (the edges
//   strictly decrease, which the wrapper checks, so the candidate is below
//   exactly edges 0..bin-1); bins go to a shared histogram, and at the end
//   each edge's count (the candidates in the bins past it) to the global
//   tally with one 64-bit atomic, as does the block's unreliable count.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mi_digest.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 4;                 // pairs a thread a chunk
constexpr int CHUNK = THREADS * ITEMS;   // consecutive pairs of a row
constexpr int N_EDGES = 48;              // ops/univariate.py:N_EXTRACT_BINS
constexpr int TALLY = 2 + N_EDGES;       // cursor, unreliable, edge counts
constexpr int FRONT_MI = 0;
constexpr int FRONT_GIVEN = 1;

struct Args {
  int front;
  const double* stat;      // (t, q)
  const double* logp;      // (t, q), front GIVEN
  const int* df;           // (t, q), front MI
  const int* nobs;         // (t, q), front MI
  const uint8_t* suff;     // (t, q), or one value where suff_all
  int suff_all;
  int q;
  int s, y0;
  long long chunks;        // t * chunks_row
  int chunks_row;
  double thresh;
  int reliable;
  int max_df;
  const double* lg;        // (max_df / 2, 2), front MI
  const double* edges;     // (N_EDGES,) strictly decreasing, or null
  long long cap;
  unsigned long long* tally;  // (TALLY,)
  int* X;
  int* Y;
  double* lp;
  double* st;
};

__global__ void __launch_bounds__(THREADS)
    mi_univar_extract_kernel(const Args a) {
  __shared__ double edges[N_EDGES];
  __shared__ unsigned hist[N_EDGES + 1];
  __shared__ unsigned warp_n[WARPS];
  __shared__ unsigned long long warp_base[WARPS];
  __shared__ unsigned long long block_unrel;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool counting = a.edges != nullptr;
  if (counting) {
    if (tid < N_EDGES) edges[tid] = a.edges[tid];
    if (tid <= N_EDGES) hist[tid] = 0;
  }
  if (tid == 0) block_unrel = 0;
  __syncthreads();
  const unsigned lanes_before = (1u << lane) - 1u;
  unsigned unrel = 0;
  for (long long c = blockIdx.x; c < a.chunks; c += gridDim.x) {
    const int row = (int)(c / a.chunks_row);
    const int col0 = (int)(c % a.chunks_row) * CHUNK;
    const int x = a.s + row;
    const long long base = (long long)row * a.q;
    double lp[ITEMS], st[ITEMS];
    unsigned mask[ITEMS];
    unsigned n = 0;
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int col = col0 + k * THREADS + tid;
      bool cand = false;
      lp[k] = INFINITY;
      st[k] = 0.0;
      if (col < a.q && x < a.y0 + col) {
        const long long e = base + col;
        const bool suff = a.suff[a.suff_all ? 0 : e] != 0;
        const bool read = suff && a.front == FRONT_MI;
        double v = NAN;
        if (read) {
          st[k] = a.stat[e];
          v = fw_digest::mi_logp(st[k], a.df[e], (double)a.nobs[e],
                                 a.max_df, a.lg);
        } else if (suff) {
          v = a.logp[e];
        }
        if (!suff || isnan(v)) {
          ++unrel;
          v = a.reliable ? INFINITY : 0.0;
        }
        lp[k] = v;
        cand = v < a.thresh;
        if (cand && !read) st[k] = a.stat[e];
      }
      mask[k] = __ballot_sync(fw_digest::FULL, cand);
      n += __popc(mask[k]);
    }
    // one global atomic a chunk: the warps' counts scanned in shared memory
    if (lane == 0) warp_n[warp] = n;
    __syncthreads();
    if (tid == 0) {
      unsigned long long total = 0;
      for (int w = 0; w < WARPS; ++w) {
        warp_base[w] = total;
        total += warp_n[w];
      }
      const unsigned long long at =
          total ? atomicAdd(a.tally, total) : 0ull;
      for (int w = 0; w < WARPS; ++w) warp_base[w] += at;
    }
    __syncthreads();
    if (n) {
      unsigned long long slot = warp_base[warp];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) {
        if (mask[k] >> lane & 1u) {
          const unsigned long long at = slot + __popc(mask[k] & lanes_before);
          if (at < (unsigned long long)a.cap) {
            a.X[at] = x;
            a.Y[at] = a.y0 + col0 + k * THREADS + tid;
            a.lp[at] = lp[k];
            a.st[at] = st[k];
          }
          if (counting) {
            int bin = 0;
#pragma unroll 8
            for (int j = 0; j < N_EDGES; ++j) bin += lp[k] < edges[j];
            atomicAdd(&hist[bin], 1u);
          }
        }
        slot += __popc(mask[k]);
      }
    }
  }
  // the block's unreliable pairs and edge counts, one 64-bit atomic each
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    unrel += __shfl_xor_sync(fw_digest::FULL, unrel, o);
  if (lane == 0 && unrel) atomicAdd(&block_unrel, (unsigned long long)unrel);
  __syncthreads();
  if (tid == 0 && block_unrel) atomicAdd(a.tally + 1, block_unrel);
  if (counting && tid < N_EDGES) {
    unsigned long long below = 0;
    for (int b = tid + 1; b <= N_EDGES; ++b) below += hist[b];
    if (below) atomicAdd(a.tally + 2 + tid, below);
  }
}

}  // namespace

extern "C" {

// Launches K8 on `stream` for one (t, q) block and returns the
// cudaError_t of the launch (0 on success).  front 0 (MI): stat float64,
// df and nobs int32; front 1 (GIVEN): logp and stat float64; suff uint8,
// (t, q) or one value where suff_all; lg: (max_df / 2, 2) float64 (front
// MI); edges: N_EDGES float64 strictly decreasing, or null (no counts);
// tally: TALLY uint64 accumulated over a sweep's launches; X, Y int32 and
// lp, st float64, each `cap` slots.  sms: the card's SMs; the grid is as
// many blocks as fit on them at once (at most one a chunk).
int fw_univar_extract(int front, const void* stat, const void* logp,
                      const void* df, const void* nobs, const void* suff,
                      int suff_all, int t, int q, int s, int y0,
                      double thresh, int reliable, int max_df, const void* lg,
                      const void* edges, long long cap, void* tally, void* X,
                      void* Y, void* lp, void* st, int sms, void* stream) {
  if ((front != FRONT_MI && front != FRONT_GIVEN) || t <= 0 || q <= 0 ||
      cap < 0 || sms <= 0 || max_df < 0)
    return (int)cudaErrorInvalidValue;
  const int chunks_row = (q + CHUNK - 1) / CHUNK;
  const long long chunks = (long long)t * chunks_row;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, mi_univar_extract_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const long long grid_max = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(chunks < grid_max ? chunks : grid_max);
  Args a{front,
         static_cast<const double*>(stat),
         static_cast<const double*>(logp),
         static_cast<const int*>(df),
         static_cast<const int*>(nobs),
         static_cast<const uint8_t*>(suff),
         suff_all,
         q,
         s,
         y0,
         chunks,
         chunks_row,
         thresh,
         reliable,
         max_df,
         static_cast<const double*>(lg),
         static_cast<const double*>(edges),
         cap,
         static_cast<unsigned long long*>(tally),
         static_cast<int*>(X),
         static_cast<int*>(Y),
         static_cast<double*>(lp),
         static_cast<double*>(st)};
  mi_univar_extract_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
