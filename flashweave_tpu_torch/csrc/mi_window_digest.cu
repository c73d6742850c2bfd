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
// then _digest_reduce), which the eager route ran as some 15 launches for
// each k up to max_df / 2 (~800 a call at max_df = 108).
//
// Inputs: per test (stat float64, df int64, n_obs float64, suff bool) of B
// tests in NC contiguous segments, `counts` (NC,) int64 and their running
// sums `ends`.  Output (3, NC) float64 [exit_e, wstat, exp(M)]: exit_e the
// first local index whose log p is not below log alpha (-1: none), M the
// largest significant log p (-inf: none), wstat the stat at the last local
// index attaining it (at the segment's first test without one).  A test
// whose power check failed has log p 0.
//
// What bounds it on this card: the float64 transcendentals.  A test of df d
// runs d / 2 steps of the logsumexp chain, each two exp and a log (libdevice
// calls) and six other float64 operations, while it reads 25 bytes; at the
// headline's max_df = 108 a test runs up to 54 steps.  What a libdevice
// call costs in instructions is not measured, so the operation bound is
// known only as a floor, each call counted as one operation
// (chip_smoke.py's logp_fp64_ops).
//
// What the design does about it:
// - one warp a segment, four segments a block; lanes take the segment's
//   tests 32 at a time, each test running its chain only to its own df
//   (csrc/mi_digest.cuh's mi_logp: the plain chain's operations in its
//   order, explicitly rounded, so its log p is the plain version's bit for
//   bit);
// - each lane keeps its running (first exit, largest log p, last index
//   attaining it), merged over the warp with shuffles: compare and select
//   only, so the digest is the plain version's bit for bit;
// - one launch a call, and nothing of a test reaches device memory; the
//   lgamma offsets come up once for each max_df (ops/kernels.py caches the
//   table).

#include <cuda_runtime.h>
#include <stdint.h>

#include "mi_digest.cuh"

namespace {

constexpr int WARPS = 4;              // segments a block, one warp each

struct Args {
  const double* stat;
  const long long* df;
  const double* nobs;
  const uint8_t* suff;
  const long long* counts;            // (NC,)
  const long long* ends;              // (NC,) running sums of counts
  long long B;
  int NC, max_df;
  double log_alpha;
  const double* lg;                   // (max_df / 2, 2) lgamma offsets
  double* out;                        // (3, NC)
};

__global__ void __launch_bounds__(WARPS * 32)
mi_window_digest_kernel(Args a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * WARPS + warp;
  if (c >= a.NC) return;                       // whole warps only
  const long long cnt = a.counts[c];
  const long long offs = a.ends[c] - cnt;
  fw_digest::Best b = fw_digest::best_init();
  for (long long j = lane; j < cnt; j += 32) {
    const long long t = offs + j;
    const double logp =
        a.suff[t] ? fw_digest::mi_logp(a.stat[t], a.df[t], a.nobs[t],
                                       a.max_df, a.lg)
                  : 0.0;
    fw_digest::best_add(b, (int)j, logp, a.log_alpha);
  }
  b = fw_digest::best_warp(b);
  if (lane != 0) return;
  // the plain version's clamp of the weakest test's place into the batch
  const long long at = min(offs + max(b.w, 0), a.B - 1);
  a.out[c] = b.exit == INT_MAX ? -1.0 : (double)b.exit;
  a.out[a.NC + c] = a.stat[at];
  a.out[2 * (long long)a.NC + c] = exp(b.M);
}

}  // namespace

extern "C" {

// Launches K6 on `stream` and returns the cudaError_t of the launch (0 on
// success).  stat, nobs: float64, df: int64, suff: uint8, each (B,);
// counts, ends: (NC,) int64 with ends[NC - 1] == B; lg: (max_df / 2, 2)
// float64; out: (3, NC) float64.
int fw_mi_window_digest(const void* stat, const void* df, const void* nobs,
                        const void* suff, const void* counts, const void* ends, long long B,
                        int NC, int max_df, double log_alpha, const void* lg,
                        void* out, void* stream) {
  if (B <= 0 || NC <= 0 || max_df < 0) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const double*>(stat), static_cast<const long long*>(df),
         static_cast<const double*>(nobs), static_cast<const uint8_t*>(suff),
         static_cast<const long long*>(counts),
         static_cast<const long long*>(ends), B, NC, max_df, log_alpha,
         static_cast<const double*>(lg), static_cast<double*>(out)};
  const int blocks = (NC + WARPS - 1) / WARPS;
  mi_window_digest_kernel<<<blocks, WARPS * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
