// The float64 epilogue of a conditional G-test, run by one warp over the
// test's int32 histogram in shared memory: K5's (csrc/mi_cond_stats.cu),
// which K7 (csrc/mi_turbo_digest.cu) runs for each distinct (candidate,
// subset) pair of a window.
//
// The histogram holds Lr^2 S cells, cell (v, b, s) at v + Lr b + Lr^2 s (v
// the first variable's level less its offset, b the second's, s the
// stratum), followed by room for the row and column margins (2 Lr S ints)
// and the strata (S ints): (Lr + 1)^2 S ints in all.  The epilogue fills
// the margins, then computes the occupied strata, n_obs and the adjusted df
// a stratum, then the MI terms a cell, reduced over the warp with
// shuffles.  The term is the plain version's log((m_k c) / (m_i m_j)) c and
// the flip its mi_neg (n_neg / n) > mi_pos (n_pos / n), with explicitly
// rounded products and sums (__dmul_rn, __dadd_rn), so no multiply-add is
// fused where the plain version rounds twice; only the order of the sums
// differs from ops/statfuns.py:mi_stats.
#pragma once

#include <cuda_runtime.h>

namespace fw_cond {

constexpr unsigned FULL = 0xffffffffu;

struct CondResult {
  double stat;       // signed MI, 0 where the power check fails
  long long df;      // adjusted df, 0 where the power check fails
  double n_obs;
  bool suff;         // n_obs / (lx ly occupied strata) > hps
};

// Every lane of the warp returns the same result.  ox, oy: the nz offsets
// of the diagonal (mode 1; 0 otherwise); lx, ly: the levels of the power
// check (the sliced table's under nz, the variables' own otherwise).
// The histogram must be complete and visible to the warp (__syncwarp).
__device__ __forceinline__ CondResult cond_epilogue(int* hist, int Lr, int S,
                                                    int ox, int oy, double lx,
                                                    double ly, double hps,
                                                    int lane) {
  const int LL = Lr * Lr, LS = Lr * S, C = LL * S;
  int* mi = hist + C;                          // (a, s) at a + Lr s
  int* mj = mi + LS;                           // (b, s) at b + Lr s
  int* mk = mj + LS;                           // s

  // margins: row a of stratum s (over b) and column b of stratum s (over a)
  for (int i = lane; i < LS; i += 32) {
    const int s = i / Lr, v = i - s * Lr;
    const int* h = hist + LL * s;
    int row = 0, col = 0;
    for (int u = 0; u < Lr; ++u) {
      row += h[v + Lr * u];
      col += h[u + Lr * v];
    }
    mi[i] = row;
    mj[i] = col;
  }
  __syncwarp();

  // a stratum's count, occupancy and adjusted df (max(alx,1)-1)(max(aly,1)-1)
  int df = 0, occupied = 0, n_obs = 0;
  for (int s = lane; s < S; s += 32) {
    int m = 0, alx = 0, aly = 0;
    for (int v = 0; v < Lr; ++v) {
      m += mi[v + Lr * s];
      alx += mi[v + Lr * s] != 0;
      aly += mj[v + Lr * s] != 0;
    }
    mk[s] = m;
    df += (max(alx, 1) - 1) * (max(aly, 1) - 1);
    occupied += m > 0;
    n_obs += m;
  }
  __syncwarp();

  // the MI terms of the occupied cells, on and off the diagonal
  double mi_pos = 0.0, mi_neg = 0.0;
  int n_pos = 0;
  for (int c = lane; c < C; c += 32) {
    const int cnt = hist[c];
    if (cnt == 0) continue;           // then no margin of the cell is 0
    const int s = c / LL, r = c - s * LL, b = r / Lr, v = r - b * Lr;
    const double cd = (double)cnt;
    const double ratio = __ddiv_rn(__dmul_rn((double)mk[s], cd),
                                   __dmul_rn((double)mi[v + Lr * s],
                                             (double)mj[b + Lr * s]));
    const double term = __dmul_rn(log(ratio), cd);
    if (v - ox == b - oy) {
      mi_pos = __dadd_rn(mi_pos, term);
      n_pos += cnt;
    } else {
      mi_neg = __dadd_rn(mi_neg, term);
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) {
    mi_pos = __dadd_rn(mi_pos, __shfl_xor_sync(FULL, mi_pos, m));
    mi_neg = __dadd_rn(mi_neg, __shfl_xor_sync(FULL, mi_neg, m));
    n_pos += __shfl_xor_sync(FULL, n_pos, m);
    n_obs += __shfl_xor_sync(FULL, n_obs, m);
    df += __shfl_xor_sync(FULL, df, m);
    occupied += __shfl_xor_sync(FULL, occupied, m);
  }

  const double nd = (double)n_obs, np_ = (double)n_pos;
  const double nn = nd - np_;
  const double safe_n = nd > 0.0 ? nd : 1.0;
  double stat = __ddiv_rn(__dadd_rn(mi_pos, mi_neg), safe_n);
  if (__dmul_rn(mi_neg, __ddiv_rn(nn, safe_n)) >
      __dmul_rn(mi_pos, __ddiv_rn(np_, safe_n)))
    stat = -stat;
  const double cells = __dmul_rn(__dmul_rn(lx, ly), (double)occupied);
  const bool ok = cells > 0.0 ? __ddiv_rn(nd, cells) > hps : true;
  return {ok ? stat : 0.0, ok ? (long long)df : 0, nd, ok};
}

}  // namespace fw_cond
