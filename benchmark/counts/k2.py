"""K2, the masked Pearson moments of the fz_nz pass
(``csrc/fz_nz_stats.cu``).

Operations, counted from the table's joint nonzeros: a pair X < Y needs
its six moments over the rows where both variables are nonzero, and
nothing from the other rows.  On each such row: N += 1, Sx += x,
Sy += y, Sxx += x^2, Syy += y^2 (the squares taken once a value, n p in
all, not once a pair) and Sxy += x y: 5 additions and a multiply-add, 7
float64 operations.  The rows both variables of a pair share, summed
over the pairs, are J = sum over the rows of C(k_r, 2), k_r the row's
nonzeros: each row counts once for every pair of its nonzero variables.
So 7 J + n p operations, at the float64 tensor-core peak (the highest
float64 rate the card has, so the count never reads above what any
kernel could do).
Bytes: the float64 table read once, 8 n p; each pair's r (float64) and N
(int32) written once, 12 bytes a pair."""

import numpy as np

KERNEL = "fz_nz_stats_kernel"
COUNTER = "fz_nz_stats"


def joint_nonzeros(table: np.ndarray) -> int:
    k = np.count_nonzero(table, axis=1).astype(np.int64)
    return int((k * (k - 1) // 2).sum())


def work(facts: dict) -> dict:
    n, p = facts["n"], facts["p"]
    pairs = p * (p - 1) // 2
    J = joint_nonzeros(facts["table"])
    return {"ops": 7.0 * J + n * p, "peak": "fp64_flops_per_s",
            "bytes": float(8 * n * p + 12 * pairs)}
