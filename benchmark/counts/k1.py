"""K1, the fused univariate G-test of the mi / mi_nz pass
(``csrc/mi_univar_stats.cu``), for tables of 2 to 4 levels.

Operations: each pair X < Y needs the joint counts of its levels 1 .. L-1,
(L - 1)^2 of them, each a sum over the n samples of a product of two 0/1
indicators: 2 (L - 1)^2 n int8 operations a pair, at the int8 tensor-core
peak.  (Level 0's cells follow from the variables' counts.)
Bytes: the int8 table read once, n p; each pair's outputs written once:
its statistic (float64), df and n_obs (int32 each) and its power flag
(1 byte), 17 bytes.  The float64 epilogue a pair is not counted: it is
small beside the counts."""

KERNEL = "mi_univar_stats_kernel"
COUNTER = "mi_univar_stats"


def work(facts: dict) -> dict:
    n, p, L = facts["n"], facts["p"], facts["levels"]
    pairs = p * (p - 1) // 2
    return {"ops": 2.0 * (L - 1) ** 2 * n * pairs, "peak": "int8_ops_per_s",
            "bytes": float(n * p + 17 * pairs)}
