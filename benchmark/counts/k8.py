"""K8, the univariate extraction sweep (``csrc/mi_univar_extract.cu``):
one launch a block of every mode's univariate pass, turning the block's
statistics into log p-values, counting them under the BH edges and
keeping the candidates below alpha.

Bytes only (the log p chains are not counted: an exact chain cheaper
than the one K8 runs would read above 100%): each pair X < Y reads its
power flag (1 byte); a pair with power reads what its log p needs: front
"mi" (mi, mi_nz) its statistic (float64), df and n_obs (int32 each), 16
bytes, front "given" (fz, fz_nz) its log p (float64), 8; a candidate
(a reliable pair below alpha) reads its statistic (front "given"; front
"mi" read it already) and writes its X, Y (int32 each), log p and
statistic (float64 each), 24 bytes.  The tally (50 int64) is read and
written once a sweep.  Counted from the reference's pairs with power and
candidates."""

KERNEL = "mi_univar_extract_kernel"
COUNTER = "univar_extract"

MI_TESTS = ("mi", "mi_nz")


def work(facts: dict) -> dict:
    ref = facts["reference"]
    mi = facts["test"] in MI_TESTS
    nbytes = (ref["pairs"] + (16 if mi else 8) * ref["powered"]
              + (24 if mi else 32) * ref["candidates"] + 2 * 8 * 50)
    return {"ops": 0.0, "peak": None, "bytes": float(nbytes)}
