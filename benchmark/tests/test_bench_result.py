"""The result's last line: its keys in order, the compared numbers last,
and each beside its limit at the end of standard error."""

import json

from benchmark.harness import report, run_cell
from helpers import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_last_line(capsys):
    cell = tiny("otu98k-n8k.hef-k0")
    out = run_cell(cell, 2**31 + 5, 0.2, False, "cpu", 0.0)
    report(out)
    std = capsys.readouterr()
    line = json.loads(std.out.strip().splitlines()[-1])
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2 and line["attempted"] % 2 == 0  # rounds
    assert set(line["metrics"]) == {"network_s", "setup_s"}   # no card: no peak
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"edge_diff": {"value": 0, "limit": 0},
                              "weight_gap": line["checks"]["weight_gap"]}
    err = std.err.strip().splitlines()
    assert err[-2].startswith("check edge_diff 0 limit 0")
    assert err[-1].startswith("check weight_gap")


def test_traced_line(capsys):
    cell = tiny("otu65k.hes-k0")
    out = run_cell(cell, 11, 0.2, True, "cpu", 0.0)
    report(out)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert line["device"]["window_s"] > 0
    # per-layer metrics only; the host spans are there on the CPU too
    assert {"prepare_s", "univariate_s", "postprocess_s",
            "uv_fill_s"} <= set(line["metrics"])
    assert "network_s" not in line["metrics"]
