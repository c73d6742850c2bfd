"""On the card (``python -m pytest benchmark/tests -m card``): both cells'
runs through the hand kernels at a small size, correct, with the kernels
each cell's counts read launched and in the trace."""

import pytest

from benchmark.harness import run_cell
from helpers import tiny


@pytest.mark.card
@pytest.mark.parametrize("name,kernels", [
    ("otu98k-n8k.hef-k0", ("mi_univar_stats", "univar_extract")),
    ("otu65k.hes-k0", ("fz_nz_stats", "univar_extract"))])
def test_cell_on_the_card(card, name, kernels):
    cell = tiny(name, samples=2048, otus=4096)
    out = run_cell(cell, 2**31 + 9, 1.0, True, card, 0.0)
    run = out["_run"]
    assert out["correct"], out["checks"]
    for k in kernels:
        assert run.counters[k] > 0
    assert out["device"]["busy_s"] > 0
    assert all(v["value"] <= 105 for k, v in out["metrics"].items()
               if k.endswith("_roofline_pct"))
