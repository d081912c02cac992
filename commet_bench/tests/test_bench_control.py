"""The control (the reference in the program's place with one guarantee
broken), run through the benchmark's own run and check, comes out not
correct in every cell, here at a tiny size; on the card it runs at the
cells' own sizes with commet_bench/control.py."""

import pytest

from commet_bench import harness
from commet_bench.tests.tiny import CELLS, SEED, TINY


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    r = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                         overrides=TINY[cell], control=True)
    assert not r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == r["attempted"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
