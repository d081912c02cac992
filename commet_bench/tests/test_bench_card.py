"""A tiny run of each traffic kind on the card (skips where there is
none): python -m pytest --noconftest -p no:cacheprovider -m gpu
commet_bench/tests/test_bench_card.py"""

import pytest
import torch

from commet_bench import harness
from commet_bench.tests.tiny import CELLS, SEED, TINY


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_on_card(card, cell):
    r = harness.run_cell(cell, SEED, 0.3, True, device="cuda",
                         overrides=TINY[cell])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
