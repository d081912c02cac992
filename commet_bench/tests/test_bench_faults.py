"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced, half of a batch left out, a build
that leaves its state unchanged. (The cells take one chip, so there is no
exchange between chips to leave out.)"""

import pytest
import torch

from commet_bench import harness
from commet_bench.tests.tiny import SEED, TINY


def flip_first(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        flat = out.reshape(-1)
        flat[0] = (~flat[0].bool()).to(flat.dtype) if flat.dtype == \
            torch.bool else 2 - flat[0]
        return out
    return broken


def half_left_out(fn):
    def broken(*args, **kwargs):
        out = fn(*args, **kwargs).clone()
        out[..., out.shape[-1] // 2:] = 0
        return out
    return broken


def unchanged(fn):
    def broken(planes, *args, **kwargs):
        return planes
    return broken


CASES = [
    ("partition-search", "probe_planes", flip_first),
    ("partition-search", "probe_planes", half_left_out),
    ("partition-build", "build_planes", unchanged),
    ("partition-search", "build_planes", unchanged),
]


@pytest.mark.parametrize("cell,where,fault", CASES)
def test_fault_is_caught(cell, where, fault, monkeypatch):
    from commet_tpu_torch.core import planes
    monkeypatch.setattr(planes, where, fault(getattr(planes, where)))
    r = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                         overrides=TINY[cell])
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
