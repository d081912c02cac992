"""The plain reference agrees with the program's CPU path at a tiny size,
and its window keys with a read's bases taken one by one."""

import numpy as np
import pytest
import torch

from commet_bench import harness
from commet_bench.reference import commet_ref
from commet_bench.tests.tiny import CELLS, SEED, TINY


@pytest.mark.parametrize("cell", CELLS)
def test_cell_correct_on_cpu(cell):
    r = harness.run_cell(cell, SEED, 0.3, False, device="cpu",
                         overrides=TINY[cell])
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


def _key(bases, bit):
    return sum(bit(b) << (len(bases) - 1 - i) for i, b in enumerate(bases))


def test_window_keys_base_by_base():
    rng = np.random.default_rng(SEED)
    codes = rng.integers(0, 5, (6, 40)).astype(np.int64)
    k = 9
    wk = commet_ref.window_keys(torch.from_numpy(codes), k)
    for r in range(6):
        for w in range(40 - k + 1):
            win = list(codes[r, w:w + k])
            assert bool(wk["ok"][r, w]) == all(c < 4 for c in win)
            if not wk["ok"][r, w]:
                continue
            rc = [3 - c for c in reversed(win)]
            assert wk["fa"][r, w] == _key(win, lambda c: c >> 1)
            assert wk["fb"][r, w] == _key(win, lambda c: c & 1)
            assert wk["ra"][r, w] == _key(rc, lambda c: c >> 1)
            assert wk["rb"][r, w] == _key(rc, lambda c: c & 1)


def test_greedy_and_partitions():
    member = torch.tensor([[1, 0, 1, 1, 0, 0, 0, 1],
                           [1, 1, 1, 0, 0, 0, 0, 0]], dtype=torch.bool)
    # k = 3: row 0 counts windows 0, 3 and 7; row 1 window 0 only
    assert commet_ref.greedy_tagged(member, 3, 3).tolist() == [True, False]
    assert commet_ref.greedy_tagged(member, 3, 2).tolist() == [True, False]
    parts = commet_ref.partitions(np.array([5, 5, 5, 5, 5, 5]), 10)
    # reads 0, 1 indexed; read 2 reaches the cap and is dropped; and so on
    assert [p.tolist() for p in parts] == [[0, 1], [3, 4]]


def test_packed_layout():
    planes = commet_ref.BytePlanes(8, "cpu")
    planes.sets[1, 13] = 1
    packed = planes.packed()
    assert packed.numel() == 4 * 32
    assert packed[32 + 1].item() == 1 << 5 and int(packed.sum()) == 32


def test_partitions_as_the_program_cuts_them():
    from commet_tpu_torch.engine.engine import Engine
    rng = np.random.default_rng(SEED)
    counts = rng.integers(0, 70, 5000)
    for cap in (1, 69, 500, 4000, 10**9):
        eng = Engine(k=21, t=2, device="cpu", max_kmer=cap)
        want = [p.tolist() for p in eng.partitions(counts)]
        got = [p.tolist() for p in commet_ref.partitions(counts, cap)]
        assert got == want, cap
