"""The port's device class counts (core/filter.py class_counts_packed, its
plain PyTorch version on the CPU) and filter_batch_device against
commet_tpu's class_counts_packed (K10) and filter_batch_device, and against
the host filter, on tests/test_filter.py:33-69's reads: N-heavy reads, the
first-empty-read quirk, and its three threshold sets. Counts, keep masks and
statistics: exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import filter as jfilter
from commet_tpu.core import kernels
from commet_tpu.io.reads import CODE_LUT
from commet_tpu_torch.core import filter as tfilter
from commet_tpu_torch.core import keys

LPAD = 128
THRESHOLDS = ({"min_size": 30, "min_shannon": 1.9},
              {"max_n": 2, "min_shannon": 1.2, "max_reads": 120},
              {"min_shannon": 1.99999})


def _reads():
    """test_filter.py's 300 reads of 20-119 bases over ACGTN (both cases),
    every seventh N-heavy, read 250 empty; packed to LPAD positions."""
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGTNacgtn", dtype=np.uint8)
    seqs = []
    for i in range(300):
        ln = int(rng.integers(20, 120))
        p = np.full(10, 0.092)
        p[4] = p[9] = 0.04 + (0.3 if i % 7 == 0 else 0)
        seqs.append(bytes(rng.choice(bases, size=ln, p=p / p.sum())))
    seqs[250] = b""
    codes = np.full((len(seqs), LPAD), kernels.INVALID_CODE, dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = CODE_LUT[np.frombuffer(s, dtype=np.uint8)]
    lengths = np.array([len(s) for s in seqs], dtype=np.int64)
    c2, vd = kernels.pack_codes_np(codes)
    return seqs, c2, vd, lengths


def test_class_counts_match_jax():
    """class_counts_packed on CPU tensors equals commet_tpu's
    class_counts_packed, at the padded length and at a shorter one (the
    positions past it are not counted; other = length - ACGT)."""
    _seqs, c2, vd, lengths = _reads()
    for length in (LPAD, 100):
        want = np.asarray(kernels.class_counts_packed(
            jnp.asarray(c2), jnp.asarray(vd),
            jnp.asarray(lengths.astype(np.int32)), length))
        got = tfilter.class_counts_packed(
            keys.host_u32(c2), keys.host_u32(vd),
            torch.from_numpy(lengths.astype(np.int32)), length)
        assert got.dtype == torch.int32 and got.shape == (300, 5)
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(want[:, 4].sum()) > 0


@pytest.mark.parametrize("kw", THRESHOLDS)
def test_filter_batch_device_matches_jax_and_host(kw):
    """filter_batch_device(..., device="cpu") gives commet_tpu's
    filter_batch_device keep mask and statistics, and the host filter's."""
    seqs, c2, vd, lengths = _reads()
    keep, stats = tfilter.filter_batch_device(c2, vd, lengths, LPAD,
                                              device="cpu", **kw)
    keep_j, stats_j = jfilter.filter_batch_device(c2, vd, lengths, LPAD,
                                                  **kw)
    keep_h, stats_h = tfilter.filter_reads(seqs, **kw)
    np.testing.assert_array_equal(keep, keep_j)
    np.testing.assert_array_equal(keep, keep_h)
    assert stats == stats_j == stats_h
    assert 0 < stats["nb_selected"] < len(seqs)
