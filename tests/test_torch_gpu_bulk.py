"""Card-only tests of the bulk plane build (K9): the kernels of
csrc/planes.cu behind bulk_histogram, bulk_scatter and bulk_apply against
their plain PyTorch versions on the card, BulkChunk against the per-batch
build and bulk_build_planes_plain, and the engine's bulk route
(COMMET_TPU_BULK_BUILD=force, small COMMET_TPU_BULK_CHUNK) against its
per-batch route. Each skips without a CUDA card; exact equality throughout
(a bin's entries are compared as a set: the kernel appends them in the
order its atomics land). Imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_bulk.py
"""

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import planes
from commet_tpu_torch.engine import engine as tengine
from test_torch_gpu import _pack
from torch_helpers import encode, random_seqs, read_set, write_fasta


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _batches(rng, k, device):
    """Dirty and clean batches of reads shorter than k, 100 and 300 bp
    long, with Ns, on the card: (codes2, aux, clean, length) each."""
    out = []
    for n_frac in (0.01, 0.0, 0.02):
        seqs = random_seqs(rng, 700, 1, 300, n_frac=n_frac)
        codes = encode(seqs, lpad=320)
        clean = n_frac == 0.0
        c2, aux = (x.to(device) for x in _pack(codes, clean))
        out.append((c2, aux, clean, 320))
    return out


def _sorted_bins(bins, offsets):
    """Each entry keyed by its bin, sorted: the bins as sets."""
    n = offsets[1:] - offsets[:-1]
    b = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    return torch.sort(b * (1 << 32) + bins[:b.numel()].to(torch.int64)).values


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 15, 21, 31, 33])
def test_bulk_kernels_match_plain_on_card(cuda_device, k):
    """Per batch the histogram kernel gives the plain counts; the scatter
    kernel fills each bin with the plain version's entries and ends every
    cursor at the next bin's offset; the apply kernel sets the plain
    version's bits on a set already holding bits; a BulkChunk over the
    three batches equals the per-batch kernel build and
    bulk_build_planes_plain. Each wrapper counts its launches."""
    rng = np.random.default_rng(80 + k)
    batches = _batches(rng, k, cuda_device)
    _sb, _sw, ns = planes.bulk_layout(k)
    counts = torch.zeros(4 * ns, dtype=torch.int64, device=cuda_device)
    launched = [fn.launches for fn in (planes.bulk_histogram,
                                       planes.bulk_scatter,
                                       planes.bulk_apply)]
    for bt in batches:
        before = counts.clone()
        planes.bulk_histogram(counts, *bt, k)
        assert torch.equal(counts - before, planes.bulk_histogram_plain(*bt,
                                                                        k))
    offsets = torch.zeros(4 * ns + 1, dtype=torch.int64, device=cuda_device)
    offsets[1:] = torch.cumsum(counts, 0)
    slots = sum(planes.bulk_slots(bt[0], bt[3], k) for bt in batches)
    got_bins = torch.full((4 * slots,), -1, dtype=torch.int32,
                          device=cuda_device)
    want_bins = got_bins.clone()
    got_cur, want_cur = offsets[:-1].clone(), offsets[:-1].clone()
    for bt in batches:
        planes.bulk_scatter(got_bins, got_cur, *bt, k)
        planes.bulk_scatter_plain(want_bins, want_cur, *bt, k)
    torch.cuda.synchronize()
    assert torch.equal(got_cur, offsets[1:])
    assert torch.equal(want_cur, offsets[1:])
    assert torch.equal(_sorted_bins(got_bins, offsets),
                       _sorted_bins(want_bins, offsets))
    base = planes.alloc_planes(k, cuda_device)
    planes.build_planes(base, *batches[0], k)  # bits already set
    got = planes.bulk_apply(base.clone(), got_bins, offsets, k)
    want = planes.bulk_apply_plain(base.clone(), got_bins, offsets, k)
    assert torch.equal(got, want)
    per_batch = planes.alloc_planes(k, cuda_device)
    for bt in batches:
        planes.build_planes(per_batch, *bt, k)
    assert torch.equal(got, per_batch)
    bulk = planes.bulk_build_planes(planes.alloc_planes(k, cuda_device),
                                    batches, k)
    plain = planes.bulk_build_planes_plain(
        planes.alloc_planes(k, cuda_device), batches, k)
    torch.cuda.synchronize()
    assert torch.equal(bulk, per_batch) and torch.equal(plain, per_batch)
    assert [fn.launches - n for fn, n in zip(
        (planes.bulk_histogram, planes.bulk_scatter, planes.bulk_apply),
        launched)] == [6, 6, 2]


@pytest.mark.gpu
def test_bulk_engine_cuda_matches_per_batch(tmp_path, monkeypatch,
                                            cuda_device):
    """The engine on the card with COMMET_TPU_BULK_BUILD=force and chunks
    of 20,000 window slots (many flushes, a smaller last chunk) builds the
    planes of COMMET_TPU_BULK_BUILD=0, launching the bulk kernels and not
    the per-batch one; and the card's default takes CARD_BULK_BUILD's
    route."""
    rng = np.random.default_rng(90)
    path = str(tmp_path / "i.fa")
    write_fasta(path, random_seqs(rng, 3000, 20, 150, n_frac=0.01))
    rs = read_set("I", path)
    enc = tengine.EncodedSet(rs)
    monkeypatch.setenv("COMMET_TPU_BUILD_BATCH", "256")
    monkeypatch.setenv("COMMET_TPU_BULK_CHUNK", "20000")
    got = {}
    for mode in ("force", "0", None):
        if mode is None:
            monkeypatch.delenv("COMMET_TPU_BULK_BUILD")
        else:
            monkeypatch.setenv("COMMET_TPU_BULK_BUILD", mode)
        planes.build_planes.launches = planes.bulk_apply.launches = 0
        eng = tengine.Engine(k=21, t=2, device=cuda_device)
        got[mode] = eng.build_planes(enc, rs.eligible())
        torch.cuda.synchronize()
        bulk = mode == "force" or (mode is None and tengine.CARD_BULK_BUILD)
        assert eng.uses_bulk_build() == bulk
        assert (planes.bulk_apply.launches > 2) == bulk
        assert (planes.build_planes.launches > 0) == (not bulk)
    assert torch.equal(got["force"], got["0"])
    assert torch.equal(got[None], got["0"])


@pytest.mark.gpu
def test_bulk_kernels_reject_bad_inputs(cuda_device):
    """The wrappers raise on counts, cursors, offsets or bins of the wrong
    type, size or device, before launching."""
    k = 15
    rng = np.random.default_rng(91)
    c2, aux, clean, length = _batches(rng, k, cuda_device)[0]
    _sb, _sw, ns = planes.bulk_layout(k)
    good = torch.zeros(4 * ns, dtype=torch.int64, device=cuda_device)
    bins = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    pl = planes.alloc_planes(k, cuda_device)
    offsets = torch.zeros(4 * ns + 1, dtype=torch.int64, device=cuda_device)
    launched = planes.bulk_histogram.launches
    for bad in (good.to(torch.int32), good[:-1], good.cpu()):
        with pytest.raises(ValueError):
            planes.bulk_histogram(bad, c2, aux, clean, length, k)
        with pytest.raises(ValueError):
            planes.bulk_scatter(bins, bad, c2, aux, clean, length, k)
    with pytest.raises(ValueError):
        planes.bulk_scatter(bins.to(torch.int64), good, c2, aux, clean,
                            length, k)
    with pytest.raises(ValueError):
        planes.bulk_apply(pl, bins, offsets[:-1], k)
    with pytest.raises(ValueError):
        planes.bulk_apply(pl[:-1], bins, offsets, k)
    assert planes.bulk_histogram.launches == launched
