"""Card-only tests of the bulk plane build (K9): the kernels of
csrc/planes.cu behind bulk_histogram, bulk_scatter (level 1), bulk_refine
(level 2, an in-place sort of each tile by slice) and bulk_apply against
their plain PyTorch versions on the card, BulkChunk against the per-batch
build and bulk_build_planes_plain, and the engine's bulk route
(COMMET_TPU_BULK_BUILD=force, small COMMET_TPU_BULK_CHUNK) against its
per-batch route. Each skips without a CUDA card; exact equality throughout
(a bin's or a run's entries are compared as a set: the kernels place them
in the order their shared-memory atomics land). Imports no JAX:

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
    long, with Ns, and a clean batch of 300 bp reads with 2% A (plane D's
    keys, a | b, crowd into its last region and slice: a coarse bin of
    many level-2 tiles), on the card: (codes2, aux, clean, length) each."""
    out = []
    for n_frac in (0.01, 0.0, 0.02):
        seqs = random_seqs(rng, 700, 1, 300, n_frac=n_frac)
        codes = encode(seqs, lpad=320)
        clean = n_frac == 0.0
        c2, aux = (x.to(device) for x in _pack(codes, clean))
        out.append((c2, aux, clean, 320))
    codes = np.full((700, 320), 4, dtype=np.uint8)
    codes[:, :300] = rng.choice(4, size=(700, 300), p=[0.02, 0.33, 0.33,
                                                       0.32])
    c2, aux = (x.to(device) for x in _pack(codes, True))
    out.append((c2, aux, True, 320))
    return out


def _sorted_bins(bins, offsets):
    """Each entry keyed by its bin, sorted: the bins as sets."""
    n = offsets[1:] - offsets[:-1]
    b = torch.repeat_interleave(torch.arange(n.numel(), device=n.device), n)
    return torch.sort(b * (1 << 32) + bins[:b.numel()].to(torch.int64)).values


WRAPPERS = ("bulk_histogram", "bulk_scatter", "bulk_refine", "bulk_apply")


@pytest.mark.gpu
@pytest.mark.parametrize("k", [4, 15, 21, 31, 33])
def test_bulk_kernels_match_plain_on_card(cuda_device, k):
    """Per batch the histogram kernel gives the plain table; level 1's
    kernel fills each coarse bin of its buffer with the plain version's
    entries; level 2's kernel, sorting each tile in place, gives the plain
    version's table and fine counts and each (tile, slice) run the plain
    version's entries; the apply kernel sets the plain version's bits on a
    set already holding bits; a BulkChunk over the batches equals the
    per-batch kernel build and bulk_build_planes_plain. Each wrapper counts
    its launches."""
    rng = np.random.default_rng(80 + k)
    batches = _batches(rng, k, cuda_device)
    _sb, _sw, ns, _rb = planes.bulk_layout(k)
    launched = [getattr(planes, name).launches for name in WRAPPERS]
    tables = []
    for bt in batches:
        tables.append(planes.bulk_histogram(*bt, k))
        assert torch.equal(tables[-1], planes.bulk_histogram_plain(*bt, k))
    starts, cstart = planes.bulk_starts(torch.cat(tables))
    slots = sum(planes.bulk_slots(bt[0], bt[3], k) for bt in batches)
    got_mid = torch.full((4 * slots,), -1, dtype=torch.int32,
                         device=cuda_device)
    want_mid = got_mid.clone()
    row0 = 0
    for bt in batches:
        planes.bulk_scatter(got_mid, starts, row0, *bt, k)
        planes.bulk_scatter_plain(want_mid, starts, row0, *bt, k)
        row0 += planes.bulk_blocks(bt[0])
    assert torch.equal(_sorted_bins(got_mid, cstart),
                       _sorted_bins(want_mid, cstart))
    want_mid = got_mid.clone()
    got_table, want_table = (planes.bulk_table(got_mid, k) for _ in range(2))
    got_counts, want_counts = (torch.zeros(4 * ns, dtype=torch.int64,
                                           device=cuda_device)
                               for _ in range(2))
    planes.bulk_refine(got_mid, got_table, got_counts, cstart, k)
    planes.bulk_refine_plain(want_mid, want_table, want_counts, cstart, k)
    torch.cuda.synchronize()
    assert torch.equal(got_table, want_table)
    assert torch.equal(got_counts, want_counts)
    runs = torch.cat([planes.bulk_runs(got_table, cstart, k)[1],
                      cstart[-1:]])
    assert torch.equal(_sorted_bins(got_mid, runs),
                       _sorted_bins(want_mid, runs))
    assert torch.equal(got_mid[int(cstart[-1]):], want_mid[int(cstart[-1]):])
    base = planes.alloc_planes(k, cuda_device)
    planes.build_planes(base, *batches[0], k)  # bits already set
    got = planes.bulk_apply(base.clone(), got_mid, got_table, got_counts,
                            cstart, k)
    want = planes.bulk_apply_plain(base.clone(), got_mid, got_table,
                                   got_counts, cstart, k)
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
    assert [getattr(planes, name).launches - n
            for name, n in zip(WRAPPERS, launched)] == [8, 8, 2, 2]


@pytest.mark.gpu
def test_bulk_engine_cuda_matches_per_batch(tmp_path, monkeypatch,
                                            cuda_device):
    """The engine on the card with COMMET_TPU_BULK_BUILD=force and chunks
    of 20,000 window slots (many flushes, a smaller last chunk) builds the
    planes of COMMET_TPU_BULK_BUILD=0, launching the bulk kernels and not
    the per-batch one; and the card's default takes the bulk build."""
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
        bulk = mode != "0"
        assert eng.uses_bulk_build() == bulk
        assert (planes.bulk_apply.launches > 2) == bulk
        assert (planes.build_planes.launches > 0) == (not bulk)
    assert torch.equal(got["force"], got["0"])
    assert torch.equal(got[None], got["0"])


@pytest.mark.gpu
def test_bulk_kernels_reject_bad_inputs(cuda_device):
    """The wrappers raise on starts, cstart, counts, tables, buffers or
    planes of the wrong type, size or device, or rows past the starts,
    before launching."""
    k = 15
    rng = np.random.default_rng(91)
    c2, aux, clean, length = _batches(rng, k, cuda_device)[0]
    _sb, _sw, ns, _rb = planes.bulk_layout(k)
    nbins = planes.bulk_bins(k)[0]
    rows = planes.bulk_blocks(c2)
    starts = torch.zeros((nbins, rows), dtype=torch.int64, device=cuda_device)
    cstart = torch.zeros(nbins + 1, dtype=torch.int64, device=cuda_device)
    good = torch.zeros(4 * ns, dtype=torch.int64, device=cuda_device)
    mid = torch.zeros(16, dtype=torch.int32, device=cuda_device)
    table = planes.bulk_table(mid, k)
    pl = planes.alloc_planes(k, cuda_device)
    launched = [getattr(planes, name).launches for name in WRAPPERS]
    for bad in (starts.to(torch.int32), starts[:-1], starts.cpu(),
                starts.t()):
        with pytest.raises(ValueError):
            planes.bulk_scatter(mid, bad, 0, c2, aux, clean, length, k)
    with pytest.raises(ValueError):
        planes.bulk_scatter(mid, starts, 1, c2, aux, clean, length, k)
    with pytest.raises(ValueError):
        planes.bulk_scatter(mid.to(torch.int64), starts, 0, c2, aux, clean,
                            length, k)
    for bad in (good.to(torch.int32), good[:-1], good.cpu()):
        with pytest.raises(ValueError):
            planes.bulk_refine(mid, table, bad, cstart, k)
        with pytest.raises(ValueError):
            planes.bulk_apply(pl, mid, table, bad, cstart, k)
    for bad in (cstart[:-1], cstart.to(torch.int32), cstart.cpu()):
        with pytest.raises(ValueError):
            planes.bulk_refine(mid, table, good, bad, k)
        with pytest.raises(ValueError):
            planes.bulk_apply(pl, mid, table, good, bad, k)
    for bad in (table[:-1], table.to(torch.int32), table.cpu(),
                table.view(1, -1)):
        with pytest.raises(ValueError):
            planes.bulk_refine(mid, bad, good, cstart, k)
        with pytest.raises(ValueError):
            planes.bulk_apply(pl, mid, bad, good, cstart, k)
    for bad in (mid.to(torch.int64), mid.cpu(), mid.view(4, 4)):
        with pytest.raises(ValueError):
            planes.bulk_refine(bad, table, good, cstart, k)
    with pytest.raises(ValueError):
        planes.bulk_histogram(c2, aux[:-1], clean, length, k)
    with pytest.raises(ValueError):
        planes.bulk_apply(pl[:-1], mid, table, good, cstart, k)
    assert [getattr(planes, name).launches for name in WRAPPERS] == launched
