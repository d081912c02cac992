"""Card-only tests of the port's multi-device code: the ranged plane build
(commet_build_planes_range), the ranged plane probe's two passes
(commet_probe_planes_part_a, commet_probe_planes_part) and the class counts
(commet_class_counts) against their plain PyTorch versions, and the engine
on a mesh of the card repeated four times against the engine on the card
alone. Each skips without a CUDA card; exact equality throughout. Imports
no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu_mesh.py
"""

import numpy as np
import pytest
import torch

from commet_tpu_torch.core import filter as tfilter
from commet_tpu_torch.core import planes as tplanes
from commet_tpu_torch.core import stream as tstream
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.parallel import sharded
from test_torch_gpu import _pack
from torch_helpers import (encode, implant, make_fastas, random_seqs,
                           run_engine)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _batches(rng, k, device):
    """Index and query batches, dirty and clean: (codes2, aux, clean,
    length) on the card; queries hold 2k fragments of index reads."""
    idx = random_seqs(rng, 1500, 20, 150, n_frac=0.01)
    qry = random_seqs(rng, 800, 20, 150, n_frac=0.01)
    implant(rng, idx, qry, k, span=2)
    out = []
    for seqs in (idx, qry):
        dirty = encode(seqs)
        clean = np.where(dirty == 4, 0, dirty).astype(np.uint8)
        for codes, is_clean in ((dirty, False), (clean, True)):
            c2, aux = (x.to(device) for x in _pack(codes, is_clean))
            out.append((c2, aux, is_clean, codes.shape[1]))
    return out[:2], out[2:]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [15, 21, 33])
def test_ranged_plane_kernels_match_plain_on_card(cuda_device, k):
    """Four ranges of the ranged build reassemble to commet_build_planes'
    planes and equal the plain range build. Per range, pass A and pass
    B/C/D (given the merged A words) equal their plain versions; A &
    ~vetoes is the membership, and the sharded tags on the card repeated
    four times equal probe_planes' on the whole set."""
    rng = np.random.default_rng(70 + k)
    index, query = _batches(rng, k, cuda_device)
    n = 4
    whole = tplanes.alloc_planes(k, cuda_device)
    ps = sharded.alloc_planes_sharded(k, sharded.Mesh([cuda_device] * n))
    wl = ps.wl
    for batch in index:
        tplanes.build_planes(whole, *batch, k)
        for d, shard in enumerate(ps.shards):
            before = tplanes.build_planes_range.launches
            tplanes.build_planes_range(shard, *batch, k, d * wl, wl)
            torch.cuda.synchronize()
            assert tplanes.build_planes_range.launches == before + 1
            want = torch.zeros_like(shard)
            tplanes.build_planes_plain(want, *batch, k, d * wl, wl)
            got = torch.zeros_like(shard)
            tplanes.build_planes_range(got, *batch, k, d * wl, wl)
            assert torch.equal(got, want)
    assert torch.equal(ps.assembled(), whole)
    for c2, aux, is_clean, length in query:
        wmax = length - k + 1
        args = (c2, aux, is_clean, length, k)
        ahit = None
        for d, shard in enumerate(ps.shards):
            got = tplanes.probe_planes_part_a(shard, *args, d * wl, wl, wmax)
            assert torch.equal(got, tplanes.probe_planes_part_a_plain(
                shard, *args, d * wl, wl, wmax))
            ahit = got if ahit is None else ahit | got
        veto = None
        for d, shard in enumerate(ps.shards):
            got = tplanes.probe_planes_part(shard, *args, d * wl, wl, wmax,
                                            ahit)
            assert torch.equal(got, tplanes.probe_planes_part_plain(
                shard, *args, d * wl, wl, wmax, ahit))
            veto = got if veto is None else veto | got
        member = tplanes.unpack_window_bits(ahit & ~veto, wmax)
        assert member.any()
        tags = sharded.probe_planes_sharded(ps, c2, aux, is_clean, length, 2,
                                            wmax)
        single = tplanes.probe_planes(whole, c2, aux, is_clean, length, k, 2,
                                      wmax)
        assert torch.equal(tags, single)
        assert int(single.sum()) > 50


@pytest.mark.gpu
def test_class_counts_kernel_matches_plain_on_card(cuda_device):
    """commet_class_counts against class_counts_packed_plain and numpy:
    N-heavy reads, empty reads, reads filling the padded length, lengths not
    a multiple of 16 or 32; the padded lengths where the kernel's lane
    groups change (1, 15, 16, 17, 63, 64, 65, 128, 300), each with rows
    packed to exactly ceil(length / 16) code words (word by word loads where
    that is not a whole quad) and to whole quads (16-byte loads), and row
    counts of 0, 1 and one off a warp's and a block's reads."""
    rng = np.random.default_rng(12)
    seqs = random_seqs(rng, 3000, 0, 203, n_frac=0.2)
    seqs[7] = b""
    seqs[8] = b"N" * 203
    cases = [(seqs, length, 0) for length in (203, 224)]
    for length in (1, 15, 16, 17, 63, 64, 65, 128, 300):
        for n in (999, 0, 1, 15, 17, 127, 129):
            cases += [(random_seqs(rng, n, 0, length, n_frac=0.1), length,
                       quads) for quads in (False, True)]
    for case_seqs, length, quads in cases:
        codes = encode(case_seqs, length) if case_seqs else np.zeros(
            (0, length), dtype=np.uint8)
        c2, vd = _pack(codes, False)
        if quads:  # widths a multiple of 4 and 2 words, zeros past length
            c2 = torch.nn.functional.pad(c2, (0, -c2.shape[1] % 4))
            vd = torch.nn.functional.pad(vd, (0, -vd.shape[1] % 2))
        c2, vd = c2.contiguous().to(cuda_device), vd.contiguous().to(
            cuda_device)
        lens = torch.tensor([len(s) for s in case_seqs], dtype=torch.int32,
                            device=cuda_device)
        before = tfilter.class_counts_packed.launches
        got = tfilter.class_counts_packed(c2, vd, lens, length)
        torch.cuda.synchronize()
        assert tfilter.class_counts_packed.launches == before + (
            1 if case_seqs else 0)
        assert got.shape == (len(case_seqs), 5)
        if not case_seqs:
            continue
        want = tfilter.class_counts_packed_plain(c2, vd, lens, length)
        assert torch.equal(got, want), (length, len(case_seqs), quads)
        valid = codes < 4
        host = np.stack([((codes == c) & valid).sum(axis=1)
                         for c in range(4)], axis=1)
        host = np.concatenate([host, (lens.cpu().numpy()
                                      - host.sum(axis=1))[:, None]], axis=1)
        np.testing.assert_array_equal(got.cpu().numpy(), host)
        if length in (203, 224) and not quads:
            assert int(want[:, 4].sum()) > 0  # the data reach "other"


@pytest.mark.gpu
@pytest.mark.parametrize("mode,stream_env", [("dp", "force"), ("dp", "0"),
                                             ("plane", "1")])
def test_mesh_engine_on_card_matches_single(tmp_path, monkeypatch,
                                            cuda_device, mode, stream_env):
    """Engine on a mesh of the card repeated four times (dp with the sorted
    index, dp with the planes, plane mode) writes the single-device
    engine's bytes and counters, and launches the kernels of its route."""
    monkeypatch.setenv("COMMET_TPU_STREAM", stream_env)
    monkeypatch.setattr(tengine, "STREAM_BATCH", 64)
    idx_fa, qry_fas, _ = make_fastas(tmp_path, 31, 21, 0.02, n_queries=2)
    c1, want = run_engine(tengine.Engine(k=21, t=2, device=cuda_device),
                          idx_fa, qry_fas, str(tmp_path / "one"))
    counts = (tstream.join_membership.launches,
              tplanes.probe_planes.launches,
              tplanes.probe_planes_part.launches)
    mesh = sharded.Mesh([cuda_device] * 4)
    eng = tengine.Engine(k=21, t=2, device=cuda_device, mesh=mesh,
                         mesh_mode=mode)
    c4, got = run_engine(eng, idx_fa, qry_fas, str(tmp_path / "mesh"))
    assert got == want
    for name, c in c1.items():
        for field in ("indexed", "searched", "shared"):
            assert c4[name][field] == c[field]
    launched = [b - a for a, b in zip(counts, (
        tstream.join_membership.launches, tplanes.probe_planes.launches,
        tplanes.probe_planes_part.launches))]
    route = {"force": 0, "0": 1, "1": 2}[stream_env]
    assert launched[route] > 0 and sum(launched) == launched[route]
