"""The port's multi-index stream probe (one sorted query stream joined
against S indexes, TAGGED / UNTAGGED / AMBIG per slot) against commet_tpu's
probe_multi_stream_codes on the same resident indexes, carried across by
state.resident_from_jax. The JAX side runs with the stream forced on
(COMMET_TPU_STREAM=force) and the Pallas join in interpret mode; the port's
join runs its plain PyTorch version. JAX TAGGED and UNTAGGED are proofs the
port must agree with; a JAX AMBIG may be anything in the port (its join
never returns RESIDUAL, and a JAX CAND can be a port CONF). The amortized
engine and driver are tested in test_torch_multi_engine.py and
test_torch_multi_driver.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import commet_tpu.engine.engine as jengine
from commet_tpu.core import kernels
from commet_tpu.core import stream as jstream
from commet_tpu_torch import state
from commet_tpu_torch.core import keys
from commet_tpu_torch.core import stream as tstream
from torch_helpers import (encode, force_jax_stream, implant, long_seq,
                           random_seqs, read_set, write_fasta)

T = 2


def _probe_sets(k):
    """Three index sets (two 700 bp reads, then short dirty reads) and
    two query batches: short reads holding 2k fragments of sets 0 and 1,
    and 700 bp reads holding an 18k fragment of a long read of each set
    (tagged even at t = 17)."""
    rng = np.random.default_rng(400 + k)
    idx_sets = []
    for _ in range(3):
        seqs = [long_seq(rng, 700) for _ in range(2)]
        seqs += random_seqs(rng, 24, 60, 90, n_frac=0.01)
        idx_sets.append(seqs)
    short = random_seqs(rng, 40, 55, 90, n_frac=0.02)
    implant(rng, idx_sets[0][2:], short, k, span=2)
    implant(rng, idx_sets[1][2:], short, k, span=2, start=1)
    longq = []
    for s in range(3):
        donor = idx_sets[s][1]
        q = bytearray(long_seq(rng, 700))
        q[100:100 + 18 * k] = donor[50:50 + 18 * k]
        longq.append(bytes(q))
    longq.append(long_seq(rng, 690))
    return idx_sets, [encode(short), encode(longq)]


_RESIDENTS = {}


def _jax_residents(tmp_path_factory, k):
    """JAX residents of the _probe_sets index sets (several partitions
    each), built once per k."""
    if k not in _RESIDENTS:
        idx_sets, batches = _probe_sets(k)
        tmp = tmp_path_factory.mktemp(f"probe{k}")
        with pytest.MonkeyPatch.context() as mp:
            force_jax_stream(mp)
            eng = jengine.Engine(k=k, t=T, batch=64, max_kmer=700)
            res = []
            for s, seqs in enumerate(idx_sets):
                write_fasta(tmp / f"i{s}.fa", seqs)
                res.append(eng.build_resident(
                    read_set(f"I{s}", str(tmp / f"i{s}.fa"), engine=eng)))
        assert all(r is not None for r in res)
        assert all(len(r.partitions) > 1 for r in res)
        _RESIDENTS[k] = (res, batches)
    return _RESIDENTS[k]


@pytest.mark.parametrize("t", [1, 2, 17])
@pytest.mark.parametrize("k", [15, 32, 33])
def test_probe_multi_matches_jax(tmp_path_factory, k, t):
    jres, batches = _jax_residents(tmp_path_factory, k)
    parts = [sx for r in jres for sx in r.partitions]
    ports = [state.resident_from_jax(r) for r in jres]
    pparts = [sx for r in ports for sx in r.partitions]
    slots = tstream.JoinSlots([sx.ika for sx in pparts],
                              [sx.ikb for sx in pparts],
                              [sx.mi for sx in pparts])
    wide = k > 32
    seen, seen_jax = set(), set()
    for codes in batches:
        want = np.asarray(jstream.probe_multi_stream_codes(
            tuple(sx.ika for sx in parts), tuple(sx.ikb for sx in parts),
            tuple(sx.mi for sx in parts),
            jnp.asarray(codes.astype(np.int32)), k, t, chunk=512,
            interpret=True,
            ihibs=tuple(sx.ihib for sx in parts) if wide else None))
        codes_t = torch.from_numpy(codes)
        got = tstream.probe_multi_stream_codes(slots, codes_t, k, t).numpy()
        assert got.shape == want.shape == (len(pparts), len(codes))
        for verdict in (kernels.VERDICT_TAGGED, kernels.VERDICT_UNTAGGED):
            assert (got[want == verdict] == verdict).all()
        seen_jax |= set(np.unique(want).tolist())
        # each slot equals the S = 1 probe and is sound against the exact
        # sorted-set probe
        c2, vd = kernels.pack_codes_np(codes)
        for s, sx in enumerate(pparts):
            one = tstream.probe_stream_codes(sx, codes_t, k, t).numpy()
            np.testing.assert_array_equal(got[s], one)
            exact = tstream.probe_exact_sets(
                sx, keys.host_u32(c2), keys.host_u32(vd), codes.shape[1], k,
                t).numpy()
            assert exact[got[s] == tstream.VERDICT_TAGGED].all()
            assert not exact[got[s] == tstream.VERDICT_UNTAGGED].any()
        seen |= set(np.unique(got).tolist())
    assert {tstream.VERDICT_TAGGED, tstream.VERDICT_UNTAGGED} <= seen
    assert {kernels.VERDICT_TAGGED, kernels.VERDICT_UNTAGGED} <= seen_jax
