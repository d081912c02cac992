"""The port's sorted-join stream module against commet_tpu's: the join
(plain PyTorch version vs the Pallas kernel in interpret mode, on the same
index carried across by state.stream_index_from_jax), the S=1 stream
verdicts, and the exact sorted-set fallback. Verdicts are integers, so the
tolerance is exact equality; only the JAX kernel's RESIDUAL entries (which
depend on its window geometry) are left out of the kernel-level check."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.core import stream as jstream
from commet_tpu_torch import state
from commet_tpu_torch.core import keys
from commet_tpu_torch.core import stream as tstream
from oracle import index_reads, search_read
from torch_helpers import (U32, encode, implant, index_pairs, query_pairs,
                           random_seqs)


def _jax_join(a, b, qa, qb, k):
    """JAX finalize_index_keys + join_membership (interpret mode) on the
    pairs split into uint32 words; returns the JAX index arrays and the
    verdicts in the queries' order."""
    wide = k > 32
    lo = lambda x: jnp.asarray((x & U32).astype(np.uint32))  # noqa: E731
    hib = ((a >> 32) << 8) | (b >> 32)
    ika, ikb, ihib, mi = jstream.finalize_index_keys(
        [lo(a)], [lo(b)], [lo(hib)] if wide else None,
        [jnp.zeros(len(a), jnp.uint32)], [len(a)], ki=2, wide=wide)
    order = np.argsort(qa & U32, kind="stable")
    chunk = 512
    mpad = -(-len(qa) // chunk) * chunk
    pad = np.full(mpad - len(qa), U32, dtype=np.int64)
    sqa, sqb = np.concatenate([qa[order], pad]), np.concatenate([qb[order],
                                                                 pad])
    qh = ((sqa >> 32) << 8) | (sqb >> 32)
    got_s = np.asarray(jstream.join_membership(
        ika, ikb, mi, lo(sqa), lo(sqb), chunk=chunk, ki=2, interpret=True,
        ihib=ihib, qh_sorted=lo(qh) if wide else None))[:len(qa)]
    got = np.empty_like(got_s)
    got[order] = got_s
    return (ika, ikb, ihib, mi), got


@pytest.mark.parametrize("k", [15, 32, 33])
def test_join_plain_matches_jax_kernel(k):
    rng = np.random.default_rng(60 + k)
    a, b = index_pairs(rng, k, 2500)
    qa, qb = query_pairs(rng, k, a, b, 3000)
    (ika, ikb, ihib, mi), want = _jax_join(a, b, qa, qb, k)

    sidx = state.stream_index_from_jax(ika, ikb, ihib, mi)
    own = tstream.finalize_index([torch.from_numpy(a)], [torch.from_numpy(b)])
    torch.testing.assert_close(sidx.ika, own.ika, rtol=0, atol=0)
    torch.testing.assert_close(sidx.ikb, own.ikb, rtol=0, atol=0)
    got = tstream.join_membership_plain(
        sidx.ika, sidx.ikb, sidx.mi, torch.from_numpy(qa),
        torch.from_numpy(qb)).numpy()

    # the exact set reference decides every query
    aset, pairs = set(a.tolist()), set(zip(a.tolist(), b.tolist()))
    exact = np.array([tstream.CONF if (x, y) in pairs else
                      tstream.CAND if x in aset else tstream.NONMEM
                      for x, y in zip(qa.tolist(), qb.tolist())], np.int8)
    np.testing.assert_array_equal(got, exact)
    assert set(np.unique(got)) == {tstream.NONMEM, tstream.CAND,
                                   tstream.CONF}

    # JAX CONF and NONMEM are proofs, so they agree. JAX CAND means "keya
    # seen in the window, the pair not": the pair may sit past the window
    # edge in a straddling keya run (port CONF), and for k > 32 the keya
    # match may be of the low word only (port NONMEM).
    decided = want != jstream.RESIDUAL
    assert decided.mean() > 0.5
    for verdict in (jstream.CONF, jstream.NONMEM):
        sel = decided & (want == verdict)
        assert sel.any()
        assert (got[sel] == verdict).all()
    allowed = (tstream.CAND, tstream.CONF) + (
        (tstream.NONMEM,) if k > 32 else ())
    cand = decided & (want == jstream.CAND)
    assert np.isin(got[cand], allowed).all()
    assert (got[cand] == tstream.CAND).mean() > 0.5
    if k > 32:
        assert (got[cand] == tstream.NONMEM).any()


def test_join_empty_index():
    empty = jnp.zeros((0,), jnp.uint32)
    ika, ikb, _h, mi = jstream.finalize_index_keys(
        [empty], [empty], None, [empty], [0], ki=2)
    q = np.arange(512, dtype=np.int64)
    want = np.asarray(jstream.join_membership(
        ika, ikb, mi, jnp.asarray(q.astype(np.uint32)),
        jnp.asarray(q.astype(np.uint32)), chunk=512, ki=2, interpret=True))
    assert (want == jstream.NONMEM).all()
    for sidx in (state.stream_index_from_jax(ika, ikb, None, mi),
                 tstream.finalize_index([torch.zeros(0, dtype=torch.int64)],
                                        [torch.zeros(0, dtype=torch.int64)])):
        assert sidx.mi == 0
        got = tstream.join_membership(sidx.ika, sidx.ikb, 0,
                                      torch.from_numpy(q),
                                      torch.from_numpy(q))
        assert (got.numpy() == tstream.NONMEM).all()


def _jax_read_index(idx_codes, k):
    ka, kb, hib, flags, cnt = jstream.chunk_index_keys_codes(
        jnp.asarray(idx_codes.astype(np.int32)), k)
    if k > 32:
        ika, ikb, ihib, mi = jstream.finalize_index_keys(
            [ka], [kb], [hib], [flags], [int(cnt)], ki=2, wide=True)
        return (ika, ikb, ihib, mi, None, None, None, None)
    sx = jstream.finalize_index([ka], [kb], [hib], [flags], [int(cnt)], ki=2)
    return (sx.ika, sx.ikb, None, sx.mi, sx.sa, sx.sb, sx.sc, sx.sd)


def _read_sets(seed, k):
    rng = np.random.default_rng(seed)
    idx_seqs = random_seqs(rng, 30, k, 4 * k + 10, n_frac=0.002)
    idx_seqs.append(b"T" * (k + 6))
    idx_seqs += idx_seqs[:4]  # duplicate runs
    qry_seqs = random_seqs(rng, 60, k - 2, 4 * k + 10, n_frac=0.02)
    qry_seqs.append(b"T" * (k + 2))
    implant(rng, idx_seqs, qry_seqs, k)
    implant(rng, idx_seqs, qry_seqs, k, span=3, start=1)
    bloom = index_reads([s.decode() for s in idx_seqs], k)
    expected = np.array([[search_read(bloom, s.decode(), k, t)
                          for s in qry_seqs] for t in (1, 2, 3)])
    return idx_seqs, qry_seqs, expected


@pytest.mark.parametrize("k,t", [(15, 1), (21, 3), (32, 2), (33, 2)])
def test_stream_verdicts_match_jax(k, t):
    """S=1 stream verdicts vs probe_multi_stream_codes: equal wherever JAX
    decides; the port decides at least those reads (its join never returns
    RESIDUAL) and is sound against the oracle everywhere."""
    idx_seqs, qry_seqs, expected = _read_sets(500 + k, k)
    idx_codes = encode(idx_seqs)
    codes = encode(qry_seqs)
    jidx = _jax_read_index(idx_codes, k)
    ika, ikb, ihib, mi = jidx[:4]
    want = np.asarray(jstream.probe_multi_stream_codes(
        (ika,), (ikb,), (mi,), jnp.asarray(codes.astype(np.int32)), k, t,
        chunk=512, ki=2, interpret=True,
        ihibs=(ihib,) if k > 32 else None))[0]
    sidx = state.stream_index_from_jax(*jidx)
    got = tstream.probe_stream_codes(sidx, torch.from_numpy(codes), k,
                                     t).numpy()
    decided = want != kernels.VERDICT_AMBIG
    np.testing.assert_array_equal(got[decided], want[decided])
    assert not ((got == tstream.VERDICT_AMBIG) & decided).any()
    exp = expected[t - 1]
    assert exp.any()
    assert exp[got == tstream.VERDICT_TAGGED].all()
    assert not exp[got == tstream.VERDICT_UNTAGGED].any()


@pytest.mark.parametrize("k", [15, 32, 33])
def test_probe_exact_sets_match_jax(k):
    """The exact fallback: equal to JAX probe_exact_sets (k <= 32; wide keys
    have no JAX sets) and to the oracle, for t in 1, 2, 3, dirty reads."""
    idx_seqs, qry_seqs, expected = _read_sets(900 + k, k)
    jidx = _jax_read_index(encode(idx_seqs), k)
    sidx = state.stream_index_from_jax(*jidx)
    codes = encode(qry_seqs)
    lpad = codes.shape[1]
    c2, vd = kernels.pack_codes_np(codes)
    for t in (1, 2, 3):
        got = tstream.probe_exact_sets(sidx, keys.host_u32(c2),
                                       keys.host_u32(vd), lpad, k, t).numpy()
        np.testing.assert_array_equal(got, expected[t - 1])
        if k <= 32:
            want = np.asarray(jstream.probe_exact_sets(
                *jidx[4:], jidx[3], jnp.asarray(c2), jnp.asarray(vd), lpad,
                k, t))
            np.testing.assert_array_equal(got, want)

