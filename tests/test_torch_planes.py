"""The port's dense-plane functions (core/planes.py, their plain PyTorch
versions on the CPU) against commet_tpu's kernels on the same numpy-seeded
reads: the build word for word against kernels.build_chunk, the probe's
tags against kernels.search_batch, the multi-set probe against per-set
probes and the JAX cascade's proofs, plane sets carried across by
state.planes_from_jax, and the k = 33 plane addressing against
kernels._plane_addr. Bits and integers: exact equality throughout."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu_torch import state
from commet_tpu_torch.core import keys, planes
from torch_helpers import encode, implant, long_seq, random_seqs

U32 = 0xFFFFFFFF


def _packed(codes, clean):
    """Both packages' wire formats of [n, L] uint8 codes: (codes2, aux)
    tensors, aux the lengths (clean) or the validity words."""
    if clean:
        lens = (codes < 4).sum(axis=1).astype(np.int32)
        return (keys.host_u32(kernels.pack_codes2_np(codes)),
                torch.from_numpy(lens))
    c2, vd = kernels.pack_codes_np(codes)
    return keys.host_u32(c2), keys.host_u32(vd)


def _as_u32(pl):
    return pl.numpy().view(np.uint32)


def _build_both(codes_list, k):
    """JAX planes (build_chunk per batch) and the port's (build_planes per
    batch into the same tensor); each batch is (codes, clean)."""
    want = kernels.alloc_planes(k)
    got = planes.alloc_planes(k, "cpu")
    for codes, clean in codes_list:
        want = kernels.build_chunk(want, jnp.asarray(codes.astype(np.int32)),
                                   k)
        c2, aux = _packed(codes, clean)
        assert planes.build_planes(got, c2, aux, clean, codes.shape[1],
                                   k) is got
    return np.asarray(want), got


@pytest.mark.parametrize("k", [11, 15, 21, 27])
def test_build_matches_jax(k):
    """A dirty batch (N bases, one all-T read: keya all ones, the sign bit
    of its words), then a clean batch sharing reads with it, into the same
    planes: bits already set stay set once. The JAX planes carried across
    by planes_from_jax equal the port's."""
    rng = np.random.default_rng(200 + k)
    dirty = random_seqs(rng, 60, max(1, k - 4), 3 * k + 20, n_frac=0.05)
    dirty.append(b"T" * (k + 40))
    clean = random_seqs(rng, 50, 1, 3 * k + 20, n_frac=0.0) + [
        s for s in dirty[:20] if b"N" not in s and b"n" not in s]
    batches = [(encode(dirty), False), (encode(clean), True)]
    want, got = _build_both(batches, k)
    np.testing.assert_array_equal(_as_u32(got), want)
    assert (want != 0).sum() > 100
    assert (want >= 1 << 31).any()  # bit 31 set somewhere
    assert torch.equal(state.planes_from_jax(want), got)


def _probe_inputs(k):
    """Index reads (two 700 bp reads, then short dirty ones) and query
    batches (codes, clean): short dirty reads and short N-free reads with 2k
    fragments, and 700 bp reads holding an 18k fragment of a long index read
    (tagged even at t = 17; one reverse-complemented), in both wire
    formats."""
    rng = np.random.default_rng(600 + k)
    idx = [long_seq(rng, 700) for _ in range(2)]
    idx += random_seqs(rng, 40, 60, 90, n_frac=0.01)
    dirty = random_seqs(rng, 60, 20, 90, n_frac=0.02)
    implant(rng, idx[2:], dirty, k, span=2)
    clean = random_seqs(rng, 60, 20, 90, n_frac=0.0)
    implant(rng, [s for s in idx[2:] if b"N" not in s.upper()], clean, k,
            span=2)
    longq = []
    for s in range(2):
        q = bytearray(long_seq(rng, 700))
        q[100:100 + 18 * k] = idx[s][50:50 + 18 * k]
        longq.append(bytes(q))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    longq.append(longq[0].translate(comp)[::-1])
    longq.append(long_seq(rng, 690))
    longq = encode(longq, 704)
    return encode(idx), [(encode(dirty, 96), False), (encode(clean, 96), True),
                         (longq, False), (longq, True)]


@pytest.mark.parametrize("t", [1, 2, 17])
def test_probe_matches_jax(t):
    """probe_planes (plain, on the CPU) against kernels.search_batch on the
    JAX-built planes, clean and dirty wire formats, at k = 15 and 21."""
    seen = set()
    for k in (15, 21):
        idx_codes, batches = _probe_inputs(k)
        jp = kernels.build_chunk(kernels.alloc_planes(k),
                                 jnp.asarray(idx_codes.astype(np.int32)), k)
        pl = state.planes_from_jax(np.asarray(jp))
        for codes, clean in batches:
            wmax = int((codes < 4).sum(axis=1).max()) - k + 1
            want, _fwd = kernels.search_batch(
                jp, jnp.asarray(codes.astype(np.int32)), k, t, wmax)
            want = np.asarray(want)
            c2, aux = _packed(codes, clean)
            got = planes.probe_planes(pl, c2, aux, clean, codes.shape[1], k,
                                      t, wmax)
            np.testing.assert_array_equal(got.numpy(), want)
            seen |= set(want.tolist())
        # the 18k fragments tag their reads, the random long read not
        np.testing.assert_array_equal(got.numpy(), [True] * 3 + [False])
    assert seen == {False, True}


def test_probe_multi_matches_singles_and_jax_proofs():
    """probe_planes_multi (plain) at S = 3 equals three probe_planes calls
    row by row; JAX's multi cascade TAGGED and UNTAGGED are proofs the port
    agrees with. The wrappers take the plain versions on the CPU and count
    no launch."""
    k, t = 15, 2
    idx_codes, batches = _probe_inputs(k)
    rng = np.random.default_rng(9)
    others = [encode(random_seqs(rng, 30, 60, 90, n_frac=0.01))
              for _ in range(2)]
    jps = [kernels.build_chunk(kernels.alloc_planes(k),
                               jnp.asarray(c.astype(np.int32)), k)
           for c in [idx_codes] + others]
    slots = planes.PlaneSlots([state.planes_from_jax(np.asarray(p))
                               for p in jps])
    before = (planes.probe_planes.launches,
              planes.probe_planes_multi.launches)
    for codes, clean in batches[:2]:
        c2, aux = _packed(codes, clean)
        length = codes.shape[1]
        got = planes.probe_planes_multi(slots, c2, aux, clean, length, k, t)
        assert got.shape == (3, len(codes)) and got.dtype == torch.bool
        for s, pl in enumerate(slots.planes):
            assert torch.equal(got[s], planes.probe_planes(
                pl, c2, aux, clean, length, k, t))
        jc2 = c2.numpy().view(np.uint32)
        jaux = aux.numpy() if clean else aux.numpy().view(np.uint32)
        fn = (kernels.probe_cascade2_multi_clean if clean
              else kernels.probe_cascade2_multi_packed)
        want = np.asarray(fn(tuple(jps), jnp.asarray(jc2), jnp.asarray(jaux),
                             length, k, t, 4))
        assert (got.numpy()[want == kernels.VERDICT_TAGGED]).all()
        assert not (got.numpy()[want == kernels.VERDICT_UNTAGGED]).any()
        assert got[0].any()
    assert (planes.probe_planes.launches,
            planes.probe_planes_multi.launches) == before


def test_plane_addressing_matches_jax():
    """The word key >> 5 and bit key & 31 of whole int64 keys equal JAX's
    _plane_addr of the (lo, hi) uint32 halves, at the reference default
    k = 33 and at the widest k, 36; no plane set is allocated (4 GiB at
    k = 33: planes.plane_bytes says so)."""
    for k in (33, 36):
        rng = np.random.default_rng(k)
        key = rng.integers(0, 1 << k, 4096, dtype=np.int64)
        key[:3] = [0, (1 << k) - 1, (1 << 32) - 1]
        word, bit = planes.plane_addr(torch.from_numpy(key))
        jword, jmask = kernels._plane_addr(
            jnp.asarray((key & U32).astype(np.uint32)),
            jnp.asarray((key >> 32).astype(np.uint32)), k)
        np.testing.assert_array_equal(word.numpy(),
                                      np.asarray(jword).astype(np.int64))
        np.testing.assert_array_equal(
            np.uint32(1) << bit.numpy().astype(np.uint32), np.asarray(jmask))
        assert (word.numpy() < planes.plane_words(k)).all()
        assert planes.plane_words(k) == kernels.plane_words(k)
        assert planes.plane_bytes(k) == 4 * (1 << k) // 8
    assert planes.plane_bytes(33) == 4 << 30
