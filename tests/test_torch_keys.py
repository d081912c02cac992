"""Keygen and greedy counting of the PyTorch port against commet_tpu's JAX
functions on the same numpy-seeded inputs. Everything is integer-valued, so
the tolerance is exact equality."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.core import stream as jstream
from commet_tpu_torch.core import greedy, keys
from torch_helpers import encode, random_seqs


def _full(wk, name):
    """JAX (lo, hi) uint32 key halves -> whole int64 keys."""
    lo = np.asarray(wk[name + "_lo"]).astype(np.int64)
    hi = np.asarray(wk[name + "_hi"]).astype(np.int64)
    return lo | (hi << 32)


@pytest.mark.parametrize("k", [8, 15, 21, 31, 32, 33, 34])
def test_window_keys_match_jax(k):
    """Both strands, N bases, lengths not a multiple of 32, and a window
    count past the read end (wmax > L - k + 1 pads with invalid bases)."""
    rng = np.random.default_rng(100 + k)
    seqs = random_seqs(rng, 24, max(1, k - 3), 3 * k + 7, n_frac=0.04)
    seqs.append(b"T" * (k + 5))  # all-G/T keya = all ones
    codes = encode(seqs).astype(np.int32)
    length = codes.shape[1]
    for wmax in (None, length - k + 4):
        want = kernels.window_keys(jnp.asarray(codes), k, "both", wmax)
        got = keys.window_keys(torch.from_numpy(codes), k, "both", wmax)
        ok = np.asarray(want["ok"])
        np.testing.assert_array_equal(got["ok"].numpy(), ok)
        assert ok.any()
        for p in ("fa", "fb", "ra", "rb"):
            np.testing.assert_array_equal(got[p].numpy()[ok],
                                          _full(want, p)[ok], err_msg=p)


@pytest.mark.parametrize("k", [15, 32])
def test_unpack_codes_match_jax(k):
    rng = np.random.default_rng(7 + k)
    seqs = random_seqs(rng, 30, 1, 83, n_frac=0.05)
    codes_u8 = encode(seqs)
    length = codes_u8.shape[1]
    c2, vd = kernels.pack_codes_np(codes_u8)
    want = np.asarray(kernels.unpack_codes(jnp.asarray(c2), jnp.asarray(vd),
                                           length))
    got = keys.unpack_codes(keys.host_u32(c2), keys.host_u32(vd), length)
    np.testing.assert_array_equal(got.numpy(), want)

    clean = encode(random_seqs(rng, 30, 1, 83, n_frac=0.0), length)
    lens = (clean < 4).sum(axis=1).astype(np.int32)
    c2 = kernels.pack_codes2_np(clean)
    want = np.asarray(kernels.unpack_codes_clean(
        jnp.asarray(c2), jnp.asarray(lens), length))
    got = keys.unpack_codes_clean(keys.host_u32(c2), torch.from_numpy(lens),
                                  length)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), clean)


@pytest.mark.parametrize("t", [1, 2, 3, 17])
@pytest.mark.parametrize("k", [4, 21])
def test_greedy_ge_matches_jax(t, k):
    """t=1 any, t=2 span, t<=16 pointer jumps, t=17 the sequential count."""
    rng = np.random.default_rng(1000 + 10 * t + k)
    member = rng.random((64, 90)) < rng.uniform(0.02, 0.6, (64, 1))
    want = np.asarray(kernels.greedy_ge(jnp.asarray(member), k, t))
    got = greedy.greedy_ge(torch.from_numpy(member), k, t)
    np.testing.assert_array_equal(got.numpy(), want)
    if t > 2:
        np.testing.assert_array_equal(
            greedy.greedy_count_fast(torch.from_numpy(member), k, t).numpy(),
            greedy.greedy_count(torch.from_numpy(member), k, t).numpy())


def test_index_keys_drop_invalid_windows():
    """The port drops invalid windows with a mask (JAX maps them to
    SENTINEL): the valid keys are the JAX chunk's non-flagged entries."""
    k = 32
    rng = np.random.default_rng(5)
    seqs = random_seqs(rng, 20, 20, 90) + [b"G" * 40 + b"T" * 8]
    codes = encode(seqs).astype(np.int32)
    ka, kb, _hib, flags, cnt = jstream.chunk_index_keys_codes(
        jnp.asarray(codes), k)
    keep = np.asarray(flags) == 0
    a, b = keys.index_keys(torch.from_numpy(codes), k)
    assert a.shape[0] == int(cnt)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ka)[keep])
    np.testing.assert_array_equal(b.numpy(), np.asarray(kb)[keep])
    assert (a.numpy() == 0xFFFFFFFF).any()  # the all-G/T key survives
