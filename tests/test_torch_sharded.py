"""The port's multi-device steps (parallel/sharded.py) on a mesh of 8 CPU
shards, against commet_tpu's on its 8-device CPU mesh (tests/conftest.py)
and against the port's single-device functions, on the constructions of
tests/test_sharded.py: the word-sharded plane build and search, the full
pair step's count, the key-range-sharded sorted index with its exact
fallback, the data-parallel stream and exact probes, and the refusals.
Tags, verdicts, plane words and counts: exact equality throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from commet_tpu.core import kernels
from commet_tpu.core import stream as jstream
from commet_tpu.parallel import sharded as jsharded
from commet_tpu_torch.core import keys, planes, stream
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.parallel import sharded

N_DEV = 8


@pytest.fixture(scope="module")
def meshes():
    if len(jax.devices()) < N_DEV:
        pytest.skip("needs 8 virtual devices")
    return jsharded.make_mesh(N_DEV), sharded.Mesh(["cpu"] * N_DEV)


def _codes_pair(seed, k, n=64, lpad=96):
    """test_sharded.py's reads: random index codes; query codes with 5%
    invalid bases and a 2k fragment of an index read in half the rows."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    qry = rng.integers(0, 4, size=(n, lpad)).astype(np.int32)
    qry[rng.random(size=qry.shape) < 0.05] = 4
    qry[: n // 2, 20: 20 + 2 * k] = idx[: n // 2, 8: 8 + 2 * k]
    return idx, qry


def _packed(codes):
    """The port's dirty wire format of [n, L] codes: (codes2, valid, False,
    L)."""
    c2, vd = kernels.pack_codes_np(codes.astype(np.uint8))
    return keys.host_u32(c2), keys.host_u32(vd), False, codes.shape[1]


@pytest.mark.parametrize("k", [15, 18])
def test_word_sharded_planes_match_jax(meshes, k):
    """build_planes_sharded + probe_planes_sharded against commet_tpu's
    build_search_step: equal tags; the shards reassembled ([n, 4, wl] ->
    [4, n * wl]) equal commet_tpu's sharded planes and the port's
    single-device planes."""
    jmesh, mesh = meshes
    t = 2
    idx, qry = _codes_pair(5, k)
    jplanes = jsharded.alloc_planes_sharded(k, jmesh)
    build_fn, search_fn = jsharded.build_search_step(jmesh, k, t)
    jplanes = build_fn(jplanes, jnp.asarray(idx))
    jtags = np.asarray(search_fn(jplanes, jnp.asarray(qry)))

    ps = sharded.alloc_planes_sharded(k, mesh)
    sharded.build_planes_sharded(ps, *_packed(idx))
    tags = sharded.probe_planes_sharded(ps, *_packed(qry), t)
    np.testing.assert_array_equal(tags.numpy(), jtags)
    assert jtags[:32].all()
    flat = ps.assembled()
    np.testing.assert_array_equal(flat.numpy().view(np.uint32),
                                  np.asarray(jplanes).reshape(-1))
    single = planes.alloc_planes(k, "cpu")
    planes.build_planes(single, *_packed(idx), k)
    assert torch.equal(flat, single)
    assert torch.equal(tags, planes.probe_planes(single, *_packed(qry), k, t))


def test_full_pair_step_count_matches_jax(meshes):
    """full_pair_step's tags and shared count equal commet_tpu's."""
    jmesh, mesh = meshes
    k, t = 15, 2
    idx, qry = _codes_pair(11, k)
    step = jsharded.full_pair_step(jmesh, k, t)
    _p, jtags, jcount = step(jsharded.alloc_planes_sharded(k, jmesh),
                             jnp.asarray(idx), jnp.asarray(qry))
    ps, tags, count = sharded.full_pair_step(
        sharded.alloc_planes_sharded(k, mesh), _packed(idx), _packed(qry), t)
    np.testing.assert_array_equal(tags.numpy(), np.asarray(jtags))
    assert count == int(jcount) == int(tags.sum()) > 0
    assert len(ps.shards) == N_DEV


def _stream_case(k=15, seed=4321, n_idx=90, n_qry=128, length=64):
    """test_sharded.py's key-range construction: random index reads; half
    the queries hold a 2k fragment of an index read."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 4, size=(n_idx, length)).astype(np.int32)
    qry = rng.integers(0, 4, size=(n_qry, length)).astype(np.int32)
    half = n_qry // 2
    frag = 2 * k
    dn = idx[rng.integers(0, n_idx, size=half)]
    ds = rng.integers(0, length - frag + 1, size=half)
    qs = rng.integers(0, length - frag + 1, size=half)
    rows = np.arange(half)[:, None]
    cols = np.arange(frag)
    qry[rows, qs[:, None] + cols] = dn[rows, ds[:, None] + cols]
    return idx, qry


def _jax_stream_tags(idx, qry, k, t, wmax, jmesh=None):
    """commet_tpu's final tags: the stream verdicts (single device, or its
    key-range-sharded step over ``jmesh``) and the exact fallback."""
    ka, kb, hib, flags, cnt = jstream.chunk_index_keys_codes(
        jnp.asarray(idx), k)
    sx = jstream.finalize_index([ka], [kb], [hib], [flags], [int(cnt)], ki=2)
    length = qry.shape[1]
    qc2, qvd = kernels.pack_codes_np(qry.astype(np.uint8))
    if jmesh is None:
        v = np.asarray(jstream.probe_cascade2_stream_codes(
            sx.ika, sx.ikb, sx.mi, jnp.asarray(qry), k, t, wmax, 512, ki=2,
            interpret=True))
        exact = lambda rows: np.asarray(jstream.probe_exact_sets(  # noqa
            sx.sa, sx.sb, sx.sc, sx.sd, sx.mi, jnp.asarray(qc2[rows]),
            jnp.asarray(qvd[rows]), length, k, t, wmax))
    else:
        shards = jsharded.shard_stream_index(sx, N_DEV, ki=2)
        step = jsharded.sharded_stream_step(jmesh, length, k, t, wmax, 512,
                                            ki=2, interpret=True)
        v = np.asarray(step(shards["ika"], shards["ikb"], shards["mi_loc"],
                            jnp.asarray(kernels.pack_codes2_np(
                                qry.astype(np.uint8))),
                            jnp.full((len(qry),), length, jnp.int32)))
        ex = jsharded.sharded_exact_step(jmesh, length, k, t, wmax)
        exact = lambda rows: np.asarray(ex(  # noqa
            shards["sets"], shards["set_mi"], jnp.asarray(qc2[rows]),
            jnp.asarray(qvd[rows])))
    tags = v == kernels.VERDICT_TAGGED
    amb = np.nonzero(v == kernels.VERDICT_AMBIG)[0]
    if len(amb):
        tags[amb] = exact(amb)
    return tags


def _port_index(idx, k):
    return stream.finalize_index(*[[x] for x in keys.index_keys(
        torch.from_numpy(idx.astype(np.int64)), k)])


def test_key_range_sharded_stream_matches(meshes):
    """shard_stream_index into 8 slices (mi_loc and set_mi sum to mi), the
    max-merged verdicts of sharded_stream_step (decided ones never
    contradict the single join path's final tags), then
    sharded_exact_step for the AMBIG residue: the final tags equal the
    port's single-device path's, commet_tpu's single-device tags and its
    key-range-sharded tags."""
    jmesh, mesh = meshes
    k, t = 15, 2
    idx, qry = _stream_case(k)
    length = qry.shape[1]
    wmax = length - k + 1
    sx = _port_index(idx, k)
    c2, vd, _clean, _l = _packed(qry)
    v1 = stream.probe_stream_packed(sx, c2, vd, length, k, t, wmax)
    want = v1 == stream.VERDICT_TAGGED
    amb1 = v1 == stream.VERDICT_AMBIG
    want[amb1] = stream.probe_exact_sets(sx, c2[amb1], vd[amb1], length, k,
                                         t, wmax)

    shards = sharded.shard_stream_index(sx, N_DEV, mesh)
    assert sum(shards["mi_loc"]) == sum(shards["set_mi"]) == sx.mi
    assert len(shards["ika"]) == N_DEV and min(shards["mi_loc"]) > 0
    v8 = sharded.sharded_stream_step(mesh, shards, c2, vd, False, length, k,
                                     t, wmax)
    dec = v8 != stream.VERDICT_AMBIG
    assert torch.equal((v8 == stream.VERDICT_TAGGED)[dec], want[dec])
    tags = v8 == stream.VERDICT_TAGGED
    amb = ~dec
    if amb.any():
        tags[amb] = sharded.sharded_exact_step(mesh, shards, c2[amb],
                                               vd[amb], length, k, t, wmax)
    assert torch.equal(tags, want)
    assert int(tags.sum()) > 0
    np.testing.assert_array_equal(tags.numpy(),
                                  _jax_stream_tags(idx, qry, k, t, wmax))
    np.testing.assert_array_equal(
        tags.numpy(), _jax_stream_tags(idx, qry, k, t, wmax, jmesh))


def test_dp_stream_and_exact_match(meshes):
    """stream_search_step on a replicated index (clean and dirty batches)
    gives the single-device verdicts row for row; stream_exact_step the
    single-device exact tags; the final tags equal commet_tpu's
    data-parallel stream_search_step with its exact fallback."""
    jmesh, mesh = meshes
    k, t = 15, 2
    idx, qry = _stream_case(k, seed=99, n_qry=136)
    length = qry.shape[1]
    wmax = length - k + 1
    sx = _port_index(idx, k)
    reps = sharded.replicate(sx, mesh)
    assert all(c is sx.ika for c in (r.ika for r in reps.copies))
    c2, vd, _clean, _l = _packed(qry)
    lens = torch.full((len(qry),), length, dtype=torch.int32)
    for aux, clean in ((vd, False), (lens, True)):
        probe = (stream.probe_stream_clean if clean
                 else stream.probe_stream_packed)
        v1 = probe(sx, c2, aux, length, k, t, wmax)
        v8 = sharded.stream_search_step(reps, c2, aux, clean, length, k, t,
                                        wmax)
        assert torch.equal(v8, v1)
    exact = sharded.stream_exact_step(reps, c2, vd, length, k, t, wmax)
    assert torch.equal(exact, stream.probe_exact_sets(sx, c2, vd, length, k,
                                                      t, wmax))

    ka, kb, hib, flags, cnt = jstream.chunk_index_keys_codes(
        jnp.asarray(idx), k)
    jsx = jstream.finalize_index([ka], [kb], [hib], [flags], [int(cnt)],
                                 ki=2)
    step = jsharded.stream_search_step(jmesh, length, k, t, wmax, 512, ki=2,
                                       interpret=True)
    jv = np.asarray(step(jsx.ika, jsx.ikb, jsx.mi, jnp.asarray(
        kernels.pack_codes2_np(qry.astype(np.uint8))),
        jnp.full((len(qry),), length, jnp.int32)))
    jtags = jv == kernels.VERDICT_TAGGED
    jamb = jv == kernels.VERDICT_AMBIG
    jtags[jamb] = exact.numpy()[jamb]
    tags = v8 == stream.VERDICT_TAGGED
    amb = v8 == stream.VERDICT_AMBIG
    tags[amb] = exact[amb]
    np.testing.assert_array_equal(tags.numpy(), jtags)
    assert int(tags.sum()) > 0


def test_mesh_refusals():
    """Plane words not divisible by the mesh size, a batch not divisible
    by it, an unknown mesh mode and a mesh of other devices raise
    ValueError, as commet_tpu's build_search_step and Engine do."""
    three = sharded.Mesh(["cpu"] * 3)
    with pytest.raises(ValueError, match="not divisible by mesh size 3"):
        sharded.alloc_planes_sharded(15, three)
    with pytest.raises(ValueError, match="batch must divide evenly"):
        tengine.Engine(k=15, t=2, device="cpu", batch=4096, mesh=three)
    with pytest.raises(ValueError, match="mesh_mode"):
        tengine.Engine(k=15, t=2, device="cpu", batch=4095, mesh=three,
                       mesh_mode="words")
    with pytest.raises(ValueError, match="one type"):
        sharded.Mesh(["cpu", "meta"])


def test_auto_mesh_and_mode_choice(monkeypatch):
    """COMMET_TPU_DEVICES: unset or 1 means no mesh; N gives N CPU shards
    on the CPU; 0 raises; on "cuda" without a card, RuntimeError (no CPU
    takes over). dp_fits picks commet_tpu's mode at its 12 GiB default, an
    80 GB card takes DP up to k = 36; replicas of a repeated device share
    one tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("COMMET_TPU_DEVICES", raising=False)
    assert sharded.auto_mesh("cpu") is None
    for spec, n in (("1", None), ("4", 4), ("all", sharded.CPU_SHARDS)):
        monkeypatch.setenv("COMMET_TPU_DEVICES", spec)
        mesh = sharded.auto_mesh("cpu")
        assert (mesh if n is None else len(mesh)) == n
    monkeypatch.setenv("COMMET_TPU_DEVICES", "0")
    with pytest.raises(ValueError):
        sharded.auto_mesh("cpu")
    monkeypatch.setenv("COMMET_TPU_DEVICES", "2")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sharded.auto_mesh("cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sharded.make_mesh(["cuda:0", "cuda:0"])
    for k in (15, 33, 34, 36):
        assert sharded.dp_fits(k) == jsharded.dp_fits(k, 12 << 30)
        assert sharded.dp_fits(k, hbm_bytes=80 * 10 ** 9)
    x = torch.arange(5)
    reps = sharded.replicate(x, sharded.Mesh(["cpu"] * 3))
    assert all(c is x for c in reps.copies)
