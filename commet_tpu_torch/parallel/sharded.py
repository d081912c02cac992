"""More than one device: the mesh, the data-parallel routes (the index or the
plane set replicated, the read batch split), the key-range-sharded sorted
index, and the planes sharded on the word axis.

Counterpart of commet_tpu/parallel/sharded.py. PyTorch runs eagerly, so the
steps are functions over a ``Mesh``, an explicit list of ``torch.device``s,
where commet_tpu builds jitted ``shard_map``s over a ``jax.sharding.Mesh``:

  - a device may appear more than once in a mesh. A card repeated runs its
    shares one after another and holds one copy of what is replicated (a
    mesh of one card repeated is how the multi-device code runs, and is held
    to the single-device result, on a machine with one card); the CPU tests
    use a mesh of CPU shards, as commet_tpu's use 8 virtual CPU devices;
  - each step's per-device work is the single-device function on that
    device's inputs (the join kernel, the plane kernels, the exact probe);
    the merges are PyTorch ops on the mesh's first device: the concatenation
    of the shares' rows (DP), the max of the slices' join verdicts
    (key-range-sharded index), the OR of the shards' plane masks and of the
    slices' exact hits (commet_tpu's psum over a word that lives on one
    shard, and over runs that straddle a cut);
  - there is no row or SENTINEL padding: a share, a slice or a shard keeps
    its own length.

Nothing falls back: a mesh entry that cannot be reached raises, and so does
a kernel that fails to build or launch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from commet_tpu_torch.core import greedy, keys, planes, stream
from commet_tpu_torch.device import resolve_device

# CPU shards COMMET_TPU_DEVICES=all takes on the CPU: the virtual devices of
# commet_tpu's CPU tests (tests/conftest.py)
CPU_SHARDS = 8
# device memory assumed where the device reports none (the CPU): commet_tpu's
# v5e-class default, so the CPU tests pick the mode commet_tpu picks
DEFAULT_HBM_BYTES = 12 << 30


class Mesh:
    """An explicit list of devices of one type, one per mesh entry, in mesh
    order; a device may appear more than once. Counterpart of commet_tpu's
    one-axis ("d") Mesh."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{self.devices}")

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    @property
    def first(self) -> torch.device:
        """Where the merges run and the merged results land."""
        return self.devices[0]

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(devices) -> Mesh:
    """A Mesh of ``devices`` (names or torch.devices, repeats allowed), each
    resolved as the engine resolves its device: a CUDA device needs a card
    of that index, else RuntimeError; "cuda" is the current card."""
    out = []
    for d in devices:
        dev = resolve_device(d)
        if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"mesh device {dev} cannot be reached: "
                               f"{torch.cuda.device_count()} card(s) visible")
        out.append(dev)
    return Mesh(out)


def auto_mesh(device) -> Optional[Mesh]:
    """The mesh COMMET_TPU_DEVICES asks for on ``device``'s type: an integer
    count or "all"; None (single-device execution) when unset, "1" or
    "none". On "cuda" the count is of distinct cards, cuda:0 .. cuda:N-1,
    "all" every visible card, and fewer cards than asked raise RuntimeError
    (commet_tpu truncates to the chips it finds; the port hides no device).
    On "cpu" it is that many CPU shards ("all": CPU_SHARDS). A count below 1
    raises ValueError."""
    spec = os.environ.get("COMMET_TPU_DEVICES", "").strip().lower()
    if spec in ("", "1", "none"):
        return None
    dev = resolve_device(device)
    have = torch.cuda.device_count() if dev.type == "cuda" else CPU_SHARDS
    if spec == "all":
        n = have
    else:
        try:
            n = int(spec)
        except ValueError:
            raise ValueError(f"COMMET_TPU_DEVICES={spec!r}: an integer or "
                             "'all'") from None
        if n < 1:
            raise ValueError(f"COMMET_TPU_DEVICES={n}: at least 1 device")
    if n <= 1:
        return None
    if dev.type == "cpu":
        return Mesh([dev] * n)
    if n > have:
        raise RuntimeError(f"COMMET_TPU_DEVICES={spec} asks for {n} cards; "
                           f"{have} visible")
    return make_mesh([f"cuda:{i}" for i in range(n)])


def device_hbm_bytes(device, default: int = DEFAULT_HBM_BYTES) -> int:
    """The device's total memory (torch.cuda.mem_get_info on a card),
    ``default`` on the CPU. Counterpart of device_hbm_bytes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return default


def dp_fits(k: int, device="cpu", hbm_bytes: Optional[int] = None) -> bool:
    """Do the four planes (2^(k-1) bytes) fit in half of one device's memory?
    Then the data-parallel mode replicates them, else the planes shard on
    the word axis. On an H100 (80 GB) DP fits every k <= 36 the port
    supports, so plane mode runs only when asked for; on the CPU the 12 GiB
    default gives commet_tpu's choice (DP up to k = 33). Counterpart of
    dp_fits."""
    if hbm_bytes is None:
        hbm_bytes = device_hbm_bytes(device)
    return (1 << max(k - 1, 0)) <= hbm_bytes // 2


# --------------------------------------------------------------------------
# Data-parallel mode: one replica per mesh entry, the batch's rows split
# --------------------------------------------------------------------------

@dataclass
class Replicas:
    """A partition's sorted index (StreamIndex) or plane set replicated over
    a mesh: ``copies[d]`` lives on ``mesh.devices[d]``, one copy per distinct
    device (the entries of a repeated device share it)."""

    mesh: Mesh
    copies: list

    @property
    def sorted_index(self) -> bool:
        return isinstance(self.copies[0], stream.StreamIndex)


def _move(x, dev: torch.device):
    if isinstance(x, stream.StreamIndex):
        return stream.StreamIndex(*(_move(t, dev) for t in (
            x.ika, x.ikb, x.sb, x.sc, x.sd)))
    return x if x.device == dev else x.to(dev)


def replicate(x, mesh: Mesh) -> Replicas:
    """One copy of ``x`` (a tensor or a StreamIndex) per distinct device of
    the mesh; where ``x`` already lives, the copy is ``x`` itself, so a mesh
    of one card repeated costs no memory."""
    made = {dev: _move(x, dev) for dev in mesh.distinct()}
    return Replicas(mesh, [made[dev] for dev in mesh.devices])


def _shares(mesh: Mesh, *tensors):
    """Each tensor's rows cut into len(mesh) contiguous shares
    (torch.tensor_split: sizes differ by one at most), share d on mesh
    device d: [(tensors' share 0), (share 1), ...]."""
    parts = [torch.tensor_split(x, len(mesh)) for x in tensors]
    return [tuple(p[d].to(dev, non_blocking=True) for p in parts)
            for d, dev in enumerate(mesh.devices)]


def _dp(index: Replicas, fn, codes2, aux, dtype) -> torch.Tensor:
    """fn(copy, share's codes2, share's aux) on every share, the results
    concatenated in row order on the mesh's first device."""
    mesh = index.mesh
    outs = []
    for copy, (c2, ax) in zip(index.copies, _shares(mesh, codes2, aux)):
        if c2.shape[0] == 0:
            outs.append(torch.empty(0, dtype=dtype, device=mesh.first))
        else:
            outs.append(fn(copy, c2, ax).to(mesh.first))
    return torch.cat(outs)


def stream_search_step(index: Replicas, codes2, aux, clean: bool,
                       length: int, k: int, t: int,
                       wmax: Optional[int] = None) -> torch.Tensor:
    """Data-parallel stream probe: verdicts [B] int8 (VERDICT_*) of a packed
    batch (anywhere; ``aux`` the lengths when ``clean``, else the validity
    words) against a replicated StreamIndex. Share d runs the single-device
    probe (probe_stream_clean / _packed: keygen, query sort, the join kernel,
    the verdict sandwich) on mesh device d against its copy. Counterpart of
    stream_search_step; the port's int64 keys need no hi-bit stream at
    k > 32."""
    probe = stream.probe_stream_clean if clean else stream.probe_stream_packed
    return _dp(index, lambda sx, c2, ax: probe(sx, c2, ax, length, k, t,
                                               wmax),
               codes2, aux, torch.int8)


def stream_exact_step(index: Replicas, codes2, valid, length: int, k: int,
                      t: int, wmax: Optional[int] = None) -> torch.Tensor:
    """Data-parallel exact sorted-set probe: tags [B] bool, share d through
    probe_exact_sets on mesh device d. Counterpart of stream_exact_step."""
    return _dp(index, lambda sx, c2, vd: stream.probe_exact_sets(
        sx, c2, vd, length, k, t, wmax), codes2, valid, torch.bool)


def dp_probe_planes(index: Replicas, codes2, aux, clean: bool, length: int,
                    k: int, t: int, wmax: Optional[int] = None
                    ) -> torch.Tensor:
    """Data-parallel plane probe: tags [B] bool, share d through
    planes.probe_planes (the probe kernel) on mesh device d against its
    replica of the plane set. Counterpart of DP mode's batch-sharded probe
    (commet_tpu's GSPMD-partitioned cascade, whose final tags these are)."""
    return _dp(index, lambda pl, c2, ax: planes.probe_planes(
        pl, c2, ax, clean, length, k, t, wmax), codes2, aux, torch.bool)


# --------------------------------------------------------------------------
# Key-range-sharded sorted index
#
# The lexsorted (keya, keyb) pairs split into contiguous row ranges, one
# slice per mesh entry, and each of the four sorted value sets into equal
# parts. Every slice joins the full sorted query stream; the verdicts merge
# with a max, NONMEM (0) < CAND (1) < CONF (2). Soundness: a key outside a
# slice is NONMEM there (the join searches the whole slice), so all-NONMEM
# means absent everywhere; an equal-keya run cut between two slices gives
# CAND on one and CONF on the other, and CONF wins, as it must when the exact
# pair lies in either. The port has no RESIDUAL verdict. Exact hits OR across
# slices (an equal-value run may straddle a cut).
# --------------------------------------------------------------------------

def shard_stream_index(sidx: stream.StreamIndex, n: int,
                       mesh: Optional[Mesh] = None) -> Dict[str, list]:
    """Cut a StreamIndex into n key-range slices: {"ika", "ikb": slice d's
    pair columns, "mi_loc": their lengths, "sets": slice d's (sa, sb, sc, sd)
    parts, "set_mi": their lengths}; each count sums to sidx.mi. Slices are
    views on sidx's device, or with ``mesh`` (n entries) copies on mesh
    device d where that is another device. Counterpart of
    shard_stream_index, without SENTINEL padding."""
    if mesh is not None and len(mesh) != n:
        raise ValueError(f"{n} slices for a mesh of {len(mesh)}")

    def place(parts):
        if mesh is None:
            return list(parts)
        return [_move(p, dev) for p, dev in zip(parts, mesh.devices)]

    ika = place(torch.tensor_split(sidx.ika, n))
    ikb = place(torch.tensor_split(sidx.ikb, n))
    cut = [place(torch.tensor_split(s, n))
           for s in (sidx.sa, sidx.sb, sidx.sc, sidx.sd)]
    sets = [tuple(c[d] for c in cut) for d in range(n)]
    return {"ika": ika, "ikb": ikb, "mi_loc": [int(a.shape[0]) for a in ika],
            "sets": sets, "set_mi": [int(s[0].shape[0]) for s in sets]}


def _batch_on(mesh: Mesh, codes2, aux):
    """{device: the whole batch on it}, for each distinct device of the
    mesh (every slice or shard takes the whole batch)."""
    return {dev: (codes2.to(dev, non_blocking=True),
                  aux.to(dev, non_blocking=True)) for dev in mesh.distinct()}


def _window_keys_on(mesh: Mesh, codes2, aux, clean: bool, length: int,
                    k: int, wmax: Optional[int]):
    """{device: window keys of the whole batch on it} (_batch_on)."""
    unpack = keys.unpack_codes_clean if clean else keys.unpack_codes
    return {dev: keys.window_keys(unpack(c2, ax, length), k, "both", wmax)
            for dev, (c2, ax) in _batch_on(mesh, codes2, aux).items()}


def sharded_stream_step(mesh: Mesh, shards, codes2, aux, clean: bool,
                        length: int, k: int, t: int,
                        wmax: Optional[int] = None) -> torch.Tensor:
    """Stream probe against a key-range-sharded index (shard_stream_index
    over ``mesh``): verdicts [B] int8 on the mesh's first device. Each
    distinct device makes the batch's sorted query stream once; slice d
    joins it on mesh device d (the join kernel); the verdicts are
    max-merged, unsorted and max-merged across devices on the first, then
    take the verdict sandwich (_multi_verdicts). Counterpart of
    sharded_stream_step, at every k <= 36."""
    wks = _window_keys_on(mesh, codes2, aux, clean, length, k, wmax)
    queries = {dev: stream._sorted_queries(wk) for dev, wk in wks.items()}
    merged_s: Dict[torch.device, torch.Tensor] = {}
    for d, dev in enumerate(mesh.devices):
        sk, skb, _perm = queries[dev]
        mem = stream.join_membership(shards["ika"][d], shards["ikb"][d],
                                     shards["mi_loc"][d], sk, skb)
        merged_s[dev] = (mem if dev not in merged_s
                         else torch.maximum(merged_s[dev], mem))
    merged = None
    for dev, mem_s in merged_s.items():
        mem = torch.empty_like(mem_s)
        mem[queries[dev][2]] = mem_s
        mem = mem.to(mesh.first)
        merged = mem if merged is None else torch.maximum(merged, mem)
    ok = wks[mesh.first]["ok"]
    b, w = ok.shape
    return stream._multi_verdicts(ok, merged.reshape(b, 2, w)[None], k, t)[0]


def sharded_exact_step(mesh: Mesh, shards, codes2, valid, length: int,
                       k: int, t: int,
                       wmax: Optional[int] = None) -> torch.Tensor:
    """Exact sorted-set probe against key-range-sharded value sets: tags [B]
    bool. Per strand and set, membership in each slice (on its device), OR
    over slices, then AND over the four sets and the greedy count on the
    first device: probe_exact_sets' tags. Counterpart of
    sharded_exact_step."""
    wks = _window_keys_on(mesh, codes2, valid, False, length, k, wmax)
    hits: Dict[torch.device, list] = {}
    for d, dev in enumerate(mesh.devices):
        wk = wks[dev]
        sa, sb, sc, sd = shards["sets"][d]
        got = []
        for p in ("f", "r"):
            a, b = wk[p + "a"], wk[p + "b"]
            got += [stream._in_sorted(sa, a), stream._in_sorted(sb, b),
                    stream._in_sorted(sc, a ^ b), stream._in_sorted(sd, a | b)]
        hits[dev] = got if dev not in hits else [
            x | y for x, y in zip(hits[dev], got)]
    merged = None
    for got in hits.values():
        got = [x.to(mesh.first) for x in got]
        merged = got if merged is None else [x | y
                                             for x, y in zip(merged, got)]
    ok = wks[mesh.first]["ok"]
    tagged = None
    for s in range(2):
        member = ok
        for x in merged[4 * s:4 * s + 4]:
            member = member & x
        tag = greedy.greedy_ge(member, k, t)
        tagged = tag if tagged is None else tagged | tag
    return tagged


# --------------------------------------------------------------------------
# Plane mode: the four planes sharded on the word axis (k too large for one
# device's memory, or asked for)
# --------------------------------------------------------------------------

@dataclass
class PlaneShards:
    """A four-plane set sharded on the word axis over a mesh: shard d
    ([4 * wl] int32 on mesh.devices[d]) holds words [d * wl, (d + 1) * wl)
    of each plane, plane p at [p * wl, (p + 1) * wl)."""

    mesh: Mesh
    k: int
    shards: List[torch.Tensor]

    @property
    def wl(self) -> int:
        return self.shards[0].numel() // 4

    def assembled(self) -> torch.Tensor:
        """The single-device layout [4 * plane_words(k)] int32 on the first
        device: the shards as [n, 4, wl] -> [4, n * wl]."""
        parts = torch.stack([s.to(self.mesh.first).view(4, self.wl)
                             for s in self.shards])
        return parts.permute(1, 0, 2).reshape(-1)


def alloc_planes_sharded(k: int, mesh: Mesh) -> PlaneShards:
    """Zeroed plane shards of k's four planes over ``mesh``; ValueError when
    plane_words(k) is not a multiple of the mesh size. Counterpart of
    alloc_planes_sharded."""
    w = planes.plane_words(k)
    if w % len(mesh) != 0:
        raise ValueError(f"plane words {w} not divisible by mesh size "
                         f"{len(mesh)}")
    wl = w // len(mesh)
    return PlaneShards(mesh, k, [torch.zeros(4 * wl, dtype=torch.int32,
                                             device=dev)
                                 for dev in mesh.devices])


def build_planes_sharded(ps: PlaneShards, codes2, aux, clean: bool,
                         length: int) -> PlaneShards:
    """Set the plane bits of a packed batch's complete forward windows in
    every shard, in place: each shard's device receives the whole batch and
    the ranged build kernel (planes.build_planes_range) sets only the bits
    whose word lies in the shard. Counterpart of build_search_step's
    build_fn."""
    batch = _batch_on(ps.mesh, codes2, aux)
    for d, (dev, shard) in enumerate(zip(ps.mesh.devices, ps.shards)):
        planes.build_planes_range(shard, *batch[dev], clean, length, ps.k,
                                  d * ps.wl, ps.wl)
    return ps


def probe_planes_sharded(ps: PlaneShards, codes2, aux, clean: bool,
                         length: int, t: int,
                         wmax: Optional[int] = None) -> torch.Tensor:
    """Tags [B] bool of a packed batch against a sharded plane set, on the
    mesh's first device: every shard's device runs the ranged probe kernel
    (planes.probe_planes_part) over the whole batch, the 4-bit masks are
    OR-merged (per device, then on the first: a word lives on one shard, so
    this is commet_tpu's psum), a window is a member where all four bits are
    set, and either strand's greedy count reaching t tags the read.
    Counterpart of build_search_step's search_fn."""
    batch = _batch_on(ps.mesh, codes2, aux)
    masks: Dict[torch.device, torch.Tensor] = {}
    for d, (dev, shard) in enumerate(zip(ps.mesh.devices, ps.shards)):
        m = planes.probe_planes_part(shard, *batch[dev], clean, length, ps.k,
                                     d * ps.wl, ps.wl, wmax)
        masks[dev] = m if dev not in masks else masks[dev] | m
    merged = None
    for m in masks.values():
        m = m.to(ps.mesh.first)
        merged = m if merged is None else merged | m
    member = merged == 15
    return (greedy.greedy_ge(member[:, 0], ps.k, t)
            | greedy.greedy_ge(member[:, 1], ps.k, t))


def full_pair_step(ps: PlaneShards, index_batch, query_batch, t: int):
    """One pair comparison over the mesh: build the sharded planes from an
    index batch, tag a query batch, count the shared reads (commet_tpu's
    popcount_psum). Batches are (codes2, aux, clean, length). Returns
    (ps, tags, count). Counterpart of full_pair_step."""
    build_planes_sharded(ps, *index_batch)
    tags = probe_planes_sharded(ps, *query_batch, t)
    return ps, tags, int(tags.sum())
