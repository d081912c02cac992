"""The index -> search engine of index_and_search (reference
src/index_and_search.cpp), served by the sorted-join stream probe or by the
dense bit planes.

Counterpart of commet_tpu/engine/engine.py:
  - eligible reads go to the kernels in batches of 2-bit packed tensors. On
    the card without a mesh, each public call uploads a set's one-byte codes
    once (EncodedSet.upload) and every batch is gathered and packed there by
    core/pack.py's kernel; on the CPU, with a mesh, or where the codes do not
    fit beside what the call needs, the host packs (the native gather+pack
    on a prefetch thread; on CUDA the batches land in pinned memory and
    upload with non-blocking copies);
  - partition boundaries follow the reference's read-granular cursor,
    including the read dropped at every partition boundary
    (index_reads.h:49-61) and found-read skipping between partitions
    (file_manager.h:99-109);
  - each partition is decided before it is built, from its fill (k-mers /
    2^k), as commet_tpu decides it: at or below ``stream_max_fill`` the
    valid forward windows' (keya, keyb) pairs are sorted into a StreamIndex
    and every still-untagged query read goes through the stream probe
    (keygen, query sort, join kernel, verdict sandwich) and the AMBIG residue
    through the exact sorted-set probe; above it the partition's windows are
    set in four dense bit planes of 2^k bits (core/planes.py) and every query
    read goes through the exact plane probe.

``COMMET_TPU_STREAM`` and ``COMMET_TPU_STREAM_MAX_FILL`` are read as
commet_tpu reads them: ``force`` serves every partition by the sorted index,
``0`` every partition by the planes, anything else the gate (0.02 by
default). Tags are exact on either route.

The amortized all-vs-all schedule keeps every step-0 index set resident:
below the gate as sorted indexes (``build_resident``; ``search_multi_set``:
one query sort, one grouped join launch per group of partitions, one
unsort), above it as plane sets (``build_resident_planes``;
``search_multi_set_planes``: one upload per batch, one grouped probe launch
per group of plane sets), with the same tags, counters and files as the
pairwise calls.

Batches are sized by ``stream_batch_size``: at most STREAM_BATCH reads, fewer
when long reads would make a batch's window keys exceed what the device
budget per batch holds; where even the floor of STREAM_MIN_BATCH reads is too
large, search_set takes the exact probe and search_multi_set declines.

The environment switches commet_tpu's engine reads, read as it reads them
when the engine is made: ``COMMET_TPU_STREAM_BATCH``,
``COMMET_TPU_PROBE_BATCH`` and ``COMMET_TPU_BUILD_BATCH`` (``int(...)``)
replace the STREAM_BATCH cap of the stream probe, the plane probe and the
index builds (the memory clamps still apply on top); ``COMMET_TPU_PREFETCH=0``
makes each host batch inline, without the prefetch thread (the batches
packed on the card are made inline always); and
``COMMET_TPU_PROFILE=<dir>`` (read at each call, as commet_tpu reads it)
runs every public call (``index_and_search``, ``build_resident``,
``build_resident_planes``, ``search_multi_set``,
``search_multi_set_planes``) under ``torch.profiler`` and writes one Chrome
trace per call into ``<dir>``, with the engine's spans (trace.py) on their
own threads beside the card's work. ``COMMET_TPU_BULK_BUILD`` picks the
dense-plane build: ``0`` the per-batch build (planes.build_planes), ``force``
the bulk build (planes.BulkChunk; on the CPU its plain version), unset or
``1`` on the card the route CARD_BULK_BUILD names and on the CPU the
per-batch build; never the bulk build with a mesh. ``COMMET_TPU_BULK_CHUNK``
sets the window slots of a bulk chunk (bulk_chunk). The planes are the same
bits on either route.

With a mesh (parallel/sharded.py: an explicit list of devices, repeats
allowed) the engine runs commet_tpu's multi-device modes: ``dp`` replicates
each partition's sorted index or plane set (built on the mesh's first
device) and splits every search batch's rows over the mesh; ``plane`` shards
every partition's planes on the word axis (no sorted index) and probes the
whole batch on every shard. The amortized schedule declines with a mesh, so
the driver takes the classic rounds, as commet_tpu's does.

Spans (trace.py), recorded while ``torch.profiler`` runs: ``call.<name>``
around each public call; ``host.pack`` (attributes ``reads`` and ``route``)
around each batch: on the host route on the prefetch thread, with
``host.gather`` and, on the card, ``host.pin`` inside it; on the device
route around the pack kernel's launch, inline; ``pack.upload`` (attribute
``bytes``) around the device route's uploads of a set's codes (once a call,
before its batch loops) and of a batch loop's read ids, outside
``host.wait``; ``host.wait`` where the dispatch loop waits for a batch (on
the device route, around each launch); ``search.select`` (the
candidates and their lengths), ``search.fetch`` (the verdicts' copies to
the host) and ``search.finish`` (counters, tags and files) around a
search's batch loop; ``build.count`` and ``build.partition``
(count_kmers, partitions); ``io.write`` (the .bv and .log files).
``host.pack``, ``host.wait``, ``pack.upload`` and ``search.fetch`` are the
blocks that ``last_io_stats`` sums.

There is no CPU fallback: the engine runs on the device it is given.
"""

from __future__ import annotations

import functools
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from commet_tpu_torch import trace
from commet_tpu_torch.core import keys, pack, planes, stream
from commet_tpu_torch.device import resolve_device, synchronize
from commet_tpu_torch.io.reads import ReadSet
from commet_tpu_torch.native import parser as native
from commet_tpu_torch.parallel import sharded

# reads per host batch of the exact fallback
DEFAULT_BATCH = 4096
# reads per device batch of the index builds and the stream and plane
# probes, at most (each path's default; COMMET_TPU_BUILD_BATCH,
# COMMET_TPU_STREAM_BATCH and COMMET_TPU_PROBE_BATCH override it)
STREAM_BATCH = 65536
# ... and at least, unless the set is smaller (commet_tpu's floor)
STREAM_MIN_BATCH = 2048
LENGTH_BUCKET = 32
# device bytes per indexed k-mer: the resident StreamIndex (ika, ikb and the
# sb/sc/sd sets, 5 x int64) plus the build's sort workspace
INDEX_BYTES_PER_KMER = 40
BUILD_BYTES_PER_KMER = 96
# Device bytes a stream batch may hold, and what it holds per window key
# (one read x strand x window). Keygen keeps about a dozen [B, L] int64
# tensors at once (codes, the valid/a/b bit planes, the binary-lifting
# operands, fa/fb/ra/rb); the query sort then holds the stacked and masked
# query pairs, the sorted keys, the permutation and the gathered keyb (8 B
# each) plus the radix sort's double buffers. Measured peak: 80 B per key
# for a 65,536-read batch of 100 bp reads at k = 32, at S = 1 and S = 3
# (NVIDIA H100 80GB HBM3, chip_smoke.py); 128 B leaves room. Each slot of a
# grouped join adds its int8 verdicts, sorted and unsorted, and the greedy
# bounds' int64 positions over [S, B, W]: 16 B per key and slot. At 100 bp
# reads, k = 32 and 32 slots a 65,536-read batch (9.0M keys) is allowed
# 5.8 GB.
# (commet_tpu's 2^30-key cap exists for its uint32 packed unsort; at int64
# it would be more than the card holds.)
STREAM_BATCH_BYTES = 8 << 30
STREAM_BYTES_PER_KEY = 128
SLOT_BYTES_PER_KEY = 16
# widest k a resident index serves (commet_tpu's multi-index domain)
RESIDENT_MAX_K = 34
# the fill gate: a partition whose k-mers / 2^k exceed it takes the planes
# (commet_tpu's stream_max_fill; COMMET_TPU_STREAM_MAX_FILL overrides)
STREAM_MAX_FILL = 0.02
# device bytes kept free beside plane sets: the per-batch build and the probe
# kernels need only a batch's upload and tags, so this is a margin for the
# allocator and the refinement calls' batches (the bulk build's chunk
# workspace, planes.bulk_workspace_bytes, is counted on top)
PLANES_WORKSPACE_BYTES = 2 << 30
# window slots of one bulk-build chunk (planes.BulkChunk), commet_tpu's
# defaults: 2^27 at k >= 32 (its sort operands beside 4 GiB planes), 2^28
# below, and 2^26 at k >= 32 for a set built beside resident plane sets (the
# plane cohorts); COMMET_TPU_BULK_CHUNK replaces all three
BULK_CHUNK = 1 << 28
BULK_CHUNK_WIDE = 1 << 27
BULK_CHUNK_BESIDE = 1 << 26
# the dense-plane build the card takes when COMMET_TPU_BULK_BUILD is unset or
# 1: the bulk build (True) or the per-batch build (False), whichever
# chip_smoke.py phase 14 measures faster for one default partition (k = 33,
# 999.6M windows, 11.6% fill; PERF.md section 5)
CARD_BULK_BUILD = True


def max_kmer_for(k: int) -> int:
    """Partition cap: (unsigned long)(1e9 / 2^(33-k))
    (reference index_and_search.cpp:73,146)."""
    return int(1000000000.0 / (2.0 ** (33 - k)))


def stream_max_keys(slots: int = 1) -> int:
    """Window keys one stream batch may hold, joined against ``slots``."""
    return STREAM_BATCH_BYTES // (STREAM_BYTES_PER_KEY
                                  + slots * SLOT_BYTES_PER_KEY)


def stream_batch_size(n_reads: int, wmax: int, slots: int = 1,
                      limit: int = STREAM_BATCH) -> Optional[int]:
    """Reads per stream batch for ``n_reads`` reads of up to ``wmax``
    windows (every batch is padded to the longest read): ``limit``, halved
    while the batch's window keys (reads x 2 strands x wmax) exceed
    stream_max_keys, down to the floor of STREAM_MIN_BATCH reads; None when
    even the floor exceeds it.
    Counterpart of the geometry of commet_tpu's Engine._search_stream_only
    and search_multi_set."""
    cap = stream_max_keys(slots)
    if STREAM_MIN_BATCH * 2 * wmax > cap:
        return None
    size = limit
    while size > STREAM_MIN_BATCH and size * 2 * wmax > cap:
        size = max(size // 2, STREAM_MIN_BATCH)
    return max(1, min(n_reads, size))


def row_batch_size(limit: int, wmax: int) -> int:
    """Reads per batch, at most ``limit``, that keeps a batch's window keys
    within stream_max_keys (one read at the least): the batches of the
    exact fallback, and of an index build the stream geometry cannot
    serve."""
    return max(1, min(limit, stream_max_keys() // (2 * wmax)))


def batch_switch(name: str) -> int:
    """Reads per batch that the environment switch ``name`` asks for, read
    as commet_tpu reads it (``int(...)``: a value that is not an integer
    raises ValueError, as does one below 1); STREAM_BATCH when unset."""
    value = int(os.environ.get(name, STREAM_BATCH))
    if value < 1:
        raise ValueError(f"{name}={value}: reads per batch must be at "
                         "least 1")
    return value


def _pad_length(lmax: int, k: int) -> int:
    lmax = max(lmax, k)
    return -(-lmax // LENGTH_BUCKET) * LENGTH_BUCKET


def _public(fn):
    """An Engine call with a span ``call.<name>`` of its own; with
    COMMET_TPU_PROFILE=<dir> (read at each call) run under torch.profiler
    (CPU activity, and the card's on CUDA), which records the engine's
    spans, the Chrome trace written into <dir> (``last_trace``) with the
    spans of the threads the profiler does not follow added, as commet_tpu
    wraps its calls in jax.profiler.trace."""
    name = "call." + fn.__name__

    @functools.wraps(fn)
    def call(self, *args, **kwargs):
        profile_dir = os.environ.get("COMMET_TPU_PROFILE")
        if not profile_dir:
            with trace.span(name):
                return fn(self, *args, **kwargs)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        trace.clear()
        try:
            with torch.profiler.profile(activities=activities) as prof:
                with trace.span(name):
                    out = fn(self, *args, **kwargs)
                synchronize(self.device)
        finally:
            spans = trace.recorded()
            trace.clear()
        fd, path = tempfile.mkstemp(prefix=fn.__name__ + "_",
                                    suffix=".pt.trace.json", dir=profile_dir)
        os.close(fd)
        prof.export_chrome_trace(path)
        trace.to_chrome(path, spans)
        self.last_trace = path
        return out

    return call


def _native():
    """The native IO module, its library built (a failed build raises with
    the compiler's message)."""
    native.load()
    return native


@dataclass
class DeviceCodes:
    """A set's reads on a device for the batches packed there
    (pack.gather_pack): every file's one-byte codes back to back in one
    uint8 buffer (padded to pack.CODES_ALIGN), and each read's offset into
    it (int64) and length (int32), indexed by global read id, a file's first
    id plus the read's position; on the host, each file's first id and
    whether each read holds an invalid base, from which a batch's ``clean``
    follows without asking the device."""

    codes: torch.Tensor
    offsets: torch.Tensor
    lengths: torch.Tensor
    first: np.ndarray
    dirty: np.ndarray

    def ids(self, idx: np.ndarray) -> np.ndarray:
        """Global read ids of (file, position) rows ``idx``."""
        return self.first[idx[:, 0]] + idx[:, 1]


# device bytes a read takes on the device route: its offset (int64) and
# length (int32) in DeviceCodes, and its global id (int64) in a batch loop
DEVICE_BYTES_PER_READ = 8 + 4 + 8


@dataclass
class EncodedSet:
    """A ReadSet's reads as flat 2-bit codes plus a ragged index, per file.
    An engine call makes one; its copy on the card (``upload``, made where
    the call's Engine._upload finds room) lives as long as it does."""

    rs: ReadSet
    flat_codes: List[np.ndarray] = field(default_factory=list)
    offsets: List[np.ndarray] = field(default_factory=list)
    lengths: List[np.ndarray] = field(default_factory=list)
    on_device: Optional[DeviceCodes] = None

    def __post_init__(self):
        for f in self.rs.files:
            c, o, ln = f.encoded()
            self.flat_codes.append(c)
            self.offsets.append(o)
            self.lengths.append(ln)

    def _extent(self):
        """(the codes buffer's bytes: the set's bases rounded up to
        pack.CODES_ALIGN, the set's reads)."""
        bases = sum(len(c) for c in self.flat_codes)
        return (-(-bases // pack.CODES_ALIGN) * pack.CODES_ALIGN,
                sum(len(ln) for ln in self.lengths))

    def device_bytes(self) -> int:
        """Device bytes of the device route for this set: ``upload``'s
        codes, offsets and lengths, and the global ids of a batch loop over
        every read."""
        bases, reads = self._extent()
        return bases + DEVICE_BYTES_PER_READ * reads

    def upload(self, device) -> DeviceCodes:
        """Copy every file's codes, offsets and lengths into one buffer
        each on ``device`` (a slice a file, no host concatenation of the
        codes), kept as ``on_device``."""
        size, reads = self._extent()
        codes = torch.empty(size, dtype=torch.uint8, device=device)
        offsets = torch.empty(reads, dtype=torch.int64, device=device)
        lengths = torch.empty(reads, dtype=torch.int32, device=device)
        first = np.zeros(len(self.flat_codes), dtype=np.int64)
        b = r = 0
        for fi, (c, o, ln) in enumerate(zip(self.flat_codes, self.offsets,
                                            self.lengths)):
            first[fi] = r
            codes[b:b + len(c)].copy_(torch.from_numpy(c))
            offsets[r:r + len(ln)].copy_(torch.from_numpy(o[:-1] + b))
            lengths[r:r + len(ln)].copy_(torch.from_numpy(ln))
            b += len(c)
            r += len(ln)
        codes[b:].zero_()
        dirty = (np.concatenate([f.class_counts()[0][:, 4] > 0
                                 for f in self.rs.files]) if self.rs.files
                 else np.zeros(0, dtype=bool))
        self.on_device = DeviceCodes(codes, offsets, lengths, first, dirty)
        return self.on_device

    def read_lengths(self, idx: np.ndarray) -> np.ndarray:
        out = np.zeros(len(idx), dtype=np.int32)
        for fi in range(len(self.lengths)):
            rows = np.nonzero(idx[:, 0] == fi)[0]
            out[rows] = self.lengths[fi][idx[rows, 1]]
        return out

    def gather_packed(self, idx: np.ndarray, lpad: int):
        """Reads ``idx`` ((file, position) rows) in the device wire format:
        (codes2 [n, ceil(lpad/16)] uint32, valid [n, ceil(lpad/32)] uint32,
        lengths [n] int32, clean), clean when no read has an internal
        invalid base."""
        native = _native()
        n = len(idx)
        c2 = np.zeros((n, -(-lpad // 16)), dtype=np.uint32)
        vd = np.zeros((n, -(-lpad // 32)), dtype=np.uint32)
        ln = np.zeros(n, dtype=np.int32)
        clean = True
        for fi in range(len(self.flat_codes)):
            rows = np.nonzero(idx[:, 0] == fi)[0]
            if not len(rows):
                continue
            sc2, svd, sln, dirty = native.gather_packed(
                self.flat_codes[fi], self.offsets[fi], self.lengths[fi],
                idx[rows, 1], lpad)
            c2[rows], vd[rows], ln[rows] = sc2, svd, sln
            clean &= not dirty
        return c2, vd, ln, clean


@dataclass
class ResidentIndex:
    """One index read set kept on the device as the sorted index of each of
    its max_kmer partitions, for the amortized all-vs-all schedule: each
    query set's sorted key stream is made once per batch and joined against
    every resident index (reference Commet.py:186-240 searches a query set
    against up to N-1 index sets). Counterpart of commet_tpu's
    ResidentIndex. With whole int64 keys every partition keeps its exact
    sets (sb/sc/sd) on the device for every k, so there are no host-side
    exact sets."""

    name: str
    partitions: List[stream.StreamIndex]
    nb_indexed: int
    total_kmers: int
    build_seconds: float

    def device_bytes(self) -> int:
        return sum(x.numel() * x.element_size() for sx in self.partitions
                   for x in (sx.ika, sx.ikb, sx.sb, sx.sc, sx.sd))


@dataclass
class ResidentPlanes:
    """One index read set kept on the device as the four-plane set of each
    of its max_kmer partitions, for the plane cohorts of the all-vs-all
    schedule, where partitions are above the fill gate (the reference's own
    default: full k = 33 partitions at 11.6% fill). Counterpart of
    commet_tpu's ResidentPlanes."""

    name: str
    partitions: List[torch.Tensor]  # [4 * plane_words(k)] int32 each
    fills: List[float]
    nb_indexed: int
    total_kmers: int
    build_seconds: float

    def device_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.partitions)


class Engine:
    """Builds the sorted index or the bit planes of each partition of an
    index set and classifies query sets against it, with the reference's
    partitioning semantics. ``device`` is "cuda" (the CUDA kernels) or "cpu"
    (their plain PyTorch versions); "cuda" without a card raises. The route,
    batch and prefetch settings are read from the environment when the
    engine is made.

    ``mesh`` (a sharded.Mesh of ``device``'s type, its first device the
    engine's) runs the partitions over several devices in ``mesh_mode``
    "dp" (the default where sharded.dp_fits(k)) or "plane" (the default
    otherwise); ``batch`` must be a multiple of the mesh size. Counterpart
    of commet_tpu's Engine(mesh=, mesh_mode=)."""

    def __init__(self, k: int, t: int, device, batch: int = DEFAULT_BATCH,
                 max_kmer: Optional[int] = None,
                 mesh: Optional[sharded.Mesh] = None,
                 mesh_mode: Optional[str] = None):
        if not 1 <= k <= keys.MAX_K:
            raise ValueError(f"k={k} unsupported: the port handles "
                             f"1 <= k <= {keys.MAX_K}")
        self.k = k
        self.t = t
        self.device = resolve_device(device)
        self.batch = batch
        self.mesh = mesh
        self.mesh_mode = None
        if mesh is not None:
            if mesh.first.type != self.device.type:
                raise ValueError(f"a mesh of {mesh.first.type} devices for "
                                 f"an engine on {self.device}")
            self.device = mesh.first
            if batch % len(mesh) != 0:
                raise ValueError("batch must divide evenly across the mesh")
            if mesh_mode is None:
                mesh_mode = "dp" if sharded.dp_fits(k, mesh.first) else "plane"
            if mesh_mode not in ("dp", "plane"):
                raise ValueError(f"mesh_mode {mesh_mode!r}: 'dp' or 'plane'")
            self.mesh_mode = mesh_mode
        self.max_kmer = max_kmer_for(k) if max_kmer is None else max_kmer
        mode = os.environ.get("COMMET_TPU_STREAM", "1")
        self.stream_forced = mode == "force"
        self.stream_off = mode == "0"
        self.stream_max_fill = float(os.environ.get(
            "COMMET_TPU_STREAM_MAX_FILL", str(STREAM_MAX_FILL)))
        # reads per batch of each path and the background gather+pack
        # thread (COMMET_TPU_PREFETCH=0: inline)
        self.stream_batch = batch_switch("COMMET_TPU_STREAM_BATCH")
        self.probe_batch = batch_switch("COMMET_TPU_PROBE_BATCH")
        self.build_batch = batch_switch("COMMET_TPU_BUILD_BATCH")
        self.prefetch = os.environ.get("COMMET_TPU_PREFETCH", "1") != "0"
        # the dense-plane build: COMMET_TPU_BULK_BUILD 0 / 1 / force and the
        # bulk chunk's window slots (uses_bulk_build, bulk_chunk)
        bulk = os.environ.get("COMMET_TPU_BULK_BUILD", "1")
        self.bulk_forced = bulk == "force"
        self.bulk_off = bulk == "0"
        chunk = os.environ.get("COMMET_TPU_BULK_CHUNK")
        self.bulk_chunk_set = None if chunk is None else int(chunk)
        # the Chrome trace of the last profiled public call
        self.last_trace: Optional[str] = None
        # host-IO accounting of the last search or resident build: total
        # gather+pack work (prefetch thread, or the launches of the device
        # route), time the dispatch loop waited for a batch, time spent
        # uploading codes and read ids for the device route, reads packed
        # on the device, time spent fetching verdicts (0 in a build)
        self.last_io_stats: Dict[str, float] = {}
        self._io_pack = self._io_block = self._io_upload = 0.0
        self._io_device = 0
        self._io_t0 = 0.0

    # ---------------------------------------------------------------- host
    def _host_batch(self, enc: EncodedSet, idx: np.ndarray, lpad: int):
        with trace.clocked("host.pack", reads=len(idx),
                           route="host") as packed:
            with trace.span("host.gather"):
                c2, vd, ln, clean = enc.gather_packed(idx, lpad)
            batch = [keys.host_u32(c2), keys.host_u32(vd),
                     torch.from_numpy(ln)]
            if self.device.type == "cuda":
                with trace.span("host.pin"):
                    batch = [x.pin_memory() for x in batch]
        self._io_pack += packed.seconds
        return batch + [clean]

    def _upload(self, sets: List[EncodedSet], reserve: int) -> None:
        """Give the device route to the sets of a public call: on the card
        without a mesh, each of ``sets`` in turn whose device_bytes fit in
        the free device bytes beside ``reserve`` (the most the rest of the
        call allocates there at once) and the sets uploaded before it is
        uploaded (_upload_set). The others keep the host route for the
        call."""
        if self.device.type != "cuda" or self.mesh is not None:
            return
        room = self._free_bytes() - reserve
        for enc in sets:
            if enc.device_bytes() <= room:
                room -= enc.device_bytes()
                self._upload_set(enc)

    def _upload_set(self, enc: EncodedSet) -> None:
        """EncodedSet.upload to the engine's device, under ``pack.upload``."""
        with trace.clocked("pack.upload", bytes=enc.device_bytes()) as up:
            enc.upload(self.device)
        self._io_upload += up.seconds

    def _batched_packed(self, enc: EncodedSet, idx: np.ndarray, lpad: int,
                        size: int):
        """(row_slice, codes2, valid, lengths, clean) batches of at most
        ``size`` reads ``idx`` padded to ``lpad`` (at least their longest
        read): packed on the device (_device_batches) where the call
        uploaded the set (_upload), else on the host (_host_batches)."""
        if enc.on_device is not None:
            return self._device_batches(enc, idx, lpad, size)
        return self._host_batches(enc, idx, lpad, size)

    def _device_batches(self, enc: EncodedSet, idx: np.ndarray, lpad: int,
                        size: int):
        """Yield the batches of _batched_packed gathered and packed on the
        device by pack.gather_pack (its plain version on the CPU) from the
        set's uploaded codes and the rows' global ids, uploaded once under
        ``pack.upload`` and sliced per batch. Each launch runs inline, under
        ``host.wait`` and ``host.pack``; ``clean`` is read from the host's
        count of invalid bases, which is the pack's own test because
        ``lpad`` holds every read whole."""
        dev = enc.on_device
        gids = dev.ids(idx)
        dirty = dev.dirty[gids]
        with trace.clocked("pack.upload", bytes=gids.nbytes) as up:
            ids = torch.from_numpy(gids).to(dev.codes.device)
        self._io_upload += up.seconds
        for start in range(0, len(idx), size):
            stop = min(start + size, len(idx))
            with trace.clocked("host.wait") as wait:
                with trace.clocked("host.pack", reads=stop - start,
                                   route="device") as packed:
                    batch = pack.gather_pack(dev.codes, dev.offsets,
                                             dev.lengths, ids[start:stop],
                                             lpad)
            self._io_block += wait.seconds
            self._io_pack += packed.seconds
            self._io_device += stop - start
            yield (slice(start, stop), *batch,
                   not dirty[start:stop].any())

    def _host_batches(self, enc: EncodedSet, idx: np.ndarray, lpad: int,
                      size: int):
        """Yield the batches of _batched_packed packed on the host. The
        next batch's gather+pack runs on a background thread while the
        caller works on the current one (the native assembler releases the
        GIL); with prefetch off each batch is made inline, its pack counted
        as time the dispatch loop waited. Each pack runs under the span
        open where the batches are asked for."""
        starts = list(range(0, len(idx), size))
        pack = trace.carry(self._host_batch)
        if not self.prefetch:
            for start in starts:
                with trace.clocked("host.wait") as wait:
                    cur = pack(enc, idx[start:start + size], lpad)
                self._io_block += wait.seconds
                yield (slice(start, min(start + size, len(idx))), *cur)
            return
        if not starts:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(pack, enc, idx[:size], lpad)
            for i, start in enumerate(starts):
                with trace.clocked("host.wait") as wait:
                    cur = fut.result()
                self._io_block += wait.seconds
                if i + 1 < len(starts):
                    nxt = starts[i + 1]
                    fut = ex.submit(pack, enc, idx[nxt:nxt + size], lpad)
                yield (slice(start, min(start + size, len(idx))), *cur)

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, non_blocking=True)

    def _io_reset(self):
        self._io_pack = self._io_block = self._io_upload = 0.0
        self._io_device = 0
        self._io_t0 = time.time()

    def _io_stash(self, fetch_s: float):
        wall = time.time() - self._io_t0
        self.last_io_stats = {
            "wall_s": wall,
            "host_pack_s": self._io_pack,
            "host_block_s": self._io_block,
            "upload_s": self._io_upload,
            "device_packed": self._io_device,
            "fetch_s": fetch_s,
        }

    def count_kmers(self, enc: EncodedSet, idx: np.ndarray) -> np.ndarray:
        """Per-read complete-window counts for the partitioning cursor."""
        native = _native()
        out = np.zeros(len(idx), dtype=np.int64)
        with trace.span("build.count"):
            for fi in range(len(enc.flat_codes)):
                rows = np.nonzero(idx[:, 0] == fi)[0]
                if len(rows):
                    out[rows] = native.count_kmers(
                        enc.flat_codes[fi], enc.offsets[fi], enc.lengths[fi],
                        idx[rows, 1], self.k)
        return out

    def partitions(self, kmer_counts: np.ndarray) -> List[np.ndarray]:
        """Split eligible-read indices into partitions with the exact
        reference cursor semantics: reads are indexed while the partition's
        cumulative k-mer count is < max_kmer; the first read fetched at or
        past the cap is consumed but never indexed
        (index_reads.h:49-61, index_and_search.cpp:255-277)."""
        with trace.span("build.partition"):
            n = len(kmer_counts)
            parts: List[np.ndarray] = []
            cursor = 0
            seen = 0
            # outer loop: get_reads_count() < nb_reads_to_index
            while seen < n:
                nb = 0
                members = []
                seen += 1  # first fetch of this index_reads call
                if cursor >= n:
                    break
                r = cursor
                cursor += 1
                while True:
                    if nb >= self.max_kmer:
                        break  # read r is consumed but NOT indexed (dropped)
                    members.append(r)
                    nb += int(kmer_counts[r])
                    seen += 1
                    if cursor >= n:
                        r = None
                        break
                    r = cursor
                    cursor += 1
                parts.append(np.array(members, dtype=np.int64))
                if r is None:
                    break
        return parts

    # ---------------------------------------------------------------- index
    def _free_bytes(self, device=None) -> int:
        """Device bytes free to allocate on ``device`` (the engine's): the
        card's free memory plus what PyTorch's allocator holds unused."""
        device = self.device if device is None else device
        free, _total = torch.cuda.mem_get_info(device)
        return free + (torch.cuda.memory_reserved(device)
                       - torch.cuda.memory_allocated(device))

    def serves_sorted(self, n_kmers: int) -> bool:
        """Whether a partition of ``n_kmers`` k-mers takes the sorted index
        (else the bit planes): COMMET_TPU_STREAM=force always, =0 never,
        otherwise when its fill n_kmers / 2^k is at most stream_max_fill;
        never in mesh plane mode. Counterpart of commet_tpu's per-partition
        _stream_serving."""
        if self.mesh_mode == "plane":
            return False
        if self.stream_forced or self.stream_off:
            return self.stream_forced
        return n_kmers / float(2 ** self.k) <= self.stream_max_fill

    def _check_build_memory(self, n_kmers: int) -> None:
        if self.device.type != "cuda":
            return
        free = self._free_bytes()
        need = n_kmers * BUILD_BYTES_PER_KMER
        if need > free:
            raise MemoryError(
                f"partition of {n_kmers} k-mers needs about {need / 1e9:.1f} "
                f"GB to build its sorted index ({INDEX_BYTES_PER_KMER} B per "
                f"k-mer resident plus sort workspace); {free / 1e9:.1f} GB "
                f"free on {self.device}. A partition above the fill gate "
                f"(COMMET_TPU_STREAM_MAX_FILL, now {self.stream_max_fill}) "
                f"takes the dense-plane path ({planes.plane_bytes(self.k)} B "
                "at this k); COMMET_TPU_STREAM=0 sends every partition "
                "there, or lower max_kmer.")

    def _check_plane_memory(self, bulk_bytes: int = 0,
                            chunk: int = 0) -> None:
        """The planes fit each card they go to: the whole set on the
        engine's card, or in plane mode its shards on each mesh device; and
        beside the whole set the bulk build's chunk workspace
        (``bulk_bytes`` for chunks of ``chunk`` window slots), else a
        MemoryError that names the switches."""
        if self.device.type != "cuda":
            return
        need = {self.device: planes.plane_bytes(self.k)}
        if self.mesh_mode == "plane":
            share = planes.plane_bytes(self.k) // len(self.mesh)
            need = {dev: share * self.mesh.devices.count(dev)
                    for dev in self.mesh.distinct()}
        for dev, n_bytes in need.items():
            free = self._free_bytes(dev)
            if n_bytes > free:
                raise MemoryError(
                    f"the four bit planes of k={self.k} need {n_bytes} B on "
                    f"{dev}; {free} B free")
            if n_bytes + bulk_bytes > free:
                raise MemoryError(
                    f"the bulk plane build (COMMET_TPU_BULK_BUILD) of "
                    f"k={self.k} needs {bulk_bytes} B of chunk workspace "
                    f"for chunks of {chunk} window slots "
                    f"(COMMET_TPU_BULK_CHUNK) beside its {n_bytes} B of "
                    f"planes on {dev}; {free} B free. A smaller "
                    f"COMMET_TPU_BULK_CHUNK, or COMMET_TPU_BULK_BUILD=0 (the "
                    f"per-batch build), needs less")

    def uses_bulk_build(self) -> bool:
        """Whether build_planes takes the bulk build (K9, planes.BulkChunk)
        rather than the per-batch one: never with a mesh;
        COMMET_TPU_BULK_BUILD=0 never, =force always (on the CPU through its
        plain version), otherwise on the card as CARD_BULK_BUILD says and
        never on the CPU. Counterpart of commet_tpu's use_bulk
        (Engine.build_planes)."""
        if self.mesh is not None or self.bulk_off:
            return False
        return self.bulk_forced or (self.device.type == "cuda"
                                    and CARD_BULK_BUILD)

    def bulk_chunk(self, beside_residents: bool = False) -> int:
        """Window slots of one bulk-build chunk: COMMET_TPU_BULK_CHUNK where
        set, else BULK_CHUNK_WIDE at k >= 32 (BULK_CHUNK_BESIDE for a set
        built beside resident plane sets) and BULK_CHUNK below. Counterpart
        of the cap of commet_tpu's _build_planes_bulk and its cohort
        halving (cli/commet.py run_plane_cohorts)."""
        if self.bulk_chunk_set is not None:
            return self.bulk_chunk_set
        if self.k < 32:
            return BULK_CHUNK
        return BULK_CHUNK_BESIDE if beside_residents else BULK_CHUNK_WIDE

    def _bulk_bytes(self, enc: EncodedSet, idx: np.ndarray,
                    chunk: int) -> int:
        """The bulk build's chunk workspace on the card for reads ``idx``
        (planes.bulk_workspace_bytes at their batch geometry, validity words
        counted), 0 where the route or the device needs none."""
        if self.device.type != "cuda" or not self.uses_bulk_build():
            return 0
        lmax = int(enc.read_lengths(idx).max(initial=1))
        lpad = _pad_length(lmax, self.k)
        rows = row_batch_size(self.build_batch, max(1, lmax - self.k + 1))
        return planes.bulk_workspace_bytes(
            self.k, chunk, rows * (lpad - self.k + 1),
            rows * 4 * (lpad // 16 + lpad // 32 + 1), rows)

    def build_planes(self, enc: EncodedSet, idx: np.ndarray,
                     chunk: Optional[int] = None):
        """The partition's four-plane set from reads ``idx``
        ([4 * plane_words(k)] int32): with the bulk build
        (uses_bulk_build), batches gathered into chunks of ``chunk`` window
        slots (bulk_chunk() by default), each chunk flushed once it reaches
        them after a batch (planes.BulkChunk); else every complete forward
        window set through planes.build_planes, batch by batch; with a mesh,
        replicated over it (dp), or built as word shards by the ranged build
        kernel (sharded.build_planes_sharded: plane mode). Counterpart of
        Engine.build_planes off the stream branch and _build_planes_bulk."""
        chunk = self.bulk_chunk() if chunk is None else chunk
        bulk = self.uses_bulk_build()
        self._check_plane_memory(self._bulk_bytes(enc, idx, chunk), chunk)
        if self.mesh_mode == "plane":
            out = sharded.alloc_planes_sharded(self.k, self.mesh)
        else:
            out = planes.alloc_planes(self.k, self.device)
        acc = planes.BulkChunk(out, self.k) if bulk else None
        lmax = int(enc.read_lengths(idx).max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        for _sl, c2, vd, ln, clean in self._batched_packed(
                enc, idx, lpad, row_batch_size(self.build_batch, wmax)):
            aux = ln if clean else vd
            if self.mesh_mode == "plane":
                sharded.build_planes_sharded(out, c2, aux, clean, lpad)
            elif acc is not None:
                acc.add(self._up(c2), self._up(aux), clean, lpad)
                if acc.slots >= chunk:
                    acc.flush()
            else:
                planes.build_planes(out, self._up(c2), self._up(aux), clean,
                                    lpad, self.k)
        if acc is not None:
            acc.flush()
        if self.mesh_mode == "dp":
            return sharded.replicate(out, self.mesh)
        return out

    def build_index(self, enc: EncodedSet, idx: np.ndarray,
                    n_kmers: int) -> stream.StreamIndex:
        """The partition's StreamIndex from reads ``idx`` holding ``n_kmers``
        complete windows. Counterpart of Engine.build_planes ->
        _finish_index_keys on the stream branch (no bit planes)."""
        self._check_build_memory(n_kmers)
        lmax = int(enc.read_lengths(idx).max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        size = (stream_batch_size(len(idx), wmax, limit=self.build_batch)
                or row_batch_size(self.build_batch, wmax))
        ka, kb = [], []
        for _sl, c2, vd, ln, clean in self._batched_packed(
                enc, idx, lpad, size):
            if clean:
                codes = keys.unpack_codes_clean(self._up(c2), self._up(ln),
                                                lpad)
            else:
                codes = keys.unpack_codes(self._up(c2), self._up(vd), lpad)
            a, b = keys.index_keys(codes, self.k)
            ka.append(a)
            kb.append(b)
        sidx = stream.finalize_index(ka, kb)
        if self.mesh is not None:  # dp: plane mode serves no sorted index
            return sharded.replicate(sidx, self.mesh)
        return sidx

    # --------------------------------------------------------------- search
    def search_set(self, sidx, enc: EncodedSet,
                   idx: np.ndarray) -> np.ndarray:
        """Tags [len(idx)] bool of reads ``idx`` against one partition's
        index. A StreamIndex: the stream probe for every read, then the
        exact sorted-set probe for the AMBIG residue (counterpart of
        Engine.search_set -> _search_stream_only; when the batch geometry
        cannot serve the reads, stream_batch_size is None, every read takes
        the exact probe). A plane set: the exact plane probe
        (_search_planes). Replicas over a mesh (dp) or plane shards: the
        same through parallel/sharded.py."""
        tags = np.zeros(len(idx), dtype=bool)
        with trace.span("search.select"):
            lmax = int(enc.read_lengths(idx).max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        if not (isinstance(sidx, stream.StreamIndex)
                or isinstance(sidx, sharded.Replicas) and sidx.sorted_index):
            return self._search_planes(sidx, enc, idx, lpad, wmax)
        size = stream_batch_size(len(idx), wmax, limit=self.stream_batch)
        if size is None:
            return self._search_stream_fallback(sidx, enc, idx, lpad, wmax)
        pending = []  # (slice, device verdicts): fetched after dispatching
        self._io_reset()
        for sl, c2, vd, ln, clean in self._batched_packed(
                enc, idx, lpad, size):
            aux = ln if clean else vd
            if isinstance(sidx, sharded.Replicas):
                verdict = sharded.stream_search_step(
                    sidx, c2, aux, clean, lpad, self.k, self.t, wmax)
            elif clean:
                verdict = stream.probe_stream_clean(
                    sidx, self._up(c2), self._up(ln), lpad, self.k, self.t,
                    wmax)
            else:
                verdict = stream.probe_stream_packed(
                    sidx, self._up(c2), self._up(vd), lpad, self.k, self.t,
                    wmax)
            pending.append((sl, verdict))
        amb_parts = []
        with trace.clocked("search.fetch") as fetch:
            for sl, verdict in pending:
                got = verdict.cpu().numpy()
                tags[sl] = got == stream.VERDICT_TAGGED
                amb_parts.append(np.arange(sl.start, sl.stop)[
                    got == stream.VERDICT_AMBIG])
        self._io_stash(fetch.seconds)
        amb = (np.concatenate(amb_parts) if amb_parts
               else np.zeros(0, dtype=np.int64))
        if len(amb):
            tags[amb] = self._search_stream_fallback(sidx, enc, idx[amb],
                                                     lpad, wmax)
        return tags

    def _search_planes(self, pl, enc: EncodedSet, idx: np.ndarray,
                       lpad: int, wmax: int) -> np.ndarray:
        """Exact tags of reads ``idx`` against one plane set (or its
        replicas, or its shards), both strands in one probe per batch.
        Counterpart of Engine._search_cascade / _search_full, whose
        TAGGED/UNTAGGED/AMBIG rounds end in these tags."""
        tags = np.zeros(len(idx), dtype=bool)
        pending = []  # (slice, device tags): fetched after dispatching
        self._io_reset()
        for sl, c2, vd, ln, clean in self._batched_packed(
                enc, idx, lpad, row_batch_size(self.probe_batch, wmax)):
            aux = ln if clean else vd
            if isinstance(pl, sharded.PlaneShards):
                got = sharded.probe_planes_sharded(pl, c2, aux, clean, lpad,
                                                   self.t, wmax)
            elif isinstance(pl, sharded.Replicas):
                got = sharded.dp_probe_planes(pl, c2, aux, clean, lpad,
                                              self.k, self.t, wmax)
            else:
                got = planes.probe_planes(pl, self._up(c2), self._up(aux),
                                          clean, lpad, self.k, self.t, wmax)
            pending.append((sl, got))
        with trace.clocked("search.fetch") as fetch:
            for sl, got in pending:
                tags[sl] = got.cpu().numpy()
        self._io_stash(fetch.seconds)
        return tags

    def _search_stream_fallback(self, sidx, enc: EncodedSet,
                                rows_idx: np.ndarray, lpad: int,
                                wmax: int) -> np.ndarray:
        """Exact tags of the stream's AMBIG residue through the four sorted
        value sets (every k <= 36: the keys are whole int64 values), in
        batches of at most ``batch`` reads and stream_max_keys window keys;
        against replicas over a mesh, split over it
        (sharded.stream_exact_step)."""
        tags = np.zeros(len(rows_idx), dtype=bool)
        size = row_batch_size(self.batch, wmax)
        for start in range(0, len(rows_idx), size):
            rows = rows_idx[start:start + size]
            c2, vd, _ln, _clean = enc.gather_packed(rows, lpad)
            c2, vd = keys.host_u32(c2), keys.host_u32(vd)
            if isinstance(sidx, sharded.Replicas):
                got = sharded.stream_exact_step(sidx, c2, vd, lpad, self.k,
                                                self.t, wmax)
            else:
                got = stream.probe_exact_sets(sidx, self._up(c2),
                                              self._up(vd), lpad, self.k,
                                              self.t, wmax)
            tags[start:start + len(rows)] = got.cpu().numpy()
        return tags

    # ------------------------------------------------------------ main flow
    @_public
    def index_and_search(self, index_set: ReadSet, query_sets: List[ReadSet],
                         out_dir: Optional[str] = None,
                         log_dir: Optional[str] = None,
                         save: bool = True) -> Dict[str, Dict[str, float]]:
        """The partitioned loop (index_and_search.cpp:255-277): per
        partition, build its sorted index or its planes (serves_sorted) and
        classify every query set with found-read skipping; then write the
        per-file result .bv's and the per-pair logs. Returns {query name:
        {indexed, searched, shared, index_time, search_time,
        total_time}}."""
        t_start = time.time()
        enc_index = EncodedSet(index_set)
        with trace.span("search.select"):
            enc_queries = [EncodedSet(q) for q in query_sets]
        elig = index_set.eligible()
        kcounts = (self.count_kmers(enc_index, elig) if len(elig)
                   else np.zeros(0, dtype=np.int64))
        parts = self.partitions(kcounts)
        self._upload([enc_index] + enc_queries, max(
            (self._partition_bytes(enc_index, elig[part],
                                   int(kcounts[part].sum()))
             for part in parts), default=0))

        nb_indexed = 0
        found_tot = [0] * len(query_sets)
        searched_last = [0] * len(query_sets)
        index_time = 0.0
        search_times = [0.0] * len(query_sets)
        for part in parts:
            t0 = time.time()
            sidx = None  # free the previous partition's index first
            n_kmers = int(kcounts[part].sum())
            if self.serves_sorted(n_kmers):
                sidx = self.build_index(enc_index, elig[part], n_kmers)
            else:
                sidx = self.build_planes(enc_index, elig[part])
            synchronize(self.device)
            index_time += time.time() - t0
            nb_indexed += len(part)
            for qi, (q, enc_q) in enumerate(zip(query_sets, enc_queries)):
                t0 = time.time()
                with trace.span("search.select"):
                    cand = q.untagged_eligible()
                searched_last[qi] = len(cand)
                if len(cand):
                    hit = cand[self.search_set(sidx, enc_q, cand)]
                    found_tot[qi] += len(hit)
                    if len(hit):
                        q.tag(hit[:, 0], hit[:, 1])
                search_times[qi] += time.time() - t0

        counters = {}
        with trace.span("search.finish"):
            for qi, q in enumerate(query_sets):
                counters[q.name] = {
                    "indexed": nb_indexed,
                    "searched": searched_last[qi],
                    "shared": found_tot[qi],
                    "index_time": index_time,
                    "search_time": search_times[qi],
                    "total_time": time.time() - t_start,
                }
                if log_dir is not None:
                    self._write_log(log_dir, q.name, index_set.name,
                                    counters[q.name])
                if save and out_dir is not None:
                    q.save_result_bvs(out_dir, index_set.name)
        return counters

    def _partition_bytes(self, enc: EncodedSet, idx: np.ndarray,
                         n_kmers: int) -> int:
        """The most device bytes index_and_search holds at once for one
        partition of reads ``idx`` holding ``n_kmers`` k-mers: its build,
        or its index or planes beside a search's workspace."""
        if self.serves_sorted(n_kmers):
            return max(n_kmers * BUILD_BYTES_PER_KMER,
                       n_kmers * INDEX_BYTES_PER_KMER + STREAM_BATCH_BYTES)
        return planes.plane_bytes(self.k) + max(
            self._bulk_bytes(enc, idx, self.bulk_chunk()),
            PLANES_WORKSPACE_BYTES)

    # ------------------------------------------- amortized all-vs-all step 0
    def _resident_budget(self, n_kmers: int,
                         budget: Optional[float]) -> float:
        """Device bytes a new resident index of ``n_kmers`` may take: the
        least of the caller's ``budget``, COMMET_TPU_RESIDENT_BUDGET when
        set, and on the card the free memory less the build workspace of
        this set and one stream batch's workspace for the searches."""
        limits = [] if budget is None else [budget]
        env = os.environ.get("COMMET_TPU_RESIDENT_BUDGET")
        if env:
            limits.append(float(env))
        if self.device.type == "cuda":
            limits.append(self._free_bytes() - n_kmers * BUILD_BYTES_PER_KMER
                          - STREAM_BATCH_BYTES)
        return min(limits, default=float("inf"))

    @_public
    def build_resident(self, index_set: ReadSet,
                       budget: Optional[float] = None
                       ) -> Optional[ResidentIndex]:
        """Build every max_kmer partition of ``index_set`` as a resident
        StreamIndex (build_index per partition). Returns None, before any
        device allocation, when the engine has a mesh, k > RESIDENT_MAX_K,
        the resident bytes
        (INDEX_BYTES_PER_KMER per k-mer) exceed _resident_budget or a
        partition is above the fill gate (serves_sorted); the caller then
        takes the plane cohorts or the pairwise schedule. Fills
        last_io_stats (fetch_s 0). Counterpart of build_resident."""
        if self.mesh is not None or self.k > RESIDENT_MAX_K:
            return None
        t0 = time.time()
        self._io_reset()
        enc = EncodedSet(index_set)
        elig = index_set.eligible()
        kcounts = (self.count_kmers(enc, elig) if len(elig)
                   else np.zeros(0, dtype=np.int64))
        total = int(kcounts.sum())
        if total * INDEX_BYTES_PER_KMER > self._resident_budget(total, budget):
            return None
        parts = self.partitions(kcounts)
        if not all(self.serves_sorted(int(kcounts[p].sum())) for p in parts):
            return None
        # beside the set: its residents, the build and a search's workspace
        self._upload([enc], total * (INDEX_BYTES_PER_KMER
                                     + BUILD_BYTES_PER_KMER)
                     + STREAM_BATCH_BYTES)
        sxs = [self.build_index(enc, elig[part], int(kcounts[part].sum()))
               for part in parts]
        synchronize(self.device)
        self._io_stash(0.0)
        return ResidentIndex(index_set.name, sxs,
                             int(sum(len(p) for p in parts)), total,
                             time.time() - t0)

    @_public
    def search_multi_set(self, query_set: ReadSet,
                         residents: List[ResidentIndex],
                         out_dir: Optional[str] = None,
                         log_dir: Optional[str] = None,
                         save: bool = True, max_slots: int = 32
                         ) -> Optional[Dict[str, Dict[str, float]]]:
        """Classify ``query_set`` against every resident index with one
        sorted query stream per batch, joined against a group of up to
        ``max_slots`` slots (one slot per (resident, partition)) by one
        grouped kernel launch. Writes the same result .bv's, logs and
        counters as len(residents) pairwise index_and_search calls, keyed by
        resident name: per-partition verdicts OR-ed across partitions, each
        slot's AMBIG residue through the exact sorted-set probe on the
        device (every k: the keys are whole int64 values). Returns None when
        the batch geometry cannot serve the query set (stream_batch_size),
        so run_amortized_rounds runs the classic rounds. Counterpart of
        search_multi_set."""
        t_start = time.time()
        with trace.span("search.select"):
            enc_q = EncodedSet(query_set)
            cand = query_set.untagged_eligible()
            slots = [(ri, sx) for ri, r in enumerate(residents)
                     for sx in r.partitions]
            tags_slot = np.zeros((len(slots), len(cand)), dtype=bool)
            work = len(cand) > 0 and len(slots) > 0
            if work:
                lmax = int(enc_q.read_lengths(cand).max(initial=1))
        fb_time = [0.0] * len(residents)  # per-resident exact-fallback time
        if work:
            lpad = _pad_length(lmax, self.k)
            wmax = max(1, lmax - self.k + 1)
            size = stream_batch_size(len(cand), wmax,
                                     min(len(slots), max_slots),
                                     limit=self.stream_batch)
            if size is None:
                return None
            self._io_reset()
            self._upload([enc_q], STREAM_BATCH_BYTES)
            fetch_s = 0.0
            for base in range(0, len(slots), max_slots):
                group = slots[base:base + max_slots]
                table = stream.JoinSlots([sx.ika for _ri, sx in group],
                                         [sx.ikb for _ri, sx in group],
                                         [sx.mi for _ri, sx in group])
                pending = []  # (slice, device verdicts [S, b])
                for sl, c2, vd, ln, clean in self._batched_packed(
                        enc_q, cand, lpad, size):
                    if clean:
                        v = stream.probe_multi_stream_clean(
                            table, self._up(c2), self._up(ln), lpad, self.k,
                            self.t, wmax)
                    else:
                        v = stream.probe_multi_stream_packed(
                            table, self._up(c2), self._up(vd), lpad, self.k,
                            self.t, wmax)
                    pending.append((sl, v))
                amb_slot = [[] for _ in group]
                with trace.clocked("search.fetch") as fetch:
                    for sl, v in pending:
                        got = v.cpu().numpy()
                        tags_slot[base:base + len(group), sl] = \
                            got == stream.VERDICT_TAGGED
                        for s in range(len(group)):
                            amb_slot[s].append(np.arange(sl.start, sl.stop)[
                                got[s] == stream.VERDICT_AMBIG])
                fetch_s += fetch.seconds
                for s, (ri, sx) in enumerate(group):
                    amb = np.concatenate(amb_slot[s])
                    if not len(amb):
                        continue
                    t_fb = time.time()
                    tags_slot[base + s, amb] = self._search_stream_fallback(
                        sx, enc_q, cand[amb], lpad, wmax)
                    fb_time[ri] += time.time() - t_fb
            self._io_stash(fetch_s)
        return self._multi_finish(query_set, residents, cand, tags_slot,
                                  fb_time, t_start, out_dir, log_dir, save)

    # ------------------------------ amortized all-vs-all step 0, planes
    def _planes_budget(self, budget: Optional[float]) -> float:
        """Device bytes new resident plane sets may take: the least of the
        caller's ``budget`` and, on the card, the free memory less
        PLANES_WORKSPACE_BYTES."""
        limits = [] if budget is None else [budget]
        if self.device.type == "cuda":
            limits.append(self._free_bytes() - PLANES_WORKSPACE_BYTES)
        return min(limits, default=float("inf"))

    @_public
    def build_resident_planes(self, index_set: ReadSet,
                              budget: Optional[float] = None,
                              bulk_chunk: Optional[int] = None
                              ) -> Optional[ResidentPlanes]:
        """Build every max_kmer partition of ``index_set`` as a resident
        four-plane set (build_planes per partition, bulk builds in chunks of
        ``bulk_chunk`` window slots, bulk_chunk() by default), for the plane
        cohorts. Returns None, before any device allocation, when the engine
        has a mesh or the plane bytes (plane_bytes(k) per partition) and the
        bulk build's chunk workspace exceed _planes_budget; the set takes
        the device route where it fits beside them too. Fills last_io_stats
        (fetch_s 0). Counterpart of build_resident_planes."""
        if self.mesh is not None:
            return None
        t0 = time.time()
        self._io_reset()
        enc = EncodedSet(index_set)
        elig = index_set.eligible()
        kcounts = (self.count_kmers(enc, elig) if len(elig)
                   else np.zeros(0, dtype=np.int64))
        parts = self.partitions(kcounts)
        chunk = self.bulk_chunk() if bulk_chunk is None else bulk_chunk
        need = len(parts) * planes.plane_bytes(self.k)
        if parts:
            need += self._bulk_bytes(enc, elig, chunk)
        if need > self._planes_budget(budget):
            return None
        self._upload([enc], need + PLANES_WORKSPACE_BYTES)
        pls = [self.build_planes(enc, elig[part], chunk) for part in parts]
        synchronize(self.device)
        self._io_stash(0.0)
        fills = [float(kcounts[part].sum()) / float(2 ** self.k)
                 for part in parts]
        return ResidentPlanes(index_set.name, pls, fills,
                              int(sum(len(p) for p in parts)),
                              int(kcounts.sum()), time.time() - t0)

    @_public
    def search_multi_set_planes(self, query_set: ReadSet,
                                residents: List[ResidentPlanes],
                                out_dir: Optional[str] = None,
                                log_dir: Optional[str] = None,
                                save: bool = True, max_slots: int = 32
                                ) -> Dict[str, Dict[str, float]]:
        """Classify ``query_set`` against every resident plane set with one
        upload per batch serving a group of up to ``max_slots`` slots (one
        slot per (resident, partition)) by one grouped probe launch
        (planes.probe_planes_multi; a lone slot takes probe_planes). Writes
        the same result .bv's, logs and counters as len(residents) pairwise
        index_and_search calls, through _multi_finish. Counterpart of
        search_multi_set_planes, whose cascade rounds and exact fallback
        end in the tags this probe gives in one pass."""
        t_start = time.time()
        with trace.span("search.select"):
            enc_q = EncodedSet(query_set)
            cand = query_set.untagged_eligible()
            slots = [pl for r in residents for pl in r.partitions]
            tags_slot = np.zeros((len(slots), len(cand)), dtype=bool)
            work = len(cand) > 0 and len(slots) > 0
            if work:
                lmax = int(enc_q.read_lengths(cand).max(initial=1))
        if work:
            lpad = _pad_length(lmax, self.k)
            wmax = max(1, lmax - self.k + 1)
            size = row_batch_size(self.probe_batch, wmax)
            self._io_reset()
            self._upload([enc_q], PLANES_WORKSPACE_BYTES)
            fetch_s = 0.0
            for base in range(0, len(slots), max_slots):
                group = slots[base:base + max_slots]
                table = planes.PlaneSlots(group) if len(group) > 1 else None
                pending = []  # (slice, device tags [S, b])
                for sl, c2, vd, ln, clean in self._batched_packed(
                        enc_q, cand, lpad, size):
                    args = (self._up(c2), self._up(ln if clean else vd),
                            clean, lpad, self.k, self.t, wmax)
                    if table is None:
                        got = planes.probe_planes(group[0], *args)[None]
                    else:
                        got = planes.probe_planes_multi(table, *args)
                    pending.append((sl, got))
                with trace.clocked("search.fetch") as fetch:
                    for sl, got in pending:
                        tags_slot[base:base + len(group), sl] = \
                            got.cpu().numpy()
                fetch_s += fetch.seconds
            self._io_stash(fetch_s)
        return self._multi_finish(query_set, residents, cand, tags_slot,
                                  [0.0] * len(residents), t_start, out_dir,
                                  log_dir, save)

    def _multi_finish(self, query_set: ReadSet, residents, cand, tags_slot,
                      fb_time, t_start, out_dir, log_dir, save):
        """Per-resident counters with the pairwise semantics, logs and
        result .bv's. ``searched`` is the candidates less the reads tagged
        in partitions before the last one (what the pairwise path's
        found-read skipping leaves for its last partition; 0 for a resident
        without partitions, as pairwise); ``search_time`` is an equal share
        of the joint probe plus the resident's own fallback time. The query
        set's tags are shared across residents: each resident's are set,
        saved and cleared before the next. Counterpart of _multi_finish."""
        with trace.span("search.finish"):
            joint = max(0.0, time.time() - t_start - sum(fb_time))
            counters = {}
            si = 0
            for ri, r in enumerate(residents):
                tr = tags_slot[si:si + len(r.partitions)]
                si += len(r.partitions)
                tags = tr.any(axis=0)
                c = {
                    "indexed": r.nb_indexed,
                    "searched": (len(cand) - int(tr[:-1].any(axis=0).sum())
                                 if len(tr) else 0),
                    "shared": int(tags.sum()),
                    "index_time": r.build_seconds,
                    "search_time": joint / len(residents) + fb_time[ri],
                    "total_time": time.time() - t_start,
                }
                counters[r.name] = c
                if log_dir is not None:
                    self._write_log(log_dir, query_set.name, r.name, c)
                if save and out_dir is not None:
                    hit = cand[tags]
                    if len(hit):
                        query_set.tag(hit[:, 0], hit[:, 1])
                    query_set.save_result_bvs(out_dir, r.name)
                    for bv in query_set.result_bvs:
                        bv.set_all_false()
        return counters

    @staticmethod
    def _write_log(log_dir: str, qname: str, iname: str, c: Dict[str, float]):
        """Per-pair log in the reference's format
        (index_and_search.cpp:288-300)."""
        path = os.path.join(log_dir, f"{qname}_in_{iname}.log")
        with trace.span("io.write"), open(path, "w") as f:
            f.write("Index  time: %g s\n" % c["index_time"])
            f.write("Search time: %g s\n" % c["search_time"])
            f.write("Total  time: %g s\n" % c["total_time"])
            f.write("[indexed %d, searched %d, shared %d]\n"
                    % (c["indexed"], c["searched"], c["shared"]))
