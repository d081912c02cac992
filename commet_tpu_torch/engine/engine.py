"""The index -> search engine of index_and_search (reference
src/index_and_search.cpp), served by the sorted-join stream probe.

Counterpart of the stream-serving part of commet_tpu/engine/engine.py:
  - the host batches eligible reads into 2-bit packed tensors (the native
    gather+pack runs on a prefetch thread; on CUDA the batches land in pinned
    memory and upload with non-blocking copies);
  - partition boundaries follow the reference's read-granular cursor,
    including the read dropped at every partition boundary
    (index_reads.h:49-61) and found-read skipping between partitions
    (file_manager.h:99-109);
  - per partition, the valid forward windows' (keya, keyb) pairs are sorted
    into a StreamIndex on the device; every still-untagged query read goes
    through the stream probe (keygen, query sort, join kernel, verdict
    sandwich), and the AMBIG residue through the exact sorted-set probe.

Every partition is served by the sorted index whatever its fill (the JAX
package's COMMET_TPU_STREAM=force behaviour): tags are exact either way.
There is no CPU fallback: the engine runs on the device it is given.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from commet_tpu.io.reads import ReadSet
from commet_tpu_torch.core import keys, stream
from commet_tpu_torch.device import resolve_device, synchronize

# reads per host batch of the exact fallback
DEFAULT_BATCH = 4096
# reads per device batch of the index build and the stream probe
STREAM_BATCH = 65536
LENGTH_BUCKET = 32
# device bytes per indexed k-mer: the resident StreamIndex (ika, ikb and the
# sb/sc/sd sets, 5 x int64) plus the build's sort workspace
INDEX_BYTES_PER_KMER = 40
BUILD_BYTES_PER_KMER = 96


def max_kmer_for(k: int) -> int:
    """Partition cap: (unsigned long)(1e9 / 2^(33-k))
    (reference index_and_search.cpp:73,146)."""
    return int(1000000000.0 / (2.0 ** (33 - k)))


def _pad_length(lmax: int, k: int) -> int:
    lmax = max(lmax, k)
    return -(-lmax // LENGTH_BUCKET) * LENGTH_BUCKET


def _native():
    from commet_tpu.native import parser as native
    if not native.available():
        raise RuntimeError("the native IO library (commet_tpu/native) could "
                           "not be built: run make -C commet_tpu/native")
    return native


@dataclass
class EncodedSet:
    """A ReadSet's reads as flat 2-bit codes plus a ragged index, per file."""

    rs: ReadSet
    flat_codes: List[np.ndarray] = field(default_factory=list)
    offsets: List[np.ndarray] = field(default_factory=list)
    lengths: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        for f in self.rs.files:
            c, o, ln = f.encoded()
            self.flat_codes.append(c)
            self.offsets.append(o)
            self.lengths.append(ln)

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


class Engine:
    """Builds the sorted index of each partition of an index set and
    classifies query sets against it, with the reference's partitioning
    semantics. ``device`` is "cuda" (the CUDA join kernel) or "cpu" (its
    plain PyTorch version); "cuda" without a card raises."""

    def __init__(self, k: int, t: int, device, batch: int = DEFAULT_BATCH,
                 max_kmer: Optional[int] = None):
        if not 1 <= k <= keys.MAX_K:
            raise ValueError(f"k={k} unsupported: the port handles "
                             f"1 <= k <= {keys.MAX_K}")
        self.k = k
        self.t = t
        self.device = resolve_device(device)
        self.batch = batch
        self.max_kmer = max_kmer_for(k) if max_kmer is None else max_kmer
        # host-IO accounting of the last search call: total gather+pack
        # work (prefetch thread), time the dispatch loop waited for a batch,
        # time spent fetching verdicts
        self.last_io_stats: Dict[str, float] = {}
        self._io_pack = self._io_block = 0.0
        self._io_t0 = 0.0

    # ---------------------------------------------------------------- host
    def _host_batch(self, enc: EncodedSet, idx: np.ndarray, lpad: int):
        t0 = time.time()
        c2, vd, ln, clean = enc.gather_packed(idx, lpad)
        batch = [keys.host_u32(c2), keys.host_u32(vd), torch.from_numpy(ln)]
        if self.device.type == "cuda":
            batch = [x.pin_memory() for x in batch]
        self._io_pack += time.time() - t0
        return batch + [clean]

    def _batched_packed(self, enc: EncodedSet, idx: np.ndarray, lpad: int,
                        size: int):
        """Yield (row_slice, codes2, valid, lengths, clean) host batches of
        at most ``size`` reads. The next batch's gather+pack runs on a
        background thread while the caller works on the current one (the
        native assembler releases the GIL)."""
        starts = list(range(0, len(idx), size))
        if not starts:
            return
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(self._host_batch, enc, idx[:size], lpad)
            for i, start in enumerate(starts):
                t0 = time.time()
                cur = fut.result()
                self._io_block += time.time() - t0
                if i + 1 < len(starts):
                    nxt = starts[i + 1]
                    fut = ex.submit(self._host_batch, enc,
                                    idx[nxt:nxt + size], lpad)
                yield (slice(start, min(start + size, len(idx))), *cur)

    def _up(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, non_blocking=True)

    def _io_reset(self):
        self._io_pack = self._io_block = 0.0
        self._io_t0 = time.time()

    def _io_stash(self, fetch_s: float):
        wall = time.time() - self._io_t0
        self.last_io_stats = {
            "wall_s": wall,
            "host_pack_s": self._io_pack,
            "host_block_s": self._io_block,
            "fetch_s": fetch_s,
        }

    def count_kmers(self, enc: EncodedSet, idx: np.ndarray) -> np.ndarray:
        """Per-read complete-window counts for the partitioning cursor."""
        native = _native()
        out = np.zeros(len(idx), dtype=np.int64)
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
        n = len(kmer_counts)
        parts: List[np.ndarray] = []
        cursor = 0
        seen = 0
        while seen < n:  # outer loop: get_reads_count() < nb_reads_to_index
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
    def _check_build_memory(self, n_kmers: int) -> None:
        if self.device.type != "cuda":
            return
        free, _total = torch.cuda.mem_get_info(self.device)
        free += (torch.cuda.memory_reserved(self.device)
                 - torch.cuda.memory_allocated(self.device))
        need = n_kmers * BUILD_BYTES_PER_KMER
        if need > free:
            raise MemoryError(
                f"partition of {n_kmers} k-mers needs about {need / 1e9:.1f} "
                f"GB to build its sorted index ({INDEX_BYTES_PER_KMER} B per "
                f"k-mer resident plus sort workspace); {free / 1e9:.1f} GB "
                f"free on {self.device}. Lower max_kmer, or see ROADMAP "
                "'dense-plane path' (K2-K5), which serves such partitions.")

    def build_index(self, enc: EncodedSet, idx: np.ndarray,
                    n_kmers: int) -> stream.StreamIndex:
        """The partition's StreamIndex from reads ``idx`` holding ``n_kmers``
        complete windows. Counterpart of Engine.build_planes ->
        _finish_index_keys on the stream branch (no bit planes)."""
        self._check_build_memory(n_kmers)
        lpad = _pad_length(int(enc.read_lengths(idx).max(initial=1)), self.k)
        ka, kb = [], []
        for _sl, c2, vd, ln, clean in self._batched_packed(
                enc, idx, lpad, STREAM_BATCH):
            if clean:
                codes = keys.unpack_codes_clean(self._up(c2), self._up(ln),
                                                lpad)
            else:
                codes = keys.unpack_codes(self._up(c2), self._up(vd), lpad)
            a, b = keys.index_keys(codes, self.k)
            ka.append(a)
            kb.append(b)
        return stream.finalize_index(ka, kb)

    # --------------------------------------------------------------- search
    def search_set(self, sidx: stream.StreamIndex, enc: EncodedSet,
                   idx: np.ndarray) -> np.ndarray:
        """Tags [len(idx)] bool of reads ``idx`` against one partition's
        index: the stream probe for every read, then the exact sorted-set
        probe for the AMBIG residue. Counterpart of Engine.search_set ->
        _search_stream_only."""
        tags = np.zeros(len(idx), dtype=bool)
        lmax = int(enc.read_lengths(idx).max(initial=1))
        lpad = _pad_length(lmax, self.k)
        wmax = max(1, lmax - self.k + 1)
        pending = []  # (slice, device verdicts): fetched after dispatching
        self._io_reset()
        for sl, c2, vd, ln, clean in self._batched_packed(
                enc, idx, lpad, STREAM_BATCH):
            if clean:
                verdict = stream.probe_stream_clean(
                    sidx, self._up(c2), self._up(ln), lpad, self.k, self.t,
                    wmax)
            else:
                verdict = stream.probe_stream_packed(
                    sidx, self._up(c2), self._up(vd), lpad, self.k, self.t,
                    wmax)
            pending.append((sl, verdict))
        amb_parts = []
        t_fetch = time.time()
        for sl, verdict in pending:
            got = verdict.cpu().numpy()
            tags[sl] = got == stream.VERDICT_TAGGED
            amb_parts.append(np.arange(sl.start, sl.stop)[
                got == stream.VERDICT_AMBIG])
        self._io_stash(time.time() - t_fetch)
        amb = (np.concatenate(amb_parts) if amb_parts
               else np.zeros(0, dtype=np.int64))
        if len(amb):
            tags[amb] = self._search_stream_fallback(sidx, enc, idx[amb],
                                                     lpad, wmax)
        return tags

    def _search_stream_fallback(self, sidx: stream.StreamIndex,
                                enc: EncodedSet, rows_idx: np.ndarray,
                                lpad: int, wmax: int) -> np.ndarray:
        """Exact tags of the stream's AMBIG residue through the four sorted
        value sets (every k <= 36: the keys are whole int64 values)."""
        tags = np.zeros(len(rows_idx), dtype=bool)
        for start in range(0, len(rows_idx), self.batch):
            rows = rows_idx[start:start + self.batch]
            c2, vd, _ln, _clean = enc.gather_packed(rows, lpad)
            got = stream.probe_exact_sets(
                sidx, self._up(keys.host_u32(c2)),
                self._up(keys.host_u32(vd)), lpad, self.k, self.t, wmax)
            tags[start:start + len(rows)] = got.cpu().numpy()
        return tags

    # ------------------------------------------------------------ main flow
    def index_and_search(self, index_set: ReadSet, query_sets: List[ReadSet],
                         out_dir: Optional[str] = None,
                         log_dir: Optional[str] = None,
                         save: bool = True) -> Dict[str, Dict[str, float]]:
        """The partitioned loop (index_and_search.cpp:255-277): per
        partition, build the index and classify every query set with
        found-read skipping; then write the per-file result .bv's and the
        per-pair logs. Returns {query name: {indexed, searched, shared,
        index_time, search_time, total_time}}."""
        t_start = time.time()
        enc_index = EncodedSet(index_set)
        enc_queries = [EncodedSet(q) for q in query_sets]
        elig = index_set.eligible()
        kcounts = (self.count_kmers(enc_index, elig) if len(elig)
                   else np.zeros(0, dtype=np.int64))
        parts = self.partitions(kcounts)

        nb_indexed = 0
        found_tot = [0] * len(query_sets)
        searched_last = [0] * len(query_sets)
        index_time = 0.0
        search_times = [0.0] * len(query_sets)
        for part in parts:
            t0 = time.time()
            sidx = None  # free the previous partition's index first
            sidx = self.build_index(enc_index, elig[part],
                                    int(kcounts[part].sum()))
            synchronize(self.device)
            index_time += time.time() - t0
            nb_indexed += len(part)
            for qi, (q, enc_q) in enumerate(zip(query_sets, enc_queries)):
                t0 = time.time()
                cand = q.untagged_eligible()
                searched_last[qi] = len(cand)
                if len(cand):
                    hit = cand[self.search_set(sidx, enc_q, cand)]
                    found_tot[qi] += len(hit)
                    if len(hit):
                        q.tag(hit[:, 0], hit[:, 1])
                search_times[qi] += time.time() - t0

        counters = {}
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

    @staticmethod
    def _write_log(log_dir: str, qname: str, iname: str, c: Dict[str, float]):
        """Per-pair log in the reference's format
        (index_and_search.cpp:288-300)."""
        path = os.path.join(log_dir, f"{qname}_in_{iname}.log")
        with open(path, "w") as f:
            f.write("Index  time: %g s\n" % c["index_time"])
            f.write("Search time: %g s\n" % c["search_time"])
            f.write("Total  time: %g s\n" % c["total_time"])
            f.write("[indexed %d, searched %d, shared %d]\n"
                    % (c["indexed"], c["searched"], c["shared"]))
