"""One index set's resident planes built again and again, a unit a build
(``Engine.build_resident_planes``: counting, partitioning, host pack and
the plane build), the previous build freed before the next.

Parameters: ``sample_words``, the plane words of each unit's planes read
back for the check; ``torch_threads`` (read by the harness), PyTorch's
CPU threads in the run's process. Configuration: ``k``, ``t``, ``set_reads`` (the index
set's reads), ``read_len``, ``n_share``. The set is the first index set of
``data.make_cohort``.

The set's fasta is deleted once parsed (the units do not read it again),
so that no writeback of it runs inside the window.

Compared: the last unit's planes bit for bit, and the sampled words of
every unit, against the reference's planes.

The control (``ctx.control``) puts the reference in the program's place
with the index built without the reads that hold an N: each unit builds
those planes, which the same check reads.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from commet_bench import compare, data, roofline
from commet_bench.reference import commet_ref
from commet_bench.tracing import timed


def make_inputs(cfg, p, seed):
    """The index set's [n, L] uint8 codes."""
    (codes,), _queries = data.make_cohort(seed, [cfg["set_reads"]], [],
                                          cfg["read_len"], 2 * cfg["k"],
                                          cfg["n_share"])
    return codes


def reference_planes(cfg, codes, device, skip_dirty=False):
    """The reference's packed planes of the index set's one partition."""
    k = cfg["k"]
    counts = commet_ref.valid_windows(codes, k, device)
    parts = commet_ref.partitions(counts, commet_ref.max_kmer_for(k))
    if len(parts) != 1:
        raise RuntimeError(f"{len(parts)} partitions: the cell holds one")
    planes = commet_ref.BytePlanes(k, device)
    planes.add(codes, skip_dirty)
    return planes.packed()


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.k = ctx.config["k"]

    def setup(self):
        cfg, p, ctx = self.ctx.config, self.ctx.params, self.ctx
        self.phases = {}
        with timed(self.phases, "make_s"):
            self.codes = make_inputs(cfg, p, ctx.seed)
        n_words = 4 * (1 << self.k) // 32
        rng = np.random.default_rng(ctx.seed)
        self.sample = torch.from_numpy(np.sort(rng.integers(
            0, n_words, p["sample_words"]))).to(ctx.device)
        self.resident, self.samples = None, []
        if ctx.control:
            return
        from commet_tpu_torch.engine.engine import Engine
        from commet_tpu_torch.io.reads import ReadSet
        with timed(self.phases, "write_s"):
            (path,) = data.write_sets(os.path.join(ctx.workdir, "sets"),
                                      ["index1"], [self.codes])
        self.index_set = ReadSet("index1")
        with timed(self.phases, "parse_s"):
            self.index_set.add_file(path)
        os.remove(path)
        self.engine = Engine(k=self.k, t=cfg["t"], device=ctx.device)

    def warm_up(self):
        if not self.ctx.control:
            self._build()
        self.resident = None

    def _build(self):
        self.resident = None  # the previous unit's planes are freed first
        r = self.engine.build_resident_planes(self.index_set)
        if r is None:
            raise RuntimeError("the index set cannot stay resident as "
                               "planes")
        self.resident = r
        return r

    def unit(self, i: int) -> dict:
        if self.ctx.control:
            self.resident = None
            self.resident = reference_planes(
                self.ctx.config, self.codes, self.ctx.device,
                skip_dirty=True).view(torch.int32)
            self.samples.append((i, self.resident[self.sample].cpu()))
            return {"work": {}}
        r = self._build()
        if len(r.partitions) != 1:
            raise RuntimeError(f"{len(r.partitions)} partitions: the cell "
                               "holds one")
        self.samples.append((i, r.partitions[0][self.sample].cpu()))
        return {"work": {"kmers": int(r.total_kmers)}}

    def release(self):
        if self.ctx.control:
            self.last = self.resident
        else:
            self.last = (self.resident.partitions[0]
                         if self.resident is not None else None)
        self.engine = self.resident = self.index_set = None

    def check(self, units, want_bytes: bool) -> dict:
        k = self.k
        packed = reference_planes(self.ctx.config, self.codes,
                                  self.ctx.device)
        failed = set()
        want = packed.view(torch.int32)
        plane_bits = (compare.planes_differ(self.last, packed)
                      if self.last is not None else 8 * packed.numel())
        self.last = None
        want_sample = want[self.sample].cpu()
        del want, packed
        sample_bits = 0
        for i, got in self.samples:
            w = compare.bits_differ(got.view(torch.uint8),
                                    want_sample.view(torch.uint8))
            sample_bits += w
            if w:
                failed.add(i)
        out = {"checks": {"plane_bits_wrong": {"value": plane_bits,
                                               "limit": 0},
                          "sample_bits_wrong": {"value": sample_bits,
                                                "limit": 0}},
               "failed": failed}
        if want_bytes:
            least = roofline.build_bytes(self.codes, k)
            out["least"] = {"build_bytes": [least for u in units
                                            if u["error"] is None]}
        return out
