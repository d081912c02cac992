"""Step 0 of the amortized all-vs-all on resident planes: index sets built
once in set-up (``Engine.build_resident_planes``), then one query set after
another searched against all of them (``Engine.search_multi_set_planes``),
a unit a query set.

Parameters: ``residents`` and ``queries``, how many index and query sets;
``query_reads``, a query set's reads.
Configuration: ``k``, ``t``, ``set_reads`` (an index set's reads),
``read_len``, ``n_share`` (reads with one N). Sets are laid out by
``data.make_cohort``: each query set's even reads hold a 2k bp fragment
of a read of the first index set.

Each set's fasta is deleted once parsed (the units do not read it again),
so that no writeback of it runs inside the window.

Compared: every unit's tags in its written .bv files against the
reference's tags, its .log counters, and the resident planes the program
built against the reference's.

The control (``ctx.control``) puts the reference in the program's place
with keya alone deciding membership: set-up works out its tags, counters
and planes, and each unit writes that query set's .bv and .log files where
the program would, for the same check to read.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from commet_bench import compare, data, roofline
from commet_bench.reference import commet_ref
from commet_bench.tracing import timed


def make_inputs(cfg, p, seed):
    """(index set codes, query set codes), lists of [n, L] uint8."""
    return data.make_cohort(seed, [cfg["set_reads"]] * p["residents"],
                            [p["query_reads"]] * p["queries"],
                            cfg["read_len"], 2 * cfg["k"], cfg["n_share"])


def reference(cfg, index_codes, query_codes, device, membership="exact",
              each_partition=None):
    """The reference's tags and counters of every query set against every
    index set: ([index][query] tags, [index][query] counters, the
    reference's planes as the last partition left them)."""
    planes = commet_ref.BytePlanes(cfg["k"], device, membership)
    queries = [(c, np.ones(len(c), dtype=bool)) for c in query_codes]
    tags, counts = [], []
    for ri, codes in enumerate(index_codes):
        each = (None if each_partition is None
                else lambda pi, pl, ri=ri: each_partition(ri, pi, pl))
        got, cnt = commet_ref.index_and_search(
            planes, codes, np.ones(len(codes), dtype=bool), queries,
            cfg["t"], commet_ref.max_kmer_for(cfg["k"]),
            each_partition=each)
        tags.append(got)
        counts.append(cnt)
    return tags, counts, planes


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.k, self.t = ctx.config["k"], ctx.config["t"]

    def setup(self):
        cfg, p, ctx = self.ctx.config, self.ctx.params, self.ctx
        self.phases = {}
        with timed(self.phases, "make_s"):
            self.index_codes, self.query_codes = make_inputs(cfg, p,
                                                             ctx.seed)
        self.index_names = [f"index{i + 1}"
                            for i in range(len(self.index_codes))]
        self.query_names = [f"query{i + 1}"
                            for i in range(len(self.query_codes))]
        # the names of the query files, which name the .bv files
        self.query_bases = [name + ".fa" for name in self.query_names]
        if ctx.control:
            self._setup_control()
        else:
            self._setup_program()

    def _setup_program(self):
        from commet_tpu_torch.engine.engine import Engine
        from commet_tpu_torch.io.reads import ReadSet
        ctx = self.ctx
        with timed(self.phases, "write_s"):
            paths = data.write_sets(os.path.join(ctx.workdir, "sets"),
                                    self.index_names + self.query_names,
                                    self.index_codes + self.query_codes)
        self.engine = Engine(k=self.k, t=self.t, device=ctx.device)
        self.residents = []
        for name, path in zip(self.index_names, paths):
            rs = ReadSet(name)
            with timed(self.phases, f"parse_{name}_s"):
                rs.add_file(path)
            os.remove(path)
            with timed(self.phases, f"build_{name}_s"):
                r = self.engine.build_resident_planes(rs)
            if r is None:
                raise RuntimeError(f"{name} cannot stay resident as planes "
                                   f"at k={self.k}")
            self.residents.append(r)
        self.queries = []
        with timed(self.phases, "parse_queries_s"):
            for name, path in zip(self.query_names,
                                  paths[len(self.index_codes):]):
                rs = ReadSet(name)
                rs.add_file(path)
                os.remove(path)
                self.queries.append(rs)

    def _setup_control(self):
        self.control_planes = [[] for _ in self.index_codes]

        def keep(ri, pi, planes):
            self.control_planes[ri].append(planes.packed().view(torch.int32))

        with timed(self.phases, "control_s"):
            self.control_tags, self.control_counts, planes = reference(
                self.ctx.config, self.index_codes, self.query_codes,
                self.ctx.device, "a_only", each_partition=keep)
        del planes

    def warm_up(self):
        self._search(0, os.path.join(self.ctx.workdir, "warm"))

    def _search(self, qi: int, out: str):
        os.makedirs(out)
        if self.ctx.control:
            for ri, iname in enumerate(self.index_names):
                commet_ref.write_bv(os.path.join(
                    out, f"{self.query_bases[qi]}_in_{iname}.bv"),
                    self.control_tags[ri][qi])
                commet_ref.write_counters(os.path.join(
                    out, f"{self.query_names[qi]}_in_{iname}.log"),
                    self.control_counts[ri][qi])
            return
        q = self.queries[qi]
        for bv in q.result_bvs:
            bv.set_all_false()
        got = self.engine.search_multi_set_planes(
            q, self.residents, out_dir=out, log_dir=out)
        if got is None:
            raise RuntimeError(f"search_multi_set_planes declined {q.name}")

    def unit(self, i: int) -> dict:
        qi = i % len(self.query_codes)
        out = os.path.join(self.ctx.workdir, "out", f"u{i:05d}")
        self._search(qi, out)
        n = len(self.query_codes[qi])
        io = {} if self.ctx.control else dict(self.engine.last_io_stats)
        return {"work": {"reads": n * len(self.index_codes)}, "query": qi,
                "out": out, "io": io}

    def release(self):
        """Free the program's state but the resident planes it built,
        which the check compares."""
        if self.ctx.control:
            self.port_planes = self.control_planes
            self.control_planes = None
        else:
            self.port_planes = [r.partitions for r in self.residents]
            self.engine = self.residents = self.queries = None

    def check(self, units, want_bytes: bool) -> dict:
        k, t = self.k, self.t
        plane_bits = 0
        seen = [0] * len(self.index_codes)

        def each_partition(ri, pi, planes):
            nonlocal plane_bits
            seen[ri] += 1
            port = self.port_planes[ri]
            plane_bits += (compare.planes_differ(port[pi], planes.packed())
                           if pi < len(port) else 4 * (1 << k))

        want_tags, want_counts, ref = reference(
            self.ctx.config, self.index_codes, self.query_codes,
            self.ctx.device, each_partition=each_partition)
        plane_bits += 4 * (1 << k) * sum(
            len(port) != n for port, n in zip(self.port_planes, seen))
        least = None
        # one resident of one partition: the planes left in the reference
        # are the ones every unit probed
        if want_bytes and seen == [1]:
            least = [roofline.probe_bytes(ref, c, t)
                     for c in self.query_codes]
        del ref
        self.port_planes = None
        failed, tags_wrong, counters_wrong = set(), 0, 0
        for u in units:
            if u["error"] is not None:
                continue
            qi = u["query"]
            wrong = 0
            base = self.query_bases[qi]
            for ri, iname in enumerate(self.index_names):
                want = want_tags[ri][qi]
                try:
                    got = commet_ref.read_bv(os.path.join(
                        u["out"], f"{base}_in_{iname}.bv"), len(want))
                    w = compare.tags_differ(got, want)
                except (OSError, ValueError):
                    w = len(want)
                tags_wrong += w
                try:
                    c = commet_ref.read_counters(os.path.join(
                        u["out"], f"{self.query_names[qi]}_in_{iname}.log"))
                    cw = int(c != want_counts[ri][qi])
                except (OSError, ValueError, IndexError):
                    cw = 1
                counters_wrong += cw
                wrong += w + cw
            if wrong:
                failed.add(u["i"])
        checks = {"tags_wrong": {"value": tags_wrong, "limit": 0},
                  "counters_wrong": {"value": counters_wrong, "limit": 0},
                  "plane_bits_wrong": {"value": plane_bits, "limit": 0}}
        out = {"checks": checks, "failed": failed}
        if least is not None:
            out["least"] = {"probe_bytes": [
                least[u["query"]] for u in units if u["error"] is None]}
        return out
