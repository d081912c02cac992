"""Step 0 of the all-vs-all over shallow samples on the sorted route, as
the driver runs it: the index sets built in set-up by the driver's own
sorted-resident build (``commet_tpu_torch.cli.commet.
build_sorted_residents``: each a resident sorted index,
``Engine.build_resident``), then one query set after another searched
against all of them by one ``Engine.search_multi_set`` call (one sorted
query stream a batch, one grouped join launch for every slot, each slot's
AMBIG reads through the exact fallback), a unit a query set (each read
counts once a resident).

Parameters: ``residents`` (the configuration's ``cohort``), ``queries`` and
``query_reads``. Configuration: ``k``, ``t``, ``set_reads``, ``read_len``,
``n_share``. The layout (``make_inputs``) is ``data.make_cohort``'s but
for one change: query read 2i holds a 2k bp N-free fragment of a random
read of resident i mod ``residents``, so every resident shares reads with
every query set and is probed for the others.

Compared: every unit's tags and counters as ``step0_search`` compares
them, and ``index_pairs_wrong``, the residents whose sorted index differs
from the reference's (``reference/sorted_index.py``: each partition's
distinct forward-window pairs and value sets, by count and order-free
digest, and whether the columns are sorted). The program's indexes are
reduced in ``release``, before they are freed: the reference's byte
planes (4 x 2^k bytes) do not fit on the card beside them.

The control is ``step0_search``'s, keya alone deciding membership; its
indexes are the reference's own.

A traced run's check also works out ``least["join_probe_bytes"]`` of each
unit (``reference_index``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from commet_bench import compare, data, roofline
from commet_bench.reference import commet_ref, sorted_index
from commet_bench.tracing import timed
from commet_bench.traffic import step0_search
# the driver's sorted-resident build: a program without it fails here,
# before any set is made
from commet_tpu_torch.cli.commet import build_sorted_residents
from commet_tpu_torch.engine.engine import Engine
from commet_tpu_torch.io.reads import ReadSet


def make_inputs(cfg, p, seed):
    """(index set codes, query set codes), lists of [n, L] uint8: query
    read 2i holds a 2k bp fragment of a random read of index set
    i mod ``residents``; ``n_share`` of each set's reads carry one N, drawn
    among the reads that neither hold nor give a fragment."""
    rng = np.random.default_rng(seed)
    n_res, length = p["residents"], cfg["read_len"]
    index = [data.random_reads(rng, cfg["set_reads"], length)
             for _ in range(n_res)]
    query = [data.random_reads(rng, p["query_reads"], length)
             for _ in range(p["queries"])]
    used_index = [np.zeros(len(s), dtype=bool) for s in index]
    used_query = []
    for q in query:
        even = np.arange(0, len(q), 2)
        for r in range(n_res):
            donors, _clean = data.implant(rng, q, index[r], even[r::n_res],
                                          np.arange(len(index[r])),
                                          2 * cfg["k"])
            used_index[r][donors] = True
        used = np.zeros(len(q), dtype=bool)
        used[even] = True
        used_query.append(used)
    for s, used in zip(index + query, used_index + used_query):
        data.add_ns(rng, s, np.nonzero(~used)[0], cfg["n_share"])
    return index, query


def window_keya(codes: np.ndarray, k: int, device) -> torch.Tensor:
    """The keya of every valid window of reads ``codes`` on both strands,
    int64."""
    out = []
    for start in range(0, len(codes), commet_ref.BLOCK_READS):
        c = torch.from_numpy(codes[start:start + commet_ref.BLOCK_READS]).to(
            device).to(torch.int64)
        wk = commet_ref.window_keys(c, k)
        out += [wk["fa"][wk["ok"]], wk["ra"][wk["ok"]]]
        del wk, c
    return (torch.cat(out) if out
            else torch.zeros(0, dtype=torch.int64, device=device))


def join_sectors(ika: torch.Tensor, qa: torch.Tensor) -> int:
    """The distinct 32 B sectors of a sorted keya column ``ika`` (int64, 8 B
    an entry) at the lower-bound positions of query keys ``qa``, plus those
    of the keyb column beside it at the positions whose keya is present."""
    mi = ika.shape[0]
    if mi == 0 or qa.shape[0] == 0:
        return 0
    pos = torch.searchsorted(ika, qa).clamp_(max=mi - 1)
    present = ika[pos] == qa
    pos //= roofline.SECTOR_BYTES // 8
    return (int(torch.unique(pos).numel())
            + int(torch.unique(pos[present]).numel()))


def reference_index(cfg, index_codes, query_codes, device):
    """The reference's view of every index set's sorted index: (each set's
    partition summaries, ``sorted_index.pairs_summary`` of its distinct
    pairs; the grouped join's least bytes of each query set against them
    all: the query reads read once, each resident partition's keya and keyb
    sectors that the reads' windows on both strands need, ``join_sectors``,
    and a tag bit a read for each resident)."""
    k = cfg["k"]
    qas = [window_keya(q, k, device) for q in query_codes]
    summaries, sectors = [], [0] * len(query_codes)
    for codes in index_codes:
        summaries.append([])
        for ika, ikb in sorted_index.partition_pairs(
                codes, np.ones(len(codes), dtype=bool), k,
                commet_ref.max_kmer_for(k), device):
            summaries[-1].append(sorted_index.pairs_summary(ika, ikb))
            for qi, qa in enumerate(qas):
                sectors[qi] += join_sectors(ika, qa)
            del ika, ikb
    del qas
    s = len(index_codes)
    return summaries, [roofline.read_bytes(q) + roofline.SECTOR_BYTES * n
                       + -(-s * len(q) // 8)
                       for q, n in zip(query_codes, sectors)]


class Traffic(step0_search.Traffic):
    def setup(self):
        cfg, p, ctx = self.ctx.config, self.ctx.params, self.ctx
        if p["residents"] != cfg["cohort"]:
            raise ValueError(f"{p['residents']} residents: the configuration's"
                             f" cohort holds {cfg['cohort']}")
        self.phases = {}
        with timed(self.phases, "make_s"):
            self.index_codes, self.query_codes = make_inputs(cfg, p,
                                                             ctx.seed)
        self.index_names = [f"index{i + 1}"
                            for i in range(len(self.index_codes))]
        self.query_names = [f"query{i + 1}"
                            for i in range(len(self.query_codes))]
        self.query_bases = [name + ".fa" for name in self.query_names]
        if ctx.control:
            self._setup_control()
        else:
            self._setup_program()

    def _setup_program(self):
        ctx = self.ctx
        with timed(self.phases, "write_s"):
            paths = data.write_sets(os.path.join(ctx.workdir, "sets"),
                                    self.index_names + self.query_names,
                                    self.index_codes + self.query_codes)
        self.engine = Engine(k=self.k, t=self.t, device=ctx.device)

        def load(i):
            rs = ReadSet(self.index_names[i])
            with timed(self.phases, f"parse_{self.index_names[i]}_s"):
                rs.add_file(paths[i])
            os.remove(paths[i])
            return rs

        n = len(self.index_codes)
        with timed(self.phases, "residents_s"):
            self.residents, _bytes = build_sorted_residents(
                self.engine, load, n, None)
        if len(self.residents) < n:
            raise RuntimeError(f"{len(self.residents)} of {n} index sets "
                               f"stay resident as sorted indexes at "
                               f"k={self.k}")
        fills = [r.total_kmers / float(2 ** self.k) for r in self.residents]
        self.phases["fill_min"] = round(min(fills), 5)
        self.phases["fill_max"] = round(max(fills), 5)
        self.queries = []
        with timed(self.phases, "parse_queries_s"):
            for name, path in zip(self.query_names, paths[n:]):
                rs = ReadSet(name)
                rs.add_file(path)
                os.remove(path)
                self.queries.append(rs)

    def _setup_control(self):
        with timed(self.phases, "control_s"):
            self.control_tags, self.control_counts, planes = \
                step0_search.reference(self.ctx.config, self.index_codes,
                                       self.query_codes, self.ctx.device,
                                       "a_only")
            del planes
            self.control_index, _least = reference_index(
                self.ctx.config, self.index_codes, [], self.ctx.device)

    def _search(self, qi: int, out: str):
        if self.ctx.control:
            return super()._search(qi, out)
        os.makedirs(out)
        q = self.queries[qi]
        for bv in q.result_bvs:
            bv.set_all_false()
        if self.engine.search_multi_set(q, self.residents, out_dir=out,
                                        log_dir=out) is None:
            raise RuntimeError(f"search_multi_set declined {q.name}")

    def unit(self, i: int) -> dict:
        out = super().unit(i)
        out["candidates"] = len(self.query_codes[out["query"]])
        return out

    def release(self):
        """Reduce each resident's sorted indexes (``sorted_index.summary``)
        and free the program's state."""
        if self.ctx.control:
            self.port_index = self.control_index
            self.control_index = None
            return
        self.port_index = [
            [sorted_index.summary(sx.ika, sx.ikb, sx.sb, sx.sc, sx.sd)
             for sx in r.partitions] for r in self.residents]
        self.engine = self.residents = self.queries = None

    def check(self, units, want_bytes: bool) -> dict:
        cfg, dev = self.ctx.config, self.ctx.device
        want_index, least = reference_index(
            cfg, self.index_codes, self.query_codes if want_bytes else [],
            dev)
        index_wrong = sum(port != want for port, want
                          in zip(self.port_index, want_index))
        self.port_index = None
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        want_tags, want_counts, planes = step0_search.reference(
            cfg, self.index_codes, self.query_codes, dev)
        del planes
        failed, tags_wrong, counters_wrong = set(), 0, 0
        for u in units:
            if u["error"] is not None:
                continue
            qi, wrong = u["query"], 0
            for ri, iname in enumerate(self.index_names):
                want = want_tags[ri][qi]
                try:
                    got = commet_ref.read_bv(os.path.join(
                        u["out"], f"{self.query_bases[qi]}_in_{iname}.bv"),
                        len(want))
                    w = compare.tags_differ(got, want)
                except (OSError, ValueError):
                    w = len(want)
                try:
                    c = commet_ref.read_counters(os.path.join(
                        u["out"], f"{self.query_names[qi]}_in_{iname}.log"))
                    cw = int(c != want_counts[ri][qi])
                except (OSError, ValueError, IndexError):
                    cw = 1
                tags_wrong += w
                counters_wrong += cw
                wrong += w + cw
            if wrong:
                failed.add(u["i"])
        checks = {"tags_wrong": {"value": tags_wrong, "limit": 0},
                  "counters_wrong": {"value": counters_wrong, "limit": 0},
                  "index_pairs_wrong": {"value": index_wrong, "limit": 0}}
        out = {"checks": checks, "failed": failed}
        if want_bytes:
            out["least"] = {"join_probe_bytes": [
                least[u["query"]] for u in units if u["error"] is None]}
        return out
