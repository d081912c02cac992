"""Step 0 of the all-vs-all on a plane cohort, as the driver runs it: the
index sets built in set-up by the driver's own cohort build
(``commet_tpu_torch.cli.commet.build_plane_cohort``: every set after the
first beside the residents already built, with the smaller bulk chunk,
under the plane budget), then one query set after another searched against
the whole cohort by one ``Engine.search_multi_set_planes`` call, a unit a
query set (each read counts once a resident).

Parameters: ``residents`` (the configuration's ``cohort``), ``queries`` and
``query_reads``, as ``step0_search`` reads them. The sets' layout, the
reference, the check and the control are ``step0_search``'s, by import:
only the first index set gives fragments, so the later residents are
probed for reads they do not hold.

A traced run's check also works out ``least["cohort_probe_bytes"]`` of
each unit: the query reads read once, 32 B for each distinct plane sector
that each resident's probe needs (``roofline.probe_sectors``, taken in the
reference's ``each_partition`` while that resident's planes are there),
and a tag bit a read for each resident.
"""

from __future__ import annotations

import os

from commet_bench import data, roofline
from commet_bench.tracing import timed
from commet_bench.traffic import step0_search
# the driver's cohort build: a program without it fails here, before any
# set is made
from commet_tpu_torch.cli.commet import PLANE_COHORT_MAX, build_plane_cohort
from commet_tpu_torch.engine.engine import Engine
from commet_tpu_torch.io.reads import ReadSet

make_inputs = step0_search.make_inputs


def cohort_probe_bytes(cfg, index_codes, query_codes, device):
    """The grouped probe's least bytes of each query set against every
    index set's planes."""
    t = cfg["t"]
    sectors = [0] * len(query_codes)

    def each_partition(_ri, _pi, planes):
        for qi, codes in enumerate(query_codes):
            sectors[qi] += roofline.probe_sectors(planes, codes, t)

    step0_search.reference(cfg, index_codes, [], device,
                           each_partition=each_partition)
    s = len(index_codes)
    return [roofline.read_bytes(codes) + roofline.SECTOR_BYTES * n
            + -(-s * len(codes) // 8)
            for codes, n in zip(query_codes, sectors)]


class Traffic(step0_search.Traffic):
    def setup(self):
        cfg, p = self.ctx.config, self.ctx.params
        if p["residents"] != cfg["cohort"]:
            raise ValueError(f"{p['residents']} residents: the configuration's"
                             f" cohort holds {cfg['cohort']}")
        super().setup()

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
        with timed(self.phases, "cohort_s"):
            self.residents, _bytes = build_plane_cohort(
                self.engine, load, 0, n, self.engine._planes_budget(None),
                PLANE_COHORT_MAX)
        if len(self.residents) < n:
            raise RuntimeError(f"{len(self.residents)} of {n} index sets "
                               f"stay resident as planes at k={self.k}")
        for name, r in zip(self.index_names, self.residents):
            self.phases[f"build_{name}_s"] = round(r.build_seconds, 3)
        self.queries = []
        with timed(self.phases, "parse_queries_s"):
            for name, path in zip(self.query_names, paths[n:]):
                rs = ReadSet(name)
                rs.add_file(path)
                os.remove(path)
                self.queries.append(rs)

    def check(self, units, want_bytes: bool) -> dict:
        out = super().check(units, want_bytes)
        if want_bytes:
            least = cohort_probe_bytes(self.ctx.config, self.index_codes,
                                       self.query_codes, self.ctx.device)
            out["least"] = {"cohort_probe_bytes": [
                least[u["query"]] for u in units if u["error"] is None]}
        return out
