#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (commet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line with its seconds:
  1. card: the GPU's name and power limit (nvidia-smi) and torch's name;
  2. build: the hand-written join kernel from commet_tpu_torch/core/csrc/;
  3. kernel: the join kernel against its plain PyTorch version on the card
     at the main path's shapes (a 64M-pair k=32 index, 9M queries: one
     65,536-read batch of 100 bp x 2 strands x 69 windows); verdicts must be
     identical; both times by CUDA events;
  4. golden: the port's index_and_search CLI on tests/data (qa.fq.gz indexed,
     qb.fq searched, k=21, t=2) must reproduce tests/golden/unit/fq/, the
     C++ reference's payload and counters;
  5. main path: the port's commet driver (classic schedule, k=32, t=2) on
     three 1M-read x 100 bp fasta sets made from a numpy seed, sets 2 and 3
     carrying 64 bp fragments of set 1 in half their reads, 1% of reads with
     an N; the matrices must exist and the shared counts against set 1 must
     equal the counts known from the construction; the join kernel must have
     been launched.
Then one JSON line with the kernels' figures and, last, the device line.
Any failure raises; without a CUDA card, or without the repository beside
this script, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
K = 32
T = 2
INDEX_PAIRS = 64 << 20
QUERY_PAIRS = 65536 * 2 * (100 - K + 1)
SET_READS = 1_000_000
READ_LEN = 100
FRAG = 2 * K
JOIN_SOURCE = "commet_tpu_torch/core/csrc/join.cu"
JOIN_REPLACES = "commet_tpu/core/stream.py:67"


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(device, rng, index_pairs: int, query_pairs: int):
    """Join kernel vs join_membership_plain at the main path's shapes."""
    import torch
    from commet_tpu_torch.core import stream
    top = 1 << K
    a = rng.integers(0, top, index_pairs, dtype=np.int64)
    b = rng.integers(0, top, index_pairs, dtype=np.int64)
    run = index_pairs // 8  # equal-keya runs with other keyb values
    a[index_pairs // 2:index_pairs // 2 + run] = a[:run]
    dup = index_pairs // 16  # exact duplicate pairs
    a[-dup:], b[-dup:] = a[:dup], b[:dup]
    a[1], b[1] = top - 1, top - 1  # all-G/T key
    sidx = stream.finalize_index([torch.from_numpy(a).to(device)],
                                 [torch.from_numpy(b).to(device)])
    pick = rng.integers(0, index_pairs, query_pairs)
    qa, qb = a[pick], b[pick]
    third = query_pairs // 3
    qb[third:2 * third] = rng.integers(0, top, third)  # keya-only hits
    qa[2 * third:] = rng.integers(0, top, query_pairs - 2 * third)  # absent
    qa[0], qb[0] = top - 1, top - 1
    del a, b
    qa_t = torch.from_numpy(qa).to(device)
    qb_t = torch.from_numpy(qb).to(device)
    qa_s, order = torch.sort(qa_t)  # the stream probe joins sorted keys
    qb_s = qb_t[order]

    def kernel():
        return stream.join_membership(sidx.ika, sidx.ikb, sidx.mi, qa_s, qb_s)

    def plain():
        return stream.join_membership_plain(sidx.ika, sidx.ikb, sidx.mi,
                                            qa_s, qb_s)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"join kernel disagrees with plain version on "
                             f"{int((got != want).sum())} of {query_pairs}")
    counts = torch.bincount(got.to(torch.int64), minlength=3).tolist()
    if min(counts[:3]) == 0:
        raise AssertionError(f"verdict classes not all exercised: {counts}")
    empty = stream.join_membership(sidx.ika, sidx.ikb, 0, qa_s, qb_s)
    if int(empty.max()) != stream.NONMEM:
        raise AssertionError("empty index prefix must give NONMEM only")
    ms = cuda_ms(kernel, 10)
    plain_ms = cuda_ms(plain, 3)
    # the cost and benefit of sorting the queries (kept for locality)
    unsorted_ms = cuda_ms(lambda: stream.join_membership(
        sidx.ika, sidx.ikb, sidx.mi, qa_t, qb_t), 10)

    def sort_unsort():
        sk, perm = torch.sort(qa_t)
        skb = qb_t[perm]
        out = torch.empty_like(got)
        out[perm] = got
        return sk, skb, out

    sort_ms = cuda_ms(sort_unsort, 10)
    return {"counts": counts, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "unsorted_ms": unsorted_ms,
            "sort_unsort_ms": sort_ms, "mi": sidx.mi,
            "launches": stream.join_membership.launches}


def phase_golden(device: str, tmp: str) -> str:
    """The port's index_and_search on the in-repo fq golden: the .bv bytes
    after its comment line (the comment names the input path, which moved)
    and the counter line must equal the C++ reference's."""
    from commet_tpu_torch.cli import index_and_search
    data = os.path.join(HERE, "tests", "data")
    golden = os.path.join(HERE, "tests", "golden", "unit", "fq")
    fof_i, fof_s = os.path.join(tmp, "idx.txt"), os.path.join(tmp, "qry.txt")
    with open(fof_i, "w") as f:
        f.write(f"QA: {data}/qa.fq.gz\n")
    with open(fof_s, "w") as f:
        f.write(f"QB: {data}/qb.fq\n")
    out = os.path.join(tmp, "golden_out")
    rc = index_and_search.main(["-i", fof_i, "-s", fof_s, "-o", out, "-l",
                                out, "-k", "21", "-t", "2", "--device",
                                device])
    if rc != 0:
        raise AssertionError(f"index_and_search exited {rc}")
    with open(os.path.join(out, "qb.fq_in_QA.bv"), "rb") as f:
        comment, got = f.read().split(b"\n", 1)
    with open(os.path.join(golden, "qb.fq_in_QA.bv"), "rb") as f:
        want = f.read().split(b"\n", 1)[1]
    if comment != f"{data}/qb.fq in QA".encode() or got != want:
        raise AssertionError("qb.fq_in_QA.bv differs from the golden")
    with open(os.path.join(out, "QB_in_QA.log")) as f:
        counters = f.read().splitlines()[-1]
    with open(os.path.join(golden, "QB_in_QA.log.counters")) as f:
        if counters != f.read().strip():
            raise AssertionError(f"counters {counters} differ from golden")
    return counters


def _write_fasta(path: str, codes: np.ndarray) -> None:
    """[n, L] codes (0..3, 4 = N) -> fasta with headers >r<8 digits>."""
    n = codes.shape[0]
    head = np.empty((n, 11), dtype=np.uint8)
    head[:, 0], head[:, 1], head[:, 10] = ord(">"), ord("r"), ord("\n")
    head[:, 2:10] = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) \
        % 10 + ord("0")
    body = np.frombuffer(b"ACGTN", np.uint8)[codes]
    newline = np.full((n, 1), ord("\n"), dtype=np.uint8)
    np.concatenate([head, body, newline], axis=1).tofile(path)


def make_sets(rng, tmp: str, n_reads: int):
    """Three fasta sets; returns the manifest path and, per set j > 0, the
    exact shared counts against set 1 known from the construction:
    (set j reads holding an N-free fragment, distinct set-1 donors of such
    fragments)."""
    sets = [rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)
            for _ in range(3)]
    for s in sets:  # 1% of reads carry one N
        rows = rng.choice(n_reads, n_reads // 100, replace=False)
        s[rows, rng.integers(0, READ_LEN, len(rows))] = 4
    expected = []
    for s in sets[1:]:
        rows = np.arange(0, n_reads, 2)  # half the reads get a fragment
        donors = rng.integers(0, n_reads, len(rows))
        src = rng.integers(0, READ_LEN - FRAG + 1, len(rows))
        dst = rng.integers(0, READ_LEN - FRAG + 1, len(rows))
        off = np.arange(FRAG)
        frag = sets[0][donors[:, None], src[:, None] + off]
        s[rows[:, None], dst[:, None] + off] = frag
        # the bases beside a fragment differ from the donor's, so a shared
        # window never extends past it: a read is shared iff its fragment
        # is N-free (two non-overlapping k-mers)
        for side, ok in ((-1, (src > 0) & (dst > 0)),
                         (FRAG, (src + FRAG < READ_LEN)
                          & (dst + FRAG < READ_LEN))):
            r, qs, ds = rows[ok], dst[ok] + side, src[ok] + side
            s[r, qs] = (sets[0][donors[ok], ds] + 1) % 4
        clean = (frag < 4).all(axis=1)
        expected.append((int(clean.sum()), len(np.unique(donors[clean]))))
    lines = []
    for i, s in enumerate(sets):
        path = os.path.join(tmp, f"set{i + 1}.fa")
        _write_fasta(path, s)
        lines.append(f"set{i + 1}: {path}")
    fof = os.path.join(tmp, "sets.txt")
    with open(fof, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fof, expected


def phase_main_path(device: str, rng, tmp: str, n_reads: int):
    """The commet driver on three sets; returns per-call wall times."""
    import torch
    from commet_tpu_torch.cli import commet
    from commet_tpu_torch.device import synchronize
    from commet_tpu_torch.engine.engine import Engine
    fof, expected = make_sets(rng, tmp, n_reads)
    calls = []
    real = Engine.index_and_search

    def timed(self, index_set, query_sets, **kw):
        t0 = time.perf_counter()
        out = real(self, index_set, query_sets, **kw)
        synchronize(self.device)
        calls.append((f"{'+'.join(q.name for q in query_sets)} in "
                      f"{index_set.name}", time.perf_counter() - t0))
        return out

    Engine.index_and_search = timed
    try:
        out = os.path.join(tmp, "commet_out") + "/"
        rc = commet.main([fof, "-k", str(K), "-t", str(T), "--no-plots",
                          "-o", out, "--device", device])
    finally:
        Engine.index_and_search = real
    if rc != 0:
        raise AssertionError(f"commet exited {rc}")
    for kind in ("plain", "percentage", "normalized"):
        if not os.path.exists(out + f"matrix_{kind}.csv"):
            raise AssertionError(f"matrix_{kind}.csv missing")
    with open(out + "matrix_plain.csv") as f:
        rows = [ln.split(";") for ln in f.read().splitlines()]
    plain = np.array([[int(v) for v in r[1:]] for r in rows[1:]])
    for j, (n_query, n_donor) in enumerate(expected, start=1):
        if plain[j, 0] != n_query or plain[0, j] != n_donor:
            raise AssertionError(
                f"set{j + 1} vs set1: matrix ({plain[j, 0]}, {plain[0, j]}) "
                f"!= expected ({n_query}, {n_donor})")
    if not (plain[0, 1:] > 0).all() or not (plain[1:, 0] > 0).all():
        raise AssertionError(f"no shared reads against set1:\n{plain}")
    peak = (torch.cuda.max_memory_allocated()
            if device.startswith("cuda") else 0)
    return calls, plain, peak


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "commet_tpu_torch")):
        print("chip_smoke.py: run it from the repository (commet_tpu_torch "
              "is not beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from commet_tpu_torch.core import _cuda, stream
    from commet_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    rng = np.random.default_rng(2024)

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(smi)
    log(f"phase card: {name}, {torch.cuda.device_count()} device(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda} "
        f"({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    _cuda.load("join")
    log(f"phase build: join.cu built with nvcc and loaded "
        f"({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    kern = phase_kernel(device, rng, INDEX_PAIRS, QUERY_PAIRS)
    log(f"phase kernel: join on {kern['mi']} index pairs x {QUERY_PAIRS} "
        f"sorted queries, verdicts identical (NONMEM/CAND/CONF "
        f"{kern['counts'][:3]}); kernel {kern['ms']:.4f} ms, plain "
        f"{kern['plain_ms']:.4f} ms, kernel on unsorted queries "
        f"{kern['unsorted_ms']:.4f} ms, query sort+unsort "
        f"{kern['sort_unsort_ms']:.4f} ms, {kern['launches']} launches "
        f"({time.perf_counter() - t0:.3f} s)")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        counters = phase_golden("cuda", tmp)
        log(f"phase golden: qb.fq_in_QA.bv bytes equal, {counters} "
            f"({time.perf_counter() - t0:.3f} s)")

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        stream.join_membership.launches = 0
        t0 = time.perf_counter()
        calls, plain, peak = phase_main_path("cuda", rng, tmp, SET_READS)
        launches = stream.join_membership.launches
        if launches == 0:
            raise AssertionError("the main path never launched the join "
                                 "kernel")
        for what, secs in calls:
            log(f"  index_and_search {what}: {secs:.3f} s")
        log(f"phase main path: commet -k {K} -t {T} on 3 x {SET_READS} "
            f"reads, matrix_plain rows {plain.tolist()}, join launches "
            f"{launches}, max_memory_allocated {peak} B "
            f"({time.perf_counter() - t0:.3f} s)")

    loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    if loaded:
        raise AssertionError(f"the port imported JAX: {loaded[:5]}")
    log(f"total {time.perf_counter() - t_start:.3f} s")
    log(json.dumps({"kernels": [{
        "name": "join", "route": "cuda", "source": JOIN_SOURCE,
        "replaces": JOIN_REPLACES, "launches": launches,
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
