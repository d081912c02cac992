"""The port's commet --jobs / --sge (the classic rounds as a job DAG, run
with --device cpu) against its serial classic run and against commet_tpu's
--jobs: the same .bv, matrix and marker files, set loads beside the
search that holds the device, resume from the .job_<name>.done markers in
either direction, and a failed job failing the run."""

import glob
import os
import threading
import time

import numpy as np
import pytest

from commet_tpu.cli import commet as jcommet
from commet_tpu_torch.cli import commet
from commet_tpu_torch.engine.engine import Engine
from torch_helpers import file_bytes, implant, random_seqs, write_fasta

K = 21


def _sets(tmp_path):
    """Three sets: sets 1 and 2 hold 2k fragments of set 0's reads."""
    rng = np.random.default_rng(23)
    base = random_seqs(rng, 60, 50, 90, n_frac=0.02)
    lines = []
    for i in range(3):
        seqs = base if i == 0 else random_seqs(rng, 50 + 10 * i, 50, 90,
                                               n_frac=0.02)
        if i:
            implant(rng, base, seqs, K, span=2)
        write_fasta(tmp_path / f"s{i}.fa", seqs)
        lines.append(f"set{i}: {tmp_path}/s{i}.fa")
    fof = str(tmp_path / "sets.txt")
    with open(fof, "w") as f:
        f.write("\n".join(lines) + "\n")
    return fof


def _run(cli, fof, out, *flags):
    extra = ["--device", "cpu"] if cli is commet else []
    rc = cli.main([fof, "-k", str(K), "-t", "2", "-l", "50", "--no-plots",
                   "-o", out, *flags] + extra)
    assert rc == 0


def _files(out, markers=True):
    paths = glob.glob(out + "*_in_*.bv") + glob.glob(out + "*.csv")
    return file_bytes(paths + (glob.glob(out + ".job_*") if markers
                               else []))


def _said(capsys, out):
    """Standard output so far, with the output directory named <out>/ and
    without the filter's timing lines."""
    text = capsys.readouterr().out.replace(out, "<out>/")
    return [ln for ln in text.splitlines() if "time :" not in ln]


def _log_mtimes(out):
    return {os.path.basename(p): os.stat(p).st_mtime_ns
            for p in glob.glob(out + "*.log")}


def test_jobs_match_classic_and_jax(tmp_path, monkeypatch, capsys):
    """--jobs 2 writes the serial classic run's files, and commet_tpu's
    --jobs 2 files, markers and standard output."""
    fof = _sets(tmp_path)
    out = {name: str(tmp_path / name) + "/"
           for name in ("jobs", "jax", "classic")}
    _run(commet, fof, out["jobs"], "--jobs", "2")
    said = _said(capsys, out["jobs"])
    _run(jcommet, fof, out["jax"], "--jobs", "2")
    assert _said(capsys, out["jax"]) == said
    assert "All Commet work is done" in said
    monkeypatch.setenv("COMMET_TPU_MULTI", "0")
    _run(commet, fof, out["classic"])
    got = _files(out["jobs"])
    assert got == _files(out["jax"])
    assert sorted(p for p in got if p.startswith(".job_")) == [
        ".job_0_in_1.done", ".job_0_in_2.done", ".job_1_in_0.done",
        ".job_1_in_2.done", ".job_2_in_0.done", ".job_2_in_1.done",
        ".job_all_in_0.done", ".job_all_in_1.done"]
    assert _files(out["jobs"], markers=False) == _files(out["classic"])
    assert len(_files(out["classic"])) == 3 * 2 + 3


def test_one_vs_all_jobs(tmp_path, capsys):
    """--one_vs_all --jobs 2 runs set 1's round only and writes the
    vectors of the port's default --one_vs_all and of commet_tpu's."""
    fof = _sets(tmp_path)
    runs = {}
    for name, cli, flags in (("jobs", commet, ["--jobs", "2"]),
                             ("default", commet, []),
                             ("jax", jcommet, ["--jobs", "2"])):
        out = str(tmp_path / name) + "/"
        _run(cli, fof, out, "--one_vs_all", *flags)
        runs[name] = file_bytes(glob.glob(out + "vector_*.csv")
                                + glob.glob(out + "*_in_*.bv"))
    assert runs["jobs"] == runs["default"] == runs["jax"]
    assert len(runs["jobs"]) == 2 + 2 * 2
    assert not os.path.exists(tmp_path / "jobs" / ".job_all_in_1.done")


def test_resume_skips_done_and_recomputes_one_pair(tmp_path, capsys):
    """A re-run with --sge prints the SGE line and rewrites no .log; with
    one pair's markers deleted a third run recomputes exactly that pair,
    and the files stay equal."""
    fof = _sets(tmp_path)
    out = str(tmp_path / "out") + "/"
    _run(commet, fof, out, "--jobs", "2")
    first = _files(out)
    m1 = _log_mtimes(out)
    assert len(m1) == 6
    time.sleep(0.05)
    capsys.readouterr()
    _run(commet, fof, out, "--sge")
    assert "SGE mode requested: running as an in-process job DAG\n" in \
        capsys.readouterr().out
    assert _log_mtimes(out) == m1
    assert _files(out) == first
    os.remove(out + ".job_0_in_2.done")
    os.remove(out + ".job_2_in_0.done")
    time.sleep(0.05)
    _run(commet, fof, out, "--jobs", "2")
    m2 = _log_mtimes(out)
    assert {f for f in m1 if m2[f] != m1[f]} == {"set0_in_set2.log",
                                                 "set2_in_set0.log"}
    assert _files(out) == first


def test_failed_job_fails_the_run_then_resumes(tmp_path, monkeypatch):
    """A fault in the third engine call fails the --jobs run with the DAG's
    RuntimeError; the jobs done before keep their markers, and a plain
    re-run completes the classic run's files."""
    fof = _sets(tmp_path)
    out = str(tmp_path / "out") + "/"
    real = Engine.index_and_search
    calls = []

    def flaky(self, index_set, query_sets, **kw):
        calls.append(index_set.name)
        if len(calls) == 3:
            raise RuntimeError("injected fault: card lost")
        return real(self, index_set, query_sets, **kw)

    monkeypatch.setattr(Engine, "index_and_search", flaky)
    with pytest.raises(RuntimeError, match="job failed: injected fault"):
        _run(commet, fof, out, "--jobs", "2")
    monkeypatch.setattr(Engine, "index_and_search", real)
    done_before = {f for f in os.listdir(out) if f.startswith(".job_")}
    assert 2 <= len(done_before) < 8
    assert not os.path.exists(out + "matrix_plain.csv")
    _run(commet, fof, out, "--jobs", "2")
    assert done_before <= {f for f in os.listdir(out)
                           if f.startswith(".job_")}
    monkeypatch.setenv("COMMET_TPU_MULTI", "0")
    clean = str(tmp_path / "clean") + "/"
    _run(commet, fof, clean)
    assert _files(out, markers=False) == _files(clean)


def test_markers_carry_across_packages(tmp_path, capsys):
    """In commet_tpu's --jobs 2 output directory with one pair's markers
    deleted, the port's --jobs 2 recomputes exactly that pair and leaves
    commet_tpu's files as they were; and the other way round."""
    fof = _sets(tmp_path)
    for first, second in ((jcommet, commet), (commet, jcommet)):
        out = str(tmp_path / first.__name__.split(".")[0]) + "/"
        _run(first, fof, out, "--jobs", "2")
        files = _files(out)
        m1 = _log_mtimes(out)
        os.remove(out + ".job_0_in_1.done")
        os.remove(out + ".job_1_in_0.done")
        time.sleep(0.05)
        _run(second, fof, out, "--jobs", "2")
        m2 = _log_mtimes(out)
        assert {f for f in m1 if m2[f] != m1[f]} == {"set0_in_set1.log",
                                                     "set1_in_set0.log"}
        assert _files(out) == files


def test_jobs_load_while_another_searches(tmp_path, monkeypatch):
    """Under --jobs 2 a job loads its sets while another job's search holds
    the device, and no two searches run at once; the files stay the
    classic run's."""
    fof = _sets(tmp_path)
    real_search, real_load = Engine.index_and_search, commet._load_set
    searching = []
    loads_during_search = []
    lock = threading.Lock()

    def search(self, index_set, query_sets, **kw):
        with lock:
            searching.append(index_set.name)
            assert len(searching) == 1
        time.sleep(0.2)
        try:
            return real_search(self, index_set, query_sets, **kw)
        finally:
            with lock:
                searching.pop()

    def load(name, files, bvs):
        with lock:
            loads_during_search.append(bool(searching))
        return real_load(name, files, bvs)

    monkeypatch.setattr(Engine, "index_and_search", search)
    monkeypatch.setattr(commet, "_load_set", load)
    out = str(tmp_path / "jobs") + "/"
    _run(commet, fof, out, "--jobs", "2")
    assert len(loads_during_search) == 3 + 2 + 2 * 2 * 3
    assert any(loads_during_search)
    monkeypatch.setattr(Engine, "index_and_search", real_search)
    monkeypatch.setattr(commet, "_load_set", real_load)
    monkeypatch.setenv("COMMET_TPU_MULTI", "0")
    clean = str(tmp_path / "clean") + "/"
    _run(commet, fof, clean)
    assert _files(out, markers=False) == _files(clean)
