"""The port's compare_reads (run with --device cpu) and commet_analysis
against commet_tpu's on the same inputs: .bv bytes, .log counter lines,
CSV bytes and the tools' messages and exit codes."""

import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from commet_tpu.cli import commet as jcommet
from commet_tpu.cli import commet_analysis as janalysis
from commet_tpu.cli import compare_reads as jcompare
from commet_tpu_torch.cli import commet_analysis
from commet_tpu_torch.cli import compare_reads
from commet_tpu_torch.cli import index_and_search
from commet_tpu_torch.io.bv import BitVector
from torch_helpers import (file_bytes, force_jax_stream, implant, last_line,
                           random_seqs, write_fasta)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 21
# the one line of the port's usage that commet_tpu's has not
DEVICE_LINE = "--device <name>: cuda (default; fails without a card) or cpu.\n"


def _two_sets(tmp_path, filters=False):
    """Set files a.txt (A) and b.txt (B): B's even reads hold 2k fragments
    of A's reads; with ``filters`` each file carries a filter .bv."""
    rng = np.random.default_rng(41)
    a = random_seqs(rng, 90, 60, 85, n_frac=0.01)
    b = random_seqs(rng, 110, 60, 85, n_frac=0.01)
    implant(rng, a, b, K, span=2)
    for name, seqs in (("a", a), ("b", b)):
        fa = tmp_path / f"{name}.fa"
        write_fasta(fa, seqs)
        entry = str(fa)
        if filters:
            bv = BitVector.from_bool_array(rng.random(len(seqs)) < 0.8)
            bv.write(str(tmp_path / f"{name}.bv"))
            entry += f",{tmp_path}/{name}.bv"
        (tmp_path / f"{name}.txt").write_text(
            f"{name.upper()}: {entry}\n")


def _outputs(out):
    """{name: bytes} of the result vectors and {name: counter line} of the
    logs in ``out``."""
    blobs = file_bytes(glob.glob(out + "/*.bv"))
    blobs.update({os.path.basename(p): last_line(p)
                  for p in glob.glob(out + "/*.log")})
    return blobs


def _run_both(tmp_path, capsys):
    got = {}
    for name, cli, extra in (("jax", jcompare, []),
                             ("torch", compare_reads, ["--device", "cpu"])):
        out = str(tmp_path / name)
        rc = cli.main(["-i", str(tmp_path / "a.txt"), "-s",
                       str(tmp_path / "b.txt"), "-k", str(K), "-t", "2",
                       "-o", out, "-l", out] + extra)
        assert rc == 0
        got[name] = _outputs(out)
        got[name + " stdout"] = capsys.readouterr().out
    assert set(got["torch"]) == {"a.fa_in_B.bv", "b.fa_in_A.bv",
                                 "A_in_B.log", "B_in_A.log"}
    return got


@pytest.mark.parametrize("route", ["0", "force"])
def test_compare_reads_matches_jax(tmp_path, monkeypatch, capsys, route):
    """COMMET_TPU_STREAM=0 (every index on the planes) and =force (every
    index sorted; commet_tpu's Pallas join in interpret mode)."""
    if route == "force":
        force_jax_stream(monkeypatch)
    else:
        monkeypatch.setenv("COMMET_TPU_STREAM", route)
    _two_sets(tmp_path)
    got = _run_both(tmp_path, capsys)
    assert got["torch"] == got["jax"]
    assert got["torch stdout"] == got["jax stdout"]
    assert BitVector.read(str(tmp_path / "torch" / "b.fa_in_A.bv")).nb_one()


def test_compare_reads_with_filters_matches_jax(tmp_path, capsys):
    _two_sets(tmp_path, filters=True)
    got = _run_both(tmp_path, capsys)
    assert got["torch"] == got["jax"]


def test_compare_reads_equals_index_and_search_full(tmp_path, capsys):
    """index_and_search -f runs the same three passes: the same .bv bytes
    and counter lines."""
    _two_sets(tmp_path)
    outs = {}
    for name, cli in (("cr", compare_reads), ("full", index_and_search)):
        out = str(tmp_path / name)
        argv = ["-i", str(tmp_path / "a.txt"), "-s", str(tmp_path / "b.txt"),
                "-k", str(K), "-t", "2", "-o", out, "-l", out, "--device",
                "cpu"]
        assert cli.main(argv + (["-f"] if name == "full" else [])) == 0
        outs[name] = _outputs(out)
    assert len(outs["cr"]) == 4
    assert outs["cr"] == outs["full"]


def test_compare_reads_argv_errors_match_jax(tmp_path, capsys):
    """No argv prints the usage to stderr and returns 0; a trailing valued
    flag and a missing -i or -s exit 1 with commet_tpu's messages (the
    port's usage has one more line, for --device)."""
    fof = str(tmp_path / "x.txt")
    cases = ([], ["-i", fof, "-k"], ["-i", fof, "--device"], ["-s", fof],
             ["-i", fof])
    for argv in cases:
        got = []
        for cli in (compare_reads, jcompare):
            try:
                code = cli.main(list(argv))
            except SystemExit as exc:
                code = exc.code
            got.append((code, capsys.readouterr().err.replace(
                DEVICE_LINE, "")))
        if "--device" in argv:  # a flag only the port knows
            assert got[0] == (1, "Error, flag --device needs an argument\n")
            continue
        assert got[0] == got[1], argv
    assert got[0][0] == 1
    assert "Error: -i and -s are mandatory" in got[0][1]


def test_compare_reads_cuda_without_card_fails(tmp_path):
    """At the default --device (cuda) and with --device cuda, no card means
    a non-zero exit before any output is written."""
    _two_sets(tmp_path)
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    for extra in ([], ["--device", "cuda"]):
        out = str(tmp_path / "out")
        proc = subprocess.run(
            [sys.executable, "-m", "commet_tpu_torch.cli.compare_reads",
             "-i", str(tmp_path / "a.txt"), "-s", str(tmp_path / "b.txt"),
             "-k", str(K), "-o", out, "-l", out] + extra,
            cwd=str(tmp_path), env=env, capture_output=True, text=True,
            timeout=120)
        assert proc.returncode != 0
        assert "no CUDA card" in proc.stderr
        assert not os.path.exists(out)


def test_commet_analysis_matches_jax(tmp_path, capsys):
    """commet_analysis over a commet_tpu driver's output directory (its
    .bv files carried across): the port rewrites commet_tpu's CSVs byte for
    byte and prints what commet_tpu's prints."""
    rng = np.random.default_rng(17)
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
    drv = str(tmp_path / "drv") + "/"
    assert jcommet.main([fof, "-k", str(K), "-t", "2", "--no-plots",
                         "-o", drv]) == 0
    csvs = ["matrix_plain.csv", "matrix_percentage.csv",
            "matrix_normalized.csv"]
    want = file_bytes([drv + c for c in csvs])
    capsys.readouterr()
    got = {}
    for name, cli in (("torch", commet_analysis), ("jax", janalysis)):
        out = str(tmp_path / name) + "/"
        shutil.copytree(drv, out, ignore=shutil.ignore_patterns("*.csv"))
        assert cli.main([fof, "-o", out, "--no-plots"]) == 0
        got[name] = (file_bytes([out + c for c in csvs]),
                     capsys.readouterr().out.replace(out, "<out>"))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == want
