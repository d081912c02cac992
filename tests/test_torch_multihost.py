"""The port's commet driver over more than one process and more than one
device, on the CPU: two ranks joined through COMMET_TPU_COORDINATOR (gloo on
a free localhost port) stride the comparison rounds over a shared output
directory, then the port's commet_analysis writes the matrices; and
``--devices 2 --device cpu`` runs the engine on a mesh of two CPU shards.
Both write the result .bv's, the .log counter lines and the CSVs of a
one-process, one-device port run byte for byte, and at k = 15 those of
commet_tpu's one-process run (tests/test_multihost.py:68-97's sets). At
k = 33 commet_tpu's driver is left out: it peaks at 4.6 GB on the CPU."""

import contextlib
import glob
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from commet_tpu.cli import commet as jcommet
from commet_tpu_torch.cli import commet as tcommet
from commet_tpu_torch.cli import commet_analysis
from torch_helpers import LUT, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fof(tmp_path, k):
    """test_multihost.py's three sets of 80 random 90 bp reads (120 bp at
    k = 33), each later set holding 2k fragments of set 0 in its even
    reads."""
    rng = np.random.default_rng(5)
    length = 120 if k > 32 else 90
    sets = [[bytes(LUT[rng.integers(0, 4, length)]) for _ in range(80)]
            for _ in range(3)]
    for seqs in sets[1:]:
        for i in range(0, 80, 2):
            d = sets[0][int(rng.integers(80))]
            at = int(rng.integers(0, length - 2 * k + 1))
            seqs[i] = seqs[i][:at] + d[at:at + 2 * k] + seqs[i][at + 2 * k:]
    lines = []
    for s, seqs in enumerate(sets):
        write_fasta(tmp_path / f"set{s}.fa", seqs)
        lines.append(f"set{s}: {tmp_path}/set{s}.fa")
    fof = tmp_path / "fof.txt"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


def _outputs(out):
    """{name: bytes} of the result .bv's and CSVs, the .log counter lines."""
    got = {}
    for path in sorted(glob.glob(out + "*_in_*.bv")
                       + glob.glob(out + "matrix_*.csv")):
        with open(path, "rb") as f:
            got[os.path.basename(path)] = f.read()
    for path in sorted(glob.glob(out + "*.log")):
        with open(path) as f:
            got[os.path.basename(path)] = f.read().splitlines()[-1]
    return got


def _run(cli, fof, out, k, *extra):
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = cli.main([fof, "-k", str(k), "-o", out, "--no-plots", *extra])
    assert rc == 0
    return said.getvalue()


def _reference_outputs(tmp_path, fof, k):
    """The one-process port run's outputs, equal at k = 15 to commet_tpu's."""
    one = _outputs_of(tmp_path, "one", tcommet, fof, k, "--device", "cpu")
    assert len(one) == 3 * 2 + 3 + 6
    if k <= 32:
        assert _outputs_of(tmp_path, "jax", jcommet, fof, k) == one
    return one


def _outputs_of(tmp_path, name, cli, fof, k, *extra):
    out = str(tmp_path / name) + "/"
    _run(cli, fof, out, k, *extra)
    return _outputs(out)


@pytest.mark.parametrize("k", [15, 33])
def test_two_ranks_then_analysis_match_one_process(tmp_path, monkeypatch,
                                                   k):
    """Two `python -m commet_tpu_torch.cli.commet ... --device cpu` ranks
    (rank 0 filters, both meet at the barrier, rank r runs rounds r, r + 2)
    print their rank lines and stop before the matrices; commet_analysis
    then writes the one-process run's CSVs, next to its .bv's and logs."""
    monkeypatch.delenv("COMMET_TPU_DEVICES", raising=False)
    fof = _fof(tmp_path, k)
    out = str(tmp_path / "ranks") + "/"
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {key: v for key, v in os.environ.items()
               if key not in ("PYTHONPATH", "COMMET_TPU_DEVICES")}
        env.update({"COMMET_TPU_COORDINATOR": f"localhost:{port}",
                    "COMMET_TPU_NUM_PROCESSES": "2",
                    "COMMET_TPU_PROCESS_ID": str(rank)})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "commet_tpu_torch.cli.commet", fof, "-k",
             str(k), "-o", out, "--no-plots", "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    said = []
    try:
        for p in procs:
            said.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for rank, (p, text) in enumerate(zip(procs, said)):
        assert p.returncode == 0, text[-3000:]
        assert f"multi-host run: rank {rank}/2 finished its rounds" in text
    assert "All in set0" in said[0] and "All in set1" in said[1]
    assert "Filtering" in said[0] and "Filtering" not in said[1]
    assert not glob.glob(out + "matrix_*.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        assert commet_analysis.main([fof, "-o", out, "--no-plots"]) == 0
    assert _outputs(out) == _reference_outputs(tmp_path, fof, k)


@pytest.mark.parametrize("k", [15, 33])
def test_devices_two_on_cpu_match_one(tmp_path, monkeypatch, k):
    """commet --devices 2 --device cpu (a mesh of two CPU shards: the
    classic rounds, DP mode) writes the files of --devices 1."""
    monkeypatch.delenv("COMMET_TPU_DEVICES", raising=False)
    fof = _fof(tmp_path, k)
    out = str(tmp_path / "two") + "/"
    said = _run(tcommet, fof, out, k, "--devices", "2", "--device", "cpu")
    assert "schedule: classic rounds (a mesh of 2 devices, dp mode" in said
    assert os.environ["COMMET_TPU_DEVICES"] == "2"
    one = _outputs_of(tmp_path, "devices1", tcommet, fof, k, "--devices",
                      "1", "--device", "cpu")
    assert _outputs(out) == one == _reference_outputs(tmp_path, fof, k)
