"""The port's CLIs (run with --device cpu) against the in-repo golden from
the C++ reference and against commet_tpu's CLIs on the same inputs: .bv
bytes, .log counter lines and matrix CSV bytes must be identical."""

import glob
import os

import numpy as np
import pytest

from commet_tpu.cli import commet as jcommet
from commet_tpu.cli import index_and_search as jias
from commet_tpu_torch.cli import commet as tcommet
from commet_tpu_torch.cli import index_and_search as tias
from commet_tpu_torch.io.bv import BitVector
from torch_helpers import implant, random_seqs, write_fasta

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden", "unit", "fq")
DATA = os.path.join(HERE, "data")


def _last_line(path):
    with open(path) as f:
        return f.read().splitlines()[-1]


def _read_bytes(paths):
    out = {}
    for p in sorted(paths):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def test_index_and_search_fq_golden(tmp_path):
    """qa.fq.gz indexed, qb.fq searched at k=21, t=2: payload and counters
    of the C++ reference's run."""
    fof_i = tmp_path / "index.txt"
    fof_s = tmp_path / "search.txt"
    fof_i.write_text(f"QA: {DATA}/qa.fq.gz\n")
    fof_s.write_text(f"QB: {DATA}/qb.fq\n")
    out = tmp_path / "out"
    rc = tias.main(["-i", str(fof_i), "-s", str(fof_s), "-o", str(out),
                    "-l", str(out), "-k", "21", "-t", "2", "--device", "cpu"])
    assert rc == 0
    got = BitVector.read(str(out / "qb.fq_in_QA.bv"))
    want = BitVector.read(os.path.join(GOLDEN, "qb.fq_in_QA.bv"))
    assert got.size == want.size
    assert (got.data == want.data).all()
    with open(os.path.join(GOLDEN, "QB_in_QA.log.counters")) as f:
        assert _last_line(str(out / "QB_in_QA.log")) == f.read().strip()


def _two_sets(tmp_path, k):
    rng = np.random.default_rng(41)
    a = random_seqs(rng, 90, 60, 85, n_frac=0.01)
    b = random_seqs(rng, 110, 60, 85, n_frac=0.01)
    implant(rng, a, b, k, span=2)
    write_fasta(tmp_path / "a.fa", a)
    write_fasta(tmp_path / "b.fa", b)
    (tmp_path / "a.txt").write_text(f"A: {tmp_path}/a.fa\n")
    (tmp_path / "b.txt").write_text(f"B: {tmp_path}/b.fa\n")


def test_index_and_search_full_three_pass_matches_jax(tmp_path):
    """-f: the 3-pass two-set comparison in one invocation."""
    k = 21
    _two_sets(tmp_path, k)
    blobs = {}
    for name, cli, extra in (("jax", jias, []),
                             ("torch", tias, ["--device", "cpu"])):
        out = str(tmp_path / name)
        rc = cli.main(["-i", str(tmp_path / "a.txt"),
                       "-s", str(tmp_path / "b.txt"), "-k", str(k),
                       "-t", "2", "-f", "-o", out, "-l", out] + extra)
        assert rc == 0
        blobs[name] = _read_bytes(glob.glob(out + "/*.bv"))
        blobs[name].update({os.path.basename(p): _last_line(p)
                            for p in glob.glob(out + "/*.log")})
    assert set(blobs["torch"]) == {"a.fa_in_B.bv", "b.fa_in_A.bv",
                                   "A_in_B.log", "B_in_A.log"}
    assert blobs["torch"] == blobs["jax"]


def test_commet_driver_matches_jax(tmp_path):
    """The all-vs-all driver (classic schedule, filtering included) on three
    small sets: identical matrices and result vectors."""
    k = 21
    rng = np.random.default_rng(17)
    base = random_seqs(rng, 70, 50, 90, n_frac=0.02)
    lines = []
    for i in range(3):
        seqs = base if i == 0 else random_seqs(rng, 60 + 10 * i, 50, 90,
                                               n_frac=0.02)
        if i:
            implant(rng, base, seqs, k, span=2)
        write_fasta(tmp_path / f"s{i}.fa", seqs)
        lines.append(f"set{i}: {tmp_path}/s{i}.fa")
    fof = tmp_path / "sets.txt"
    fof.write_text("\n".join(lines) + "\n")
    outs = {}
    for name, cli, extra in (("jax", jcommet, []),
                             ("torch", tcommet, ["--device", "cpu"])):
        out = str(tmp_path / name) + "/"
        rc = cli.main([str(fof), "-k", str(k), "-t", "2", "-l", "50",
                       "--no-plots", "-o", out] + extra)
        assert rc == 0
        outs[name] = _read_bytes(glob.glob(out + "matrix_*.csv")
                                 + glob.glob(out + "*_in_*.bv"))
    assert len(outs["torch"]) == 3 + 3 * 2
    assert outs["torch"] == outs["jax"]
    plain = outs["torch"]["matrix_plain.csv"].decode().splitlines()
    assert all(int(v) > 0 for v in plain[1].split(";")[1:])


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--devices", "all"]])
def test_commet_unported_options_fail(tmp_path, capsys, flags):
    """More than one card is not ported: --devices other than 1 exits
    non-zero and names the ROADMAP."""
    with pytest.raises(SystemExit) as exc:
        tcommet.main([str(tmp_path / "sets.txt"), "--device", "cpu"] + flags)
    assert exc.value.code != 0
    assert "not yet ported (ROADMAP)" in capsys.readouterr().err
