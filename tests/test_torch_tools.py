"""The port's host tools (bvop, extract_reads, generate_random_bv) against
the C++ reference's goldens under tests/golden/ and against commet_tpu's
tools on the same inputs: files, records and standard output byte for
byte."""

import gzip
import os
import random

import numpy as np
import pytest

from commet_tpu.cli import bvop as jbvop
from commet_tpu.cli import extract_reads as jextract
from commet_tpu.cli import generate_random_bv as jgrbv
from commet_tpu_torch.cli import bvop
from commet_tpu_torch.cli import extract_reads
from commet_tpu_torch.cli import generate_random_bv
from commet_tpu_torch.io.bv import BitVector

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "golden")
ABCDE = os.path.join(GOLDEN, "abcde")
UNIT = os.path.join(GOLDEN, "unit")
DATA = os.path.join(HERE, "data")
A2 = os.path.join(ABCDE, "A.fa_in_set2.bv")
A3 = os.path.join(ABCDE, "A.fa_in_set3.bv")


def _payload(path):
    """The golden's size line and payload: its comment names the operand
    paths of the run that made it, so the test rebuilds that part."""
    with open(path, "rb") as f:
        raw = f.read()
    return raw[raw.index(b"\n#"):]


@pytest.mark.parametrize("flag,word,golden", [
    ("-a", "AND", "and.bv"),
    ("-o", "OR", "or.bv"),
    ("-d", "AND (NOT", "andnot.bv"),
])
def test_bvop_binary_ops_golden(tmp_path, flag, word, golden):
    out = tmp_path / golden
    assert bvop.main([A2, flag, A3, "-p", str(out)]) == 0
    tail = ")" if flag == "-d" else ""
    want = f"{A2} {word} {A3}{tail}\n".encode() + _payload(
        os.path.join(UNIT, golden))
    assert out.read_bytes() == want


def test_bvop_not_golden(tmp_path):
    out = tmp_path / "not.bv"
    assert bvop.main([A2, "-n", "-p", str(out)]) == 0
    assert out.read_bytes() == f"NOT {A2}\n".encode() + _payload(
        os.path.join(UNIT, "not.bv"))


def test_bvop_info_golden(capsys):
    """-i prints the operand's comment and the popcount line the driver
    parses."""
    assert bvop.main([A2, "-i"]) == 0
    with open(os.path.join(UNIT, "info.txt")) as f:
        assert capsys.readouterr().out == f.read()


def test_bvop_stdout_and_argv_quirks_match_jax(capsysbinary):
    """Without -p the result goes to standard output; -i prints the
    operand's old comment first; an unknown flag prints the doc and a
    second positional a one-line error, both returning 0. The port's bytes
    and codes are commet_tpu's."""
    cases = ([A2, "-n"], [A2, "-a", A3, "-i"], [A2, "-o", A3],
             [A2, "-x"], [A2, A3], [])
    for argv in cases:
        got = []
        for cli in (bvop, jbvop):
            rc = cli.main(list(argv))
            cap = capsysbinary.readouterr()
            got.append((rc, cap.out, cap.err))
        assert got[0] == got[1], argv
    assert got[0][0] == 1  # no operand at all
    rc = bvop.main([A2, "-a", A3])
    out = capsysbinary.readouterr().out
    a, b = BitVector.read(A2), BitVector.read(A3)
    header = f"{A2} AND {A3}\n\n#{a.size}\n".encode()
    assert (rc, out) == (0, header + (a.data & b.data).tobytes())


def test_extract_reads_gz_golden(tmp_path, capsys):
    """Gzipped fasta in, gzipped records out (compared decompressed: the
    gzip header holds a time); without -o a gzipped input is an error."""
    bv = os.path.join(ABCDE, "B.fa_in_set1.bv")
    src = os.path.join(UNIT, "B.fa.gz")
    out = tmp_path / "B_in_set1.fa.gz"
    assert extract_reads.main([src, bv, "-o", str(out)]) == 0
    with gzip.open(out, "rb") as f:
        got = f.read()
    with open(os.path.join(UNIT, "B_in_set1.fa"), "rb") as f:
        assert got == f.read()
    assert extract_reads.main([src, bv]) == 1
    assert "no output file name" in capsys.readouterr().err


def _crlf_fasta(path, rng):
    """Multi-line sequences, CR line ends, empty lines and an N."""
    recs = []
    for i in range(40):
        seq = bytes(rng.choice(np.frombuffer(b"ACGTN", np.uint8), 70))
        recs.append(b">q%d desc\r\n%s\r\n\n%s\r\n" % (i, seq[:30], seq[30:]))
    path.write_bytes(b"".join(recs))


def test_extract_reads_matches_jax(tmp_path, capsysbinary):
    """qa.fq.gz (gzip out), qb.fq (to -o and to standard output) and a
    multi-line CR fasta through both packages' extract_reads: the same
    records."""
    rng = np.random.default_rng(5)
    crlf = tmp_path / "crlf.fa"
    _crlf_fasta(crlf, rng)
    for src, n in ((os.path.join(DATA, "qa.fq.gz"), 800),
                   (os.path.join(DATA, "qb.fq"), 700), (str(crlf), 40)):
        bv = BitVector.from_bool_array(rng.random(n) < 0.4)
        bv_path = str(tmp_path / "sel.bv")
        bv.write(bv_path)
        got = {}
        for name, cli in (("torch", extract_reads), ("jax", jextract)):
            out = tmp_path / f"{name}.out"
            assert cli.main([src, bv_path, "-o", str(out)]) == 0
            data = out.read_bytes()
            got[name] = gzip.decompress(data) if src.endswith(".gz") \
                else data
            if not src.endswith(".gz"):
                assert cli.main([src, bv_path]) == 0
                assert capsysbinary.readouterr().out == data
        assert got["torch"] == got["jax"]
        sep = b"\n@" if "fq" in src else b"\n>"
        assert got["torch"].count(sep) + 1 == bv.nb_one()
    assert b"\r\n" in got["torch"]


def test_generate_random_bv_matches_jax(tmp_path):
    """The same random.seed gives commet_tpu's bytes: one draw of Python's
    module-level generator per read, as the reference's rand() loop."""
    src = os.path.join(DATA, "B.fa.gz")
    blobs = []
    for name, cli in (("torch", generate_random_bv), ("jax", jgrbv)):
        random.seed(7)
        out = tmp_path / f"{name}.bv"
        assert cli.main([src, "25", str(out)]) == 0
        blobs.append(out.read_bytes())
    assert blobs[0] == blobs[1]
    bv = BitVector.read(str(tmp_path / "torch.bv"))
    assert bv.size == 12000
    assert 0.2 < bv.nb_one() / bv.size < 0.3
    assert bv.comment == "25 % random reads kept"
    assert generate_random_bv.main([src, "101", str(tmp_path / "x")]) == 1
