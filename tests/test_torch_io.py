"""The port's own host layer (commet_tpu_torch.io, .native, .core.filter,
.cli.filter_reads) against commet_tpu's on the same numpy-seeded inputs:
.bv bytes, manifest parses, encoded read sets and packed batches, filter
decisions and filter_reads output bytes must be identical."""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest

from commet_tpu.cli import filter_reads as jfilter_cli
from commet_tpu.core import filter as jfilter
from commet_tpu.io import bv as jbv
from commet_tpu.io import fof as jfof
from commet_tpu.io import reads as jreads
from commet_tpu_torch.cli import filter_reads as tfilter_cli
from commet_tpu_torch.core import filter as tfilter
from commet_tpu_torch.engine import engine as tengine
from commet_tpu_torch.io import bv as tbv
from commet_tpu_torch.io import fof as tfof
from commet_tpu_torch.io import reads as treads
from commet_tpu_torch.native import parser as tnative
from torch_helpers import random_seqs

PORT = os.path.dirname(os.path.abspath(tnative.__file__))


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_bv_bytes_round_trip(tmp_path):
    """Random vectors (sizes on and off a byte boundary, empty): the port
    writes commet_tpu's bytes and reads them back; setting, filling,
    clearing and counting give commet_tpu's bytes and counts, padding bits
    included."""
    rng = np.random.default_rng(1)
    for size in (0, 1, 8, 13, 64, 1000):
        bits = [rng.random(size) < p for p in (0.5, 0.1)]
        vs = {}
        for name, mod in (("jax", jbv), ("torch", tbv)):
            a = mod.BitVector.from_bool_array(bits[0], comment="c\nx")
            b = mod.BitVector.from_bool_array(bits[1])
            a.write(str(tmp_path / f"{name}_a.bv"))
            back = mod.BitVector.read(str(tmp_path / f"{name}_a.bv"))
            assert back.comment == "c\nx" and back.size == size
            c = b.copy()
            c.set_many(np.nonzero(bits[0])[0])
            full = mod.BitVector(size, fill=True)
            full.data[-1] |= 0x80  # a padding bit: kept, not counted
            vs[name] = [back.data.tobytes(), c.data.tobytes(),
                        back.as_bool_array().tolist(), full.data.tobytes(),
                        (a.nb_one(), c.nb_one(), full.nb_one())]
            c.set_all_false()
            vs[name].append(c.data.tobytes())
        assert vs["torch"] == vs["jax"]
        assert _bytes(tmp_path / "torch_a.bv") == _bytes(tmp_path /
                                                         "jax_a.bv")


def test_fof_parsers_match(tmp_path):
    """Both manifest dialects: the C++ one with unnamed lines, and the
    driver's with several files per set, .bv columns or none, stray spaces
    and empty lines."""
    cxx = tmp_path / "cxx.txt"
    cxx.write_text(" s1 : a.fa,a.bv; b.fa , b.bv\nx.fa\n\ns0: c.fq.gz\ny.fa\n")
    assert tfof.parse_sets(str(cxx)) == jfof.parse_sets(str(cxx))
    for i, text in enumerate(("s1: a.fa,a.bv; b.fa , b.bv\n\n s2 :c.fq,c.bv\n",
                              "s1: a.fa; b.fa\ns0: c.fq.gz\n")):
        path = str(tmp_path / f"driver{i}.txt")
        with open(path, "w") as f:
            f.write(text)
        for fn in ("parse_sets", "driver_set_names", "driver_read_files",
                   "driver_read_bvs"):
            assert getattr(tfof, fn)(path) == getattr(jfof, fn)(path)
        assert (tfof.driver_read_bvs(path) is None) == (i == 1)


def _write_reads(path, seqs, fmt, gz):
    lines = []
    for i, s in enumerate(seqs):
        if fmt == "fasta":  # sequences split over lines, an empty line
            lines += [b">r%d" % i, s[:37], s[37:], b""]
        else:
            lines += [b"@r%d" % i, s, b"+", b"I" * len(s)]
    raw = b"\n".join(lines) + b"\n"
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(raw)


@pytest.mark.parametrize("fmt,gz", [("fasta", False), ("fasta", True),
                                    ("fastq", False), ("fastq", True)])
def test_read_set_matches(tmp_path, fmt, gz):
    """A read set of two files (fasta or fastq, plain or gzipped; reads
    with Ns, lower case, empty and short reads; a filter .bv on one file):
    the port's parse and record text equal commet_tpu's native and
    pure-Python parses, and its eligible rows, tags, result .bv bytes and
    packed batches equal commet_tpu's."""
    rng = np.random.default_rng(7 if gz else 8)
    paths = []
    for f in range(2):
        # fastq counts non-empty lines: its reads are never empty
        seqs = random_seqs(rng, 150, int(fmt == "fastq"), 120, n_frac=0.05)
        paths.append(str(tmp_path / f"r{f}.{fmt}{'.gz' if gz else ''}"))
        _write_reads(paths[-1], seqs, fmt, gz)
    keep = rng.random(150) < 0.7
    jbv.BitVector.from_bool_array(keep).write(str(tmp_path / "keep.bv"))
    sets = {}
    for name, mod in (("jax", jreads), ("torch", treads)):
        rs = mod.ReadSet("S")
        rs.add_file(paths[0])
        rs.add_file(paths[1], str(tmp_path / "keep.bv"))
        sets[name] = rs
    for p in paths:
        port = treads.load_read_file(p)
        for ref in (jreads.ReadFile(p), jreads.ReadFile(p, use_native=False)):
            assert port.nb_reads == ref.nb_reads
            assert (port.fmt, port.was_gzipped) == (ref.fmt, ref.was_gzipped)
            for got, want in zip(port.encoded(), ref.encoded()):
                np.testing.assert_array_equal(got, want)
            for got, want in zip(port.class_counts(), ref.class_counts()):
                np.testing.assert_array_equal(got, want)
            assert port.records == ref.records
            assert port.filter_bv.nb_one() == ref.nb_valid_reads()
    rows = sets["torch"].eligible()
    np.testing.assert_array_equal(rows, sets["jax"].eligible())
    pick = rows[rng.random(len(rows)) < 0.3]
    for name, rs in sets.items():
        rs.tag(pick[:, 0], pick[:, 1])
        os.makedirs(tmp_path / name)
        rs.save_result_bvs(str(tmp_path / name), "X")
    np.testing.assert_array_equal(sets["torch"].untagged_eligible(),
                                  sets["jax"].untagged_eligible())
    for p in paths:
        name = os.path.basename(p) + "_in_X.bv"
        assert _bytes(tmp_path / "torch" / name) == _bytes(tmp_path / "jax" /
                                                           name)
    enc = tengine.EncodedSet(sets["torch"])
    for lpad in (32, 128):
        got = enc.gather_packed(rows, lpad)
        want = [np.zeros((len(rows), -(-lpad // w)), dtype=np.uint32)
                for w in (16, 32)] + [np.zeros(len(rows), np.int32)]
        dirty = False
        for fi, rf in enumerate(sets["jax"].files):
            sel = np.nonzero(rows[:, 0] == fi)[0]
            out = jreads._native.gather_packed(*rf.encoded(), rows[sel, 1],
                                               lpad)
            for w, o in zip(want, out[:3]):
                w[sel] = o
            dirty |= out[3]
        for g, w in zip(got[:3], want):
            np.testing.assert_array_equal(g, w)
        assert got[3] == (not dirty)


@pytest.mark.parametrize("n_files", [1, 3])
def test_rows_tags_and_lengths_match(tmp_path, n_files):
    """Sets of one file and of several (a filter .bv on each, its padding
    bits set on one): the eligible and untagged rows, the tags of rows
    picked out of order, twice, and the rows' lengths equal commet_tpu's
    and a per-row count."""
    rng = np.random.default_rng(11 + n_files)
    sets = {"jax": jreads.ReadSet("S"), "torch": treads.ReadSet("S")}
    for f in range(n_files):
        seqs = random_seqs(rng, 40 + 13 * f, 0, 60)
        path = str(tmp_path / f"r{f}.fa")
        _write_reads(path, seqs, "fasta", False)
        keep = jbv.BitVector.from_bool_array(rng.random(len(seqs)) < 0.6)
        if f == 0:
            keep.full_not()
        keep.write(str(tmp_path / f"keep{f}.bv"))
        for rs in sets.values():
            rs.add_file(path, str(tmp_path / f"keep{f}.bv"))
    rows = sets["torch"].eligible()
    np.testing.assert_array_equal(rows, sets["jax"].eligible())
    lengths = tengine.EncodedSet(sets["torch"]).read_lengths(rows)
    np.testing.assert_array_equal(lengths, [
        sets["torch"].files[fi].encoded()[2][pos] for fi, pos in rows])
    for _ in range(2):
        pick = rows[rng.permutation(len(rows))[:len(rows) // 3]]
        for rs in sets.values():
            rs.tag(pick[:, 0], pick[:, 1])
        np.testing.assert_array_equal(sets["torch"].untagged_eligible(),
                                      sets["jax"].untagged_eligible())
        for got, want in zip(sets["torch"].result_bvs,
                             sets["jax"].result_bvs):
            np.testing.assert_array_equal(got.data, want.data)


def test_filter_functions_match():
    """shannon_index, class_counts, filter_reads and filter_reads_counts
    on reads with Ns, low-entropy and empty reads, every threshold kind and
    the max-reads cut."""
    rng = np.random.default_rng(3)
    seqs = random_seqs(rng, 400, 0, 90, n_frac=0.08)
    seqs[5], seqs[9], seqs[200] = b"A" * 60, b"ACACACAC" * 9, b""
    counts, lengths = tfilter.class_counts(seqs)
    for got, want in zip((counts, lengths), jfilter.class_counts(seqs)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfilter.shannon_index(counts, lengths),
                                  jfilter.shannon_index(counts, lengths))
    for kw in ({"min_size": 40}, {"max_n": 2}, {"min_shannon": 1.9},
               {"min_size": 20, "max_n": 4, "min_shannon": 1.5,
                "max_reads": 150}, {"max_reads": 0}):
        keep, stats = tfilter.filter_reads(seqs, **kw)
        want_keep, want_stats = jfilter.filter_reads(seqs, **kw)
        np.testing.assert_array_equal(keep, want_keep)
        assert stats == want_stats
        keep, stats = tfilter.filter_reads_counts(counts[:200],
                                                  lengths[:200], **kw)
        want_keep, want_stats = jfilter.filter_reads_counts(
            counts[:200], lengths[:200], **kw)
        np.testing.assert_array_equal(keep, want_keep)
        assert stats == want_stats


def test_filter_reads_cli_matches(tmp_path, monkeypatch):
    """filter_reads (length, N-count, Shannon and max-reads thresholds, a
    comment, the default output name): .bv bytes and stdout lines equal
    commet_tpu's, but for the time line."""
    rng = np.random.default_rng(4)
    seqs = random_seqs(rng, 300, 10, 120, n_frac=0.04)
    seqs[7] = b"T" * 80
    _write_reads(str(tmp_path / "in.fa"), seqs, "fasta", False)
    monkeypatch.chdir(tmp_path)
    for i, args in enumerate((["-l", "50"], ["-n", "1"], ["-e", "1.95"],
                              ["-l", "30", "-n", "3", "-e", "1.8", "-m",
                               "100", "-c", "note"], [])):
        runs = {}
        for name, cli in (("jax", jfilter_cli), ("torch", tfilter_cli)):
            out = [] if not args else ["-o", f"{name}{i}.bv"]
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                assert cli.main(["in.fa", *args, *out]) == 0
            path = f"{name}{i}.bv" if args else "in.fa.bv"
            runs[name] = (_bytes(tmp_path / path), [
                ln for ln in said.getvalue().splitlines()
                if not ln.startswith("Total  time")])
        assert runs["torch"] == runs["jax"]


def test_native_library_builds_in_port_build_dir(tmp_path, monkeypatch):
    """The port's native library comes from its own source, built with g++
    into commet_tpu_torch/_build/ under a name keyed by the source's hash;
    a source that does not compile raises with the compiler's message, and
    the engine's _native() raises too (no Python parse takes over)."""
    so = tnative._build()
    assert os.path.dirname(so) == os.path.join(os.path.dirname(PORT),
                                                "_build")
    assert os.path.basename(so).startswith("libcommet_io_")
    assert tnative.SOURCE == os.path.join(PORT, "src", "commet_io.cpp")
    assert tnative.load().cio_gather_packed is not None
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*bad.cpp"):
        tnative.load()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tengine._native()
