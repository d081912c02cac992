"""The port's commet driver on its default, amortized schedule against
commet_tpu's driver (stream forced on, the Pallas join in interpret mode) and
against its own classic rounds, with and without --one_vs_all: every .bv and
CSV byte-identical; a set that cannot stay resident, as a sorted index or in
plane cohorts, sends the driver to the classic rounds with a printed line.
Both drivers run the sorted-index route (COMMET_TPU_STREAM=force): these
small sets are above the fill gate. The plane cohorts are tested in
test_torch_planes_driver.py."""

import glob

import numpy as np

from commet_tpu.cli import commet as jcommet
from commet_tpu_torch.cli import commet as tcommet
from commet_tpu_torch.engine import engine as tengine
from torch_helpers import (file_bytes, force_jax_stream, implant,
                           random_seqs, write_fasta)

T = 2


def _driver_sets(tmp_path, k, n_sets=4):
    """Sets 2.. hold fragments of set 1; set 4 also of set 2."""
    rng = np.random.default_rng(2024)
    sets = [random_seqs(rng, 50, 60, 90, n_frac=0.01)]
    lines = []
    for s in range(n_sets):
        if s:
            sets.append(random_seqs(rng, 40 + 5 * s, 60, 90, n_frac=0.01))
            implant(rng, sets[0], sets[s], k, span=2)
            if s == 3:
                implant(rng, sets[1], sets[s], k, span=2, start=1)
        write_fasta(tmp_path / f"s{s}.fa", sets[s])
        lines.append(f"S{s}: {tmp_path}/s{s}.fa")
    fof = tmp_path / "sets.txt"
    fof.write_text("\n".join(lines) + "\n")
    return str(fof)


def _driver(cli, fof, out, k, extra=()):
    rc = cli.main([fof, "-k", str(k), "-t", str(T), "--no-plots", "-o",
                   out, *extra])
    assert rc == 0
    return file_bytes(glob.glob(out + "*_in_*.bv") + glob.glob(out + "*.csv"))


def test_driver_amortized_matches_jax_and_classic(tmp_path, monkeypatch,
                                                  capsys):
    k = 15
    fof = _driver_sets(tmp_path, k)
    force_jax_stream(monkeypatch)
    calls = []
    real = tengine.Engine.search_multi_set

    def spy(self, query_set, residents, **kw):
        calls.append(len(residents))
        return real(self, query_set, residents, **kw)

    monkeypatch.setattr(tengine.Engine, "search_multi_set", spy)
    want = _driver(jcommet, fof, str(tmp_path / "jax") + "/", k)
    capsys.readouterr()
    got = _driver(tcommet, fof, str(tmp_path / "torch") + "/", k,
                  ["--device", "cpu"])
    assert "schedule: amortized" in capsys.readouterr().out
    assert calls == [1, 2, 3]
    monkeypatch.setenv("COMMET_TPU_MULTI", "0")
    classic = _driver(tcommet, fof, str(tmp_path / "classic") + "/", k,
                      ["--device", "cpu"])
    assert "schedule: classic rounds" in capsys.readouterr().out
    assert calls == [1, 2, 3]
    assert len(got) == 4 * 3 + 3
    assert got == want
    assert got == classic
    plain = got["matrix_plain.csv"].decode().splitlines()
    assert int(plain[4].split(";")[2]) > 0  # S3 shares with S1


def test_driver_one_vs_all_matches_jax(tmp_path, monkeypatch):
    k = 15
    fof = _driver_sets(tmp_path, k)
    force_jax_stream(monkeypatch)
    want = _driver(jcommet, fof, str(tmp_path / "jax") + "/", k,
                   ["--one_vs_all"])
    got = _driver(tcommet, fof, str(tmp_path / "torch") + "/", k,
                  ["--one_vs_all", "--device", "cpu"])
    assert set(got) == ({f"s0.fa_in_S{j}.bv" for j in (1, 2, 3)}
                        | {f"s{j}.fa_in_S0.bv" for j in (1, 2, 3)}
                        | {"vector_plain.csv", "vector_percentage.csv"})
    assert got == want
    cells = got["vector_plain.csv"].decode().splitlines()[1].split(";")[1:]
    assert all(int(c.split("/")[1]) > 0 for c in cells)


def test_driver_falls_back_to_classic_with_a_line(tmp_path, monkeypatch,
                                                  capsys):
    """A set over the resident budget, with no room for plane cohorts: the
    classic rounds run, the line says so, and the outputs are unchanged."""
    k = 15
    fof = _driver_sets(tmp_path, k, n_sets=3)
    monkeypatch.setenv("COMMET_TPU_STREAM", "force")
    want = _driver(tcommet, fof, str(tmp_path / "a") + "/", k,
                   ["--device", "cpu"])
    capsys.readouterr()
    monkeypatch.setenv("COMMET_TPU_RESIDENT_BUDGET", "10")
    monkeypatch.setenv("COMMET_TPU_PLANES_BUDGET", "10")
    got = _driver(tcommet, fof, str(tmp_path / "b") + "/", k,
                  ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "schedule: classic rounds (S0 cannot stay resident" in out
    assert "the plane cohorts decline" in out
    assert got == want
