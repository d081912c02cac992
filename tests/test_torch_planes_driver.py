"""The port's commet driver with its plane cohorts (the sets are above the
fill gate) against commet_tpu's driver with its plane cohorts
(COMMET_TPU_PLANE_COHORTS=force: the JAX CPU driver skips them otherwise) and
against the port's own classic rounds on planes: every .bv and CSV
byte-identical, in one cohort and in several (COMMET_TPU_PLANE_COHORT_MAX=2);
with one index set (--one_vs_all) the cohorts decline with a printed line;
and the sorted-index, plane and default routes write the same files."""

import numpy as np

from commet_tpu.cli import commet as jcommet
from commet_tpu_torch.cli import commet as tcommet
from commet_tpu_torch.engine import engine as tengine
from test_torch_multi_driver import _driver, _driver_sets
from torch_helpers import implant, random_seqs, write_fasta

K = 15


def _spy_multi(monkeypatch):
    calls = []
    real = tengine.Engine.search_multi_set_planes

    def spy(self, query_set, residents, **kw):
        calls.append(len(residents))
        return real(self, query_set, residents, **kw)

    monkeypatch.setattr(tengine.Engine, "search_multi_set_planes", spy)
    return calls


def test_driver_plane_cohorts_match_jax_and_classic(tmp_path, monkeypatch,
                                                    capsys):
    fof = _driver_sets(tmp_path, K)
    monkeypatch.setenv("COMMET_TPU_PLANE_COHORTS", "force")
    calls = _spy_multi(monkeypatch)
    want = _driver(jcommet, fof, str(tmp_path / "jax") + "/", K)
    capsys.readouterr()
    got = _driver(tcommet, fof, str(tmp_path / "torch") + "/", K,
                  ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "schedule: plane cohorts (S0, S1, S2 resident as planes" in out
    assert calls == [1, 2, 3]
    monkeypatch.setenv("COMMET_TPU_MULTI", "0")
    classic = _driver(tcommet, fof, str(tmp_path / "classic") + "/", K,
                      ["--device", "cpu"])
    assert "schedule: classic rounds" in capsys.readouterr().out
    assert calls == [1, 2, 3]
    assert len(got) == 4 * 3 + 3
    assert got == want
    assert got == classic
    plain = got["matrix_plain.csv"].decode().splitlines()
    assert int(plain[4].split(";")[2]) > 0  # S3 shares with S1


def test_driver_several_cohorts_match_jax(tmp_path, monkeypatch, capsys):
    """Cohorts of at most two index sets: {S0, S1} then {S2}."""
    fof = _driver_sets(tmp_path, K)
    monkeypatch.setenv("COMMET_TPU_PLANE_COHORTS", "force")
    monkeypatch.setenv("COMMET_TPU_PLANE_COHORT_MAX", "2")
    calls = _spy_multi(monkeypatch)
    want = _driver(jcommet, fof, str(tmp_path / "jax") + "/", K)
    capsys.readouterr()
    got = _driver(tcommet, fof, str(tmp_path / "torch") + "/", K,
                  ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("schedule: plane cohorts") == 2
    assert "schedule: plane cohorts (S2 resident as planes" in out
    assert calls == [1, 2, 2, 1]
    assert got == want


def test_driver_one_index_set_declines_cohorts(tmp_path, monkeypatch,
                                               capsys):
    """--one_vs_all has one index set: nothing to amortize, so the classic
    rounds run on planes, say why, and write JAX's files."""
    fof = _driver_sets(tmp_path, K)
    monkeypatch.setenv("COMMET_TPU_PLANE_COHORTS", "force")
    want = _driver(jcommet, fof, str(tmp_path / "jax") + "/", K,
                   ["--one_vs_all"])
    capsys.readouterr()
    got = _driver(tcommet, fof, str(tmp_path / "torch") + "/", K,
                  ["--one_vs_all", "--device", "cpu"])
    out = capsys.readouterr().out
    assert ("schedule: classic rounds (S0 cannot stay resident as a sorted "
            "index") in out
    assert "the plane cohorts decline: one index set" in out
    assert got == want


def test_driver_routes_agree(tmp_path, monkeypatch, capsys):
    """Sets at k = 21 below the fill gate: the default run (sorted indexes,
    amortized), COMMET_TPU_STREAM=0 (planes everywhere: plane cohorts and
    plane refinement) and =force (sorted everywhere) write byte-identical
    files."""
    k = 21
    rng = np.random.default_rng(55)
    base = random_seqs(rng, 60, 60, 90, n_frac=0.01)
    lines = []
    for s in range(4):
        seqs = base if s == 0 else random_seqs(rng, 50, 60, 90, n_frac=0.01)
        if s:
            implant(rng, base, seqs, k, span=2)
        write_fasta(tmp_path / f"r{s}.fa", seqs)
        lines.append(f"R{s}: {tmp_path}/r{s}.fa")
    fof = tmp_path / "sets.txt"
    fof.write_text("\n".join(lines) + "\n")
    outs, said = {}, {}
    for mode in ("1", "0", "force"):
        monkeypatch.setenv("COMMET_TPU_STREAM", mode)
        outs[mode] = _driver(tcommet, str(fof), str(tmp_path / mode) + "/",
                             k, ["--device", "cpu"])
        said[mode] = capsys.readouterr().out
    assert "schedule: amortized" in said["1"]
    assert "schedule: plane cohorts" in said["0"]
    assert "schedule: amortized" in said["force"]
    assert len(outs["1"]) == 4 * 3 + 3
    assert outs["1"] == outs["0"] == outs["force"]
