"""The port stands alone: no file of commet_tpu_torch, and not
chip_smoke.py, imports the JAX package (commet_tpu), checked on the source
by an AST scan; a copy of commet_tpu_torch alone, with no commet_tpu beside it,
runs the driver, filter_reads, compare_reads and bvop on the CPU and builds
its native library inside itself; and the card tests import the port's read
sets."""

import ast
import glob
import os
import shutil
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_imports(path):
    """(line, module) of every import of commet_tpu or commet_tpu.* in the
    file, at any depth (module level or inside a function)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, n) for n in names
                  if n == "commet_tpu" or n.startswith("commet_tpu.")]
    return found


def test_port_sources_import_no_reference():
    paths = glob.glob(os.path.join(REPO, "commet_tpu_torch", "**", "*.py"),
                      recursive=True)
    assert len(paths) > 15
    bad = {os.path.relpath(p, REPO): _reference_imports(p) for p in paths}
    assert {p: f for p, f in bad.items() if f} == {}


def test_chip_scripts_import_no_reference():
    path = os.path.join(REPO, "chip_smoke.py")
    assert _reference_imports(path) == []


def test_scan_finds_reference_imports(tmp_path):
    """The scan itself: every form of import of commet_tpu is found, the
    port's own modules and relative imports are not."""
    src = tmp_path / "m.py"
    src.write_text(textwrap.dedent("""
        import commet_tpu
        import os, commet_tpu.io.bv as bv
        from commet_tpu.io import reads
        from commet_tpu_torch.io import reads as ok
        import commet_tpu_torch
        from . import sibling

        def late():
            from commet_tpu.cli.util import guarded
        """))
    assert [m for _line, m in _reference_imports(str(src))] == [
        "commet_tpu", "commet_tpu.io.bv", "commet_tpu.io",
        "commet_tpu.cli.util"]


def test_card_tests_import_the_port_reads():
    """tests/test_torch_gpu.py runs where commet_tpu may be absent: it and
    the helpers it imports load no commet_tpu module at import time."""
    for name in ("test_torch_gpu.py", "torch_helpers.py"):
        with open(os.path.join(REPO, "tests", name)) as f:
            tree = ast.parse(f.read())
        top = [n for n in tree.body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        mods = [a.name for n in top if isinstance(n, ast.Import)
                for a in n.names] + [n.module for n in top
                                     if isinstance(n, ast.ImportFrom)]
        assert not [m for m in mods
                    if m == "commet_tpu" or m.startswith("commet_tpu.")]
    with open(os.path.join(REPO, "tests", "test_torch_gpu.py")) as f:
        assert "from commet_tpu_torch.io.reads import ReadSet" in f.read()


def test_port_copy_runs_alone(tmp_path):
    """commet_tpu_torch copied alone into an empty directory (no build
    products, no commet_tpu beside it): filter_reads, the driver,
    compare_reads and bvop run on the CPU in a fresh interpreter, no
    commet_tpu module is loaded, and the native library is built inside the
    copy's _build/."""
    shutil.copytree(os.path.join(REPO, "commet_tpu_torch"),
                    tmp_path / "commet_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    script = textwrap.dedent("""
        import sys
        from commet_tpu_torch.cli import (bvop, commet, compare_reads,
                                          filter_reads)
        for name, seq in (("a", "ACGTTGCAAGGCTTACGATCGATCGGATCCA" * 3),
                          ("b", "TTGCAAGGCTTACGATCGATCGGATCCAAC" * 3)):
            with open(f"{name}.fa", "w") as f:
                f.write(f">r0\\n{seq}\\n>r1\\nACGTNCGTACGT\\n")
        with open("sets.txt", "w") as f:
            f.write("A: a.fa\\nB: b.fa\\n")
        for name in "ab":
            with open(f"{name}.txt", "w") as f:
                f.write(f"{name.upper()}: {name}.fa\\n")
        assert filter_reads.main(["a.fa", "-l", "20", "-o", "a.bv"]) == 0
        assert commet.main(["sets.txt", "-k", "15", "--no-plots", "-o",
                            "out", "--device", "cpu"]) == 0
        assert compare_reads.main(["-i", "a.txt", "-s", "b.txt", "-k", "15",
                                   "-o", "cr", "-l", "cr", "--device",
                                   "cpu"]) == 0
        assert bvop.main(["cr/b.fa_in_A.bv", "-n", "-p", "not.bv"]) == 0
        loaded = sorted(m for m in sys.modules if m == "commet_tpu"
                        or m.startswith(("commet_tpu.", "jax")))
        assert not loaded, loaded
        print("ALONE_OK")
        """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ALONE_OK" in proc.stdout
    assert sorted(os.listdir(tmp_path)) == [
        "a.bv", "a.fa", "a.txt", "b.fa", "b.txt", "commet_tpu_torch", "cr",
        "not.bv", "out", "sets.txt"]
    assert sorted(os.listdir(tmp_path / "cr")) == [
        "A_in_B.log", "B_in_A.log", "a.fa_in_B.bv", "b.fa_in_A.bv"]
    built = os.listdir(tmp_path / "commet_tpu_torch" / "_build")
    assert [b for b in built if b.startswith("libcommet_io_")]
    assert os.path.exists(tmp_path / "out" / "matrix_plain.csv")
