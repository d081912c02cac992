"""No file of commet_bench imports JAX, the JAX package or the old bench
script, and the reference imports nothing of the program. Modules are
compared by their top-level name as a whole word, so commet_tpu_torch is
not commet_tpu."""

import ast
import os

from commet_bench import harness

NEVER = {"jax", "jaxlib", "flax", "commet_tpu", "bench", "chip_smoke"}


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _dirs, files in os.walk(os.path.join(harness.HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: sorted(set(imported(p)) & NEVER) for p in sources()}
    assert not {p: n for p, n in found.items() if n}
    assert "commet_tpu_torch" in {m for p in sources("traffic")
                                  for m in imported(p)}


def test_reference_imports_nothing_of_the_program():
    for p in sources("reference"):
        assert not set(imported(p)) & {"commet_tpu_torch", "commet_tpu"}
    assert set(imported(os.path.join(harness.HERE, "reference",
                                     "commet_ref.py"))) <= {
        "__future__", "numpy", "torch"}


def test_whole_word_compare():
    assert "commet_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "commet_tpu.engine".split(".")[0] in harness.FORBIDDEN
