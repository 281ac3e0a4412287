"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the program; names are compared by their
whole top-level part."""

import ast
import os
import sys

from benchmark import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "wheeledlab_tpu"}


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(spec.BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    found = {(p, m) for p in sources() for m in imported(p) if m in FORBIDDEN}
    assert not found


def test_reference_is_independent_of_the_program():
    found = {(p, m) for p in sources("reference") for m in imported(p)
             if m.startswith("wheeledlab")}
    assert not found


def test_the_run_names_whole_top_level_modules(monkeypatch):
    sys.path.insert(0, spec.BENCH)
    try:
        import run
    finally:
        sys.path.remove(spec.BENCH)
    monkeypatch.setitem(sys.modules, "wheeledlab_torch_x", sys)
    assert "wheeledlab_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "wheeledlab_tpu.rl", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert {"wheeledlab_tpu", "jax"} <= set(run.forbidden_modules())
