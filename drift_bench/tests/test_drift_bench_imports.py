"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the program (top-level module names compared
whole)."""

import ast
import os

from drift_bench.tests.tiny import ROOT

PKG = os.path.join(ROOT, "drift_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "opendrift_tpu"}


def imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    found = {(p, m) for p in sources(PKG) for m in imported_roots(p)
             if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PKG, "reference")
    found = {(p, m) for p in sources(ref) for m in imported_roots(p)
             if m.startswith("opendrift")}
    assert not found


def test_the_check_is_by_whole_names():
    assert "opendrift_tpu_torch".split(".")[0] not in FORBIDDEN
    import sys
    from drift_bench import run
    sys.modules["opendrift_tpu.fake"] = object()
    try:
        assert run.forbidden_modules() == ["opendrift_tpu"]
    finally:
        del sys.modules["opendrift_tpu.fake"]
