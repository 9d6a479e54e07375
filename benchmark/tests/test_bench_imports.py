"""Nothing a run reaches loads JAX or the JAX package, and the reference
takes nothing from the program."""
import ast
import glob
import os

from conftest import BENCH, drive

FORBIDDEN = {"jax", "jaxlib", "flax", "miso_tpu"}


def imported_tops(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.level == 0):
            names.add(node.module.split(".")[0])
    return names


def test_a_run_loads_no_jax_and_no_jax_package(bench_copy):
    out = drive(bench_copy, "se_tiny.tiny")
    assert out["forbidden"] == []


def test_the_harness_imports_no_jax_by_name():
    files = [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                  recursive=True)
             if os.sep + "tests" + os.sep not in p]
    for p in files:
        assert not (imported_tops(p) & FORBIDDEN), p


def test_the_reference_imports_nothing_of_the_program():
    for p in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert not (imported_tops(p) & (FORBIDDEN | {"miso_tpu_torch"})), p
