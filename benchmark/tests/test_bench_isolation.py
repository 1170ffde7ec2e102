"""Nothing the benchmark runs loads JAX or the JAX package, the plain
reference takes nothing of the program, and a run without its cards or
without the program prints no result."""

import ast
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import core, guard, plugins

HARNESS = sorted(p for p in plugins.ROOT.rglob("*.py")
                 if "tests" not in p.parts and ".cache" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_guard_compares_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              "sparse_linear_assignment_tpu",
              "sparse_linear_assignment_tpu.batch",
              "sparse_linear_assignment_tpu_torch",
              "sparse_linear_assignment_tpu_torch.batch", "jaxtyping",
              "numpy"]
    assert guard.forbidden_modules(loaded) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
        "sparse_linear_assignment_tpu", "sparse_linear_assignment_tpu.batch"]


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: p.name)
def test_no_harness_file_imports_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & guard.FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((plugins.ROOT / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert tops <= {"__future__", "torch", "numpy", "math"}


def test_a_run_with_jax_loaded_fails(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    with pytest.raises(core.RunFailed, match="jax"):
        core.run("dense-int1000.b4096-n256", 1, 0.2, False, "cpu",
                 overrides=dict(batch=2, rows=32, cols=32, pool=2,
                                warm_calls=1,
                                entry_args={"eps_denominator": 33}))


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dense-int1000.b4096-n256", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_run_without_a_card_prints_no_result():
    p = _run_py(plugins.ROOT.parent)
    assert p.returncode != 0 and p.stdout == ""


def test_run_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(plugins.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(plugins.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""
    assert "program" in p.stderr
