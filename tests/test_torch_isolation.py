"""The port stands alone: it imports neither JAX nor the JAX package.

Importing any submodule of ``sparse_linear_assignment_tpu`` runs that
package's ``__init__``, which imports jax and changes global JAX
configuration; the port must never trigger it.
"""

import ast
import subprocess
import sys
from pathlib import Path

import sparse_linear_assignment_tpu_torch as port

PKG = Path(port.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "sparse_linear_assignment_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import sparse_linear_assignment_tpu_torch as p\n"
        "import sparse_linear_assignment_tpu_torch.ops.fr_kernel\n"
        "import sparse_linear_assignment_tpu_torch.ops.fr_big\n"
        "import sparse_linear_assignment_tpu_torch.ops.dense\n"
        "import sparse_linear_assignment_tpu_torch.ops.auction\n"
        "import sparse_linear_assignment_tpu_torch.ops.ksparse_kernel\n"
        "import sparse_linear_assignment_tpu_torch.ops.round_log\n"
        "import sparse_linear_assignment_tpu_torch.ops.dense_round\n"
        "import sparse_linear_assignment_tpu_torch.ops.dense_round_single\n"
        "import sparse_linear_assignment_tpu_torch.generators\n"
        "import sparse_linear_assignment_tpu_torch.cpu_reference\n"
        "import sparse_linear_assignment_tpu_torch.utils.trace\n"
        "import sparse_linear_assignment_tpu_torch.utils.compaction\n"
        "import sparse_linear_assignment_tpu_torch.solver\n"
        "import sparse_linear_assignment_tpu_torch.ksparse\n"
        "import sparse_linear_assignment_tpu_torch.symmetric\n"
        "import sparse_linear_assignment_tpu_torch.hybrid\n"
        "import sparse_linear_assignment_tpu_torch.ops.padded\n"
        "import sparse_linear_assignment_tpu_torch.ops.compact\n"
        "import sparse_linear_assignment_tpu_torch.ops.prefix\n"
        "import sparse_linear_assignment_tpu_torch.parallel\n"
        "import sparse_linear_assignment_tpu_torch.parallel.sharded\n"
        "import sparse_linear_assignment_tpu_torch.parallel.collectives\n"
        "import sparse_linear_assignment_tpu_torch.parallel.dryrun\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib') or "
        "m.startswith(('jax.', 'jaxlib.')) or m == "
        "'sparse_linear_assignment_tpu' or m.startswith("
        "'sparse_linear_assignment_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=PKG.parent, timeout=120, check=True,
    )
    assert out.stdout.strip() == "", out.stdout


def test_sources_import_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 8
    names = {p.relative_to(PKG).as_posix() for p in files}
    assert {"solver.py", "ksparse.py", "symmetric.py", "hybrid.py",
            "ops/padded.py", "ops/compact.py", "ops/prefix.py",
            "utils/compaction.py", "ops/round_log.py",
            "ops/dense_round_single.py", "parallel/__init__.py",
            "parallel/sharded.py", "parallel/collectives.py",
            "parallel/dryrun.py"} <= names
    offenders = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    smoke = PKG.parent / "chip_smoke.py"
    tree = ast.parse(smoke.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert not [n for n in names if _forbidden(n)]
    assert any(n.startswith("sparse_linear_assignment_tpu_torch")
               for n in names)


def test_kernel_sources_stand_alone():
    """Every ``csrc/*.cu`` (``dense_round_single.cu`` among them) is a
    source the build picks up, and includes only the CUDA toolkit's
    headers, the C library's and the package's own ``csrc/`` headers."""
    from sparse_linear_assignment_tpu_torch.ops import _build

    csrc = PKG / "csrc"
    sources = sorted(p.stem for p in csrc.glob("*.cu"))
    assert "dense_round_single" in sources
    assert _build.sources() == sources
    toolkit = {"cuda_runtime.h", "cooperative_groups.h", "stdint.h",
               "string.h"}
    for cu in sorted(csrc.glob("*.cu")):
        for line in cu.read_text().splitlines():
            if not line.startswith("#include"):
                continue
            name = line.split()[1]
            if name.startswith('"'):
                assert (csrc / name.strip('"')).is_file(), (cu.name, name)
            else:
                assert name.strip("<>") in toolkit, (cu.name, name)
