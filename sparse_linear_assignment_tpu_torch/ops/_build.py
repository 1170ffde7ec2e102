"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled at first use by ``nvcc`` into
``_build/lib<name>.<hash>.so`` (a plain C interface, loaded with
``ctypes``), keyed on a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads at once.  The build goes to a
private temporary name and is renamed into place, so a concurrent
process never loads a half-written library.  A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: compiler output (``-Xptxas -v``: registers, shared memory, spills)
#: of each kernel built by this process, by name
BUILD_LOG: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def sources() -> list:
    """The kernel names, one per ``csrc/*.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from csrc/ at first use"
    )


def _so_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}.{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; returns (process, tmp, target), or
    None when the library is already built."""
    target = _so_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, target


def _finish(name: str, job) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    BUILD_LOG[name] = out
    try:
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build csrc/{name}.cu "
                f"(exit {proc.returncode}):\n{out}"
            )
        os.replace(tmp, target)
    finally:
        if tmp.exists():
            tmp.unlink()


def ptxas_table(log: str) -> dict:
    """Each kernel's registers, stack frame and spill bytes from one
    build's ``-Xptxas -v`` output (a ``BUILD_LOG`` entry), keyed by the
    kernel's mangled name: ``{"registers", "stack", "spill_stores",
    "spill_loads"}``."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            name = m.group(1)
            table.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            table[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            table[name]["registers"] = int(m.group(1))
    return {k: v for k, v in table.items() if "registers" in v}


def build_all() -> None:
    """Build every kernel that is not built yet, one ``nvcc`` per source,
    all started together."""
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        errors = []
        for name, job in jobs.items():
            if job is None:
                continue
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = ctypes.CDLL(str(_so_path(name)))
            _libs[name] = lib
        return lib
