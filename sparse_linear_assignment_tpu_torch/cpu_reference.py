"""ctypes bindings to the native C++ sequential auction engine.

``native/engine.cpp`` is a byte-identical copy of the JAX package's
engine; the port keeps its own copy and never reads the other one.  The
shared library is compiled on demand with ``g++`` into the port's
``_build/`` directory (never next to the source), keyed on a hash of the
source and the flags.  The port's routes reach it only through
``batch._cpu_tail_forward``, which finishes straggler instances of the
dense FR path on the host.  :func:`fr_dense_finish_cpu` is a standalone
oracle that only the tests use.

The engine's Khosla and forward solvers on ``AuctionSolver`` instances
(``khosla_solve_cpu``, ``forward_solve_cpu`` in the JAX package) wait
for the port of ``solver.py`` (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "native" / "engine.cpp"
BUILD_DIR = _PKG / "_build"

GXX_FLAGS = (
    "-O3", "-march=native", "-fopenmp-simd", "-shared", "-fPIC",
    "-std=c++17",
)

_lib = None
_lib_lock = threading.Lock()


def _so_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libslapengine.{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    # compile to a private temp path, then atomically rename into place:
    # another process loading the same library must never dlopen a
    # half-written file
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, target)
    finally:
        if tmp.exists():  # failed build: leave nothing behind
            tmp.unlink()


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native engine.

    The build is keyed on a content hash of ``engine.cpp`` and the flags
    (mtimes do not survive git clones), and the binary is never
    committed: it is built with ``-march=native`` for the current host.
    A load failure triggers one rebuild.  Thread-safe: concurrent first
    calls serialize on a lock instead of racing two ``g++`` builds."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is None:
            _lib = _load_and_bind()
    return _lib


def _load_and_bind() -> ctypes.CDLL:
    target = _so_path()
    if not target.exists():
        _build(target)
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        _build(target)
        lib = ctypes.CDLL(str(target))

    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.slap_fr_dense_finish.restype = ctypes.c_int
    lib.slap_fr_dense_finish.argtypes = [
        i64, i64, p_f64, ctypes.c_double, p_f32, ctypes.c_double,
        p_f64, p_f64, p_i32, p_i32, i64, ctypes.POINTER(i64),
    ]
    lib.slap_negate_transpose_f32.restype = None
    lib.slap_negate_transpose_f32.argtypes = [
        p_f64, i64, i64, ctypes.c_double, p_f32,
    ]
    lib.slap_forward_solve.restype = ctypes.c_int
    lib.slap_forward_solve.argtypes = [
        i64, i64, p_i64, p_i32, p_f64,
        ctypes.c_double, ctypes.c_double, i64,
        p_i32, p_i32, p_f64,
        ctypes.POINTER(i64), ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def fr_dense_finish_cpu(
    a: np.ndarray,
    at: Optional[np.ndarray],
    eps: float,
    prices: np.ndarray,
    profits: np.ndarray,
    p2o: np.ndarray,
    o2p: np.ndarray,
    max_pops: int = 200_000_000,
    sign: float = 1.0,
) -> tuple[int, int]:
    """Finish one dense instance's forward-reverse auction sequentially
    from a warm state (in place), with the rules of the device rounds
    (``ops/fr_dense.py``); see ``native/engine.cpp:slap_fr_dense_finish``.

    ``a [N, M]`` f64 raw values with ``sign`` (±1) applied inside the
    scans (max-profit convention; ``sign=-1`` for minimize, so no
    negated copy of a large matrix is made), ``at [M, N]`` the
    already-sign-applied f32 transpose for column scans (None: built by
    the native blocked transpose), ``prices``/``profits`` f64 and
    ``p2o``/``o2p`` int32 (-1 = unassigned), all modified in place.
    Returns ``(rc, pops)``: rc 0 = complete matching, 1 = ``max_pops``
    reached."""
    lib = get_lib()
    n, m = a.shape
    a = np.ascontiguousarray(a, dtype=np.float64)
    if at is None:
        at = np.empty((m, n), np.float32)
        lib.slap_negate_transpose_f32(a, n, m, float(sign), at)
    else:
        at = np.ascontiguousarray(at, dtype=np.float32)
    if at.shape != (m, n):
        raise ValueError(f"at must be [{m}, {n}], got {list(at.shape)}")
    pops = ctypes.c_int64(0)
    rc = lib.slap_fr_dense_finish(
        n, m, a, float(sign), at,
        float(eps), prices, profits, p2o, o2p,
        int(max_pops), ctypes.byref(pops),
    )
    return int(rc), int(pops.value)
