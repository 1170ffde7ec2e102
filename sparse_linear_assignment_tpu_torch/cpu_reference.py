"""ctypes bindings to the native C++ sequential auction engine.

``native/engine.cpp`` is a byte-identical copy of the JAX package's
engine; the port keeps its own copy and never reads the other one.  The
shared library is compiled on demand with ``g++`` into the port's
``_build/`` directory (never next to the source), keyed on a hash of the
source and the flags.  A failed build raises ``RuntimeError`` with the
compiler's message: no route switches engines because the native one is
missing.

The wrappers repeat the reference solver lifecycle (sign flip, eps
defaults, sentinel conversion): ``khosla_solve_cpu`` and
``forward_solve_cpu`` solve an ``AuctionSolver``'s instance, the
native routes of ``KhoslaSolver`` and ``ForwardAuctionSolver``;
``khosla_finish_cpu`` finishes a phase from a warm state, the chain
tail of ``hybrid.khosla_solve_hybrid``.  ``batch._cpu_tail_forward``
finishes straggler instances of the dense FR path on the host;
:func:`fr_dense_finish_cpu` is a standalone oracle that only the tests
use.
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

from .solution import INDEX_DTYPE, UNASSIGNED, AuctionSolution

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
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    except FileNotFoundError as e:
        raise RuntimeError(
            f"the native engine cannot build: g++ not found ({e})"
        ) from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"the native engine's g++ build failed:\n{e.stderr}"
        ) from e
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

    lib.slap_khosla_solve.restype = ctypes.c_int
    lib.slap_khosla_solve.argtypes = [
        i64, i64, p_i64, p_i32, p_f64, ctypes.c_double,
        p_i32, p_i32, p_f64, ctypes.POINTER(i64),
    ]
    p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.slap_khosla_finish.restype = ctypes.c_int
    lib.slap_khosla_finish.argtypes = [
        i64, i64, p_i64, p_i32, p_f64, ctypes.c_double, ctypes.c_double,
        p_i32, p_i32, p_f64, p_u8, ctypes.POINTER(i64),
    ]
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


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"native {what} returned {rc}")


def _prep(solver, maximize: bool):
    """Validate, apply ``init_solve``'s sign handling and return
    ``(solution, starts, cols, vals)``: the CSR as the engine takes it."""
    solver.validate_input()
    solution = AuctionSolution.new()
    solver.init_solve(solution, maximize)
    counts = solver.j_counts.astype(np.int64)
    starts = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    cols = np.ascontiguousarray(solver.column_indices, dtype=np.int32)
    vals = np.ascontiguousarray(solver.values, dtype=np.float64)
    return solution, starts, cols, vals


def _finish(solver, solution, p2o, o2p, prices):
    """The engine's -1 sentinels to ``UNASSIGNED``; results into the
    solution and ``solver.prices``."""
    p2o = np.where(p2o < 0, UNASSIGNED, p2o).astype(INDEX_DTYPE)
    o2p = np.where(o2p < 0, UNASSIGNED, o2p).astype(INDEX_DTYPE)
    solution.person_to_object = p2o
    solution.object_to_person = o2p
    solution.num_unassigned = int((p2o == UNASSIGNED).sum())
    solver.prices = prices
    return solution


def khosla_solve_cpu(
    solver, maximize: bool = False, eps: Optional[float] = None
):
    """Sequential Khosla solve of ``solver``'s instance on the host
    (``eps`` defaults to ``1 / num_cols``).  Returns ``(solution,
    nits)``, ``nits`` counting stack pops as the reference does."""
    lib = get_lib()
    solution, starts, cols, vals = _prep(solver, maximize)
    n, m = solver.num_rows, solver.num_cols
    eps_val = float(eps) if eps is not None else 1.0 / float(m)
    solution.eps = eps_val

    p2o = np.empty(n, dtype=np.int32)
    o2p = np.empty(m, dtype=np.int32)
    prices = np.empty(m, dtype=np.float64)
    nits = ctypes.c_int64(0)
    _check(lib.slap_khosla_solve(
        n, m, starts, cols, vals, eps_val, p2o, o2p, prices,
        ctypes.byref(nits),
    ), "khosla_solve")
    return _finish(solver, solution, p2o, o2p, prices), int(nits.value)


def khosla_finish_cpu(
    n_rows: int,
    n_cols: int,
    starts: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    eps: float,
    threshold: float,
    p2o: np.ndarray,
    o2p: np.ndarray,
    prices: np.ndarray,
    dropped: np.ndarray,
) -> int:
    """Finish an auction phase sequentially from a warm state, in place:
    ``p2o``/``o2p`` int32 with -1 for unassigned, ``prices`` float64,
    ``dropped`` uint8.  The chain tail of the hybrid solve: the device
    runs the parallel bulk rounds, this finishes the sequential
    displacement chains.  Returns the number of pops."""
    lib = get_lib()
    nits = ctypes.c_int64(0)
    _check(lib.slap_khosla_finish(
        n_rows, n_cols,
        np.ascontiguousarray(starts, dtype=np.int64),
        np.ascontiguousarray(cols, dtype=np.int32),
        np.ascontiguousarray(vals, dtype=np.float64),
        float(eps), float(threshold),
        p2o, o2p, prices, dropped, ctypes.byref(nits),
    ), "khosla_finish")
    return int(nits.value)


def forward_solve_cpu(
    solver,
    maximize: bool = False,
    eps: Optional[float] = None,
    start_eps: Optional[float] = None,
    max_iterations: int = 100_000,
):
    """Sequential eps-scaling forward solve on the host (``eps``
    defaults to ``1 / num_rows``).  Returns ``(solution, nits,
    nreductions, optimal_found)``."""
    lib = get_lib()
    solution, starts, cols, vals = _prep(solver, maximize)
    n, m = solver.num_rows, solver.num_cols
    target_eps = float(eps) if eps is not None else 1.0 / float(n)

    p2o = np.empty(n, dtype=np.int32)
    o2p = np.empty(m, dtype=np.int32)
    prices = np.empty(m, dtype=np.float64)
    nits = ctypes.c_int64(0)
    nreductions = ctypes.c_int64(0)
    optimal = ctypes.c_int32(0)
    final_eps = ctypes.c_double(0.0)
    _check(lib.slap_forward_solve(
        n, m, starts, cols, vals,
        target_eps,
        -1.0 if start_eps is None else float(start_eps),
        int(max_iterations),
        p2o, o2p, prices,
        ctypes.byref(nits), ctypes.byref(nreductions),
        ctypes.byref(optimal), ctypes.byref(final_eps),
    ), "forward_solve")
    solution.eps = float(final_eps.value)
    return (
        _finish(solver, solution, p2o, o2p, prices),
        int(nits.value),
        int(nreductions.value),
        bool(optimal.value),
    )
