"""The device inversion (``solution.o2p_from_p2o_device``) against the
NumPy one (``solution.o2p_from_p2o``), and which of the two the finish
of ``solve_batch`` takes.

- bit for bit on the CPU: square and wide matchings, an all-unassigned
  row beside a full one, one instance, and persons naming one object
  (the highest person index wins, as NumPy's last write does);
- ``solve_batch`` builds the maps on the device wherever the device
  holds the final matching (``INVERSIONS["device"]``), and on the host
  after the plain route or a native tail (``INVERSIONS["host"]``); either
  way the returned maps are C-contiguous int32 arrays, each the other's
  inverse, with the right unassigned counts.
"""

import numpy as np
import pytest
import torch

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch import batch, solution
from sparse_linear_assignment_tpu_torch.solution import UNASSIGNED as U

# the tensors here are small and the suite runs several test workers
# at once: one intra-op thread per worker avoids oversubscribing the
# host's cores
torch.set_num_threads(1)


def _matching(seed, b, n, m, free=0.25):
    """``b`` random injective person→object rows, about ``free`` of the
    persons unassigned; and ``m``."""
    rng = np.random.default_rng(seed)
    p2o = np.stack([rng.permutation(m)[:n] for _ in range(b)]).astype(
        np.int32)
    p2o[rng.random((b, n)) < free] = U
    return p2o, m


#: case -> (``[B, N]`` int32 person→object, number of objects)
MATCHINGS = {
    "square": lambda: _matching(1, 5, 16, 16),
    "wide": lambda: _matching(2, 4, 12, 20),
    "empty-and-full": lambda: (np.stack([
        np.full(8, U, np.int32),
        np.random.default_rng(3).permutation(8).astype(np.int32),
    ]), 8),
    "duplicate": lambda: (np.array([[2, 2, U, 0, 2], [1, 0, 1, U, 4]],
                                   np.int32), 6),
    "single": lambda: _matching(4, 1, 32, 48),
}


@pytest.mark.parametrize("name", sorted(MATCHINGS))
def test_device_inversion_equals_numpy(name):
    p2o, m = MATCHINGS[name]()
    given = p2o.copy()
    o2p, free = solution.o2p_from_p2o_device(torch.from_numpy(p2o), m)
    np.testing.assert_array_equal(p2o, given)  # the input is left alone
    assert o2p.dtype == free.dtype == torch.int32
    assert tuple(o2p.shape) == (p2o.shape[0], m)
    assert tuple(free.shape) == (p2o.shape[0],)
    assert o2p.is_contiguous()
    np.testing.assert_array_equal(o2p.numpy(), solution.o2p_from_p2o(p2o, m))
    np.testing.assert_array_equal(free.numpy(), (p2o == U).sum(axis=1))


def test_duplicate_object_goes_to_the_highest_person():
    p2o, m = MATCHINGS["duplicate"]()
    o2p, free = solution.o2p_from_p2o_device(torch.from_numpy(p2o), m)
    assert o2p.tolist() == [[3, U, 4, U, U, U], [1, 2, U, U, 4, U]]
    assert free.tolist() == [1, 1]


def test_device_inversion_counts_its_calls():
    p2o, m = MATCHINGS["square"]()
    before = dict(solution.INVERSIONS)
    solution.o2p_from_p2o_device(torch.from_numpy(p2o), m)
    solution.o2p_from_p2o(p2o, m)
    solution.o2p_from_p2o(p2o[0], m)
    assert solution.INVERSIONS == {"device": before["device"] + 1,
                                   "host": before["host"] + 2}


def _ints(seed, b, n, m=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 100, size=(b, n, m or n)).astype(dtype)


#: route -> (keyword arguments of ``solve_batch``, whether it needs the
#: big-single route's size floor lowered, the inversion it takes)
ROUTES = {
    "fused-device": (lambda: dict(
        costs=None, costs_device=torch.from_numpy(_ints(11, 2, 128)),
        integer=True, max_cost=100), False, "device"),
    "fused-host": (lambda: dict(costs=_ints(12, 2, 128)), False, "device"),
    "big-device": (lambda: dict(
        costs=None, costs_device=torch.from_numpy(_ints(13, 1, 128)),
        eps=1.0 / 129), True, "device"),
    "big-host": (lambda: dict(costs=_ints(14, 1, 128), integer=False),
                 True, "device"),
    "forward": (lambda: dict(costs=_ints(15, 3, 12), solver="forward"),
                False, "device"),
    "khosla": (lambda: dict(costs=_ints(16, 3, 12), solver="khosla"),
               False, "device"),
    "rect": (lambda: dict(costs=_ints(17, 3, 8, 12)), False, "device"),
    "plain": (lambda: dict(costs=_ints(18, 3, 12, dtype=np.float64),
                           dtype=np.float64), False, "host"),
}


def _solve_counting(**kwargs):
    """``solve_batch`` on the CPU and how many times it took each
    inversion."""
    before = dict(solution.INVERSIONS)
    sol = port.solve_batch(device="cpu", **kwargs)
    return sol, {k: solution.INVERSIONS[k] - before[k] for k in before}


def _assert_maps(sol, m):
    p2o, o2p = sol.person_to_object, sol.object_to_person
    for arr in (p2o, o2p, sol.num_unassigned):
        assert arr.dtype == np.int32
        assert arr.flags.c_contiguous
    assert o2p.shape == (p2o.shape[0], m)
    np.testing.assert_array_equal(o2p, solution.o2p_from_p2o(p2o, m))
    np.testing.assert_array_equal(sol.num_unassigned,
                                  (p2o == U).sum(axis=1))


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_solve_batch_inverts_where_the_final_matching_lies(name,
                                                           monkeypatch):
    kwargs, big, want = ROUTES[name]
    if big:
        monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 0)
    kw = kwargs()
    sol, steps = _solve_counting(**kw)
    assert steps == {"device": int(want == "device"),
                     "host": int(want == "host")}
    costs = kw["costs"] if kw["costs"] is not None else kw["costs_device"]
    _assert_maps(sol, costs.shape[2])
    assert int(sol.num_unassigned.sum()) == 0


def test_native_tail_keeps_the_host_inversion(monkeypatch):
    """A 10-round first chunk leaves every instance of host costs undone,
    so the native engine finishes them and rewrites ``p2o`` on the host:
    the finish inverts it there."""
    monkeypatch.setattr(batch, "_fr_fused_schedule", lambda b, n, m: 10)
    sol, steps = _solve_counting(costs=_ints(29, 3, 128))
    assert batch.LAST_TAIL_COUNT == 3
    assert steps == {"device": 0, "host": 1}
    _assert_maps(sol, 128)
    assert int(sol.num_unassigned.sum()) == 0
