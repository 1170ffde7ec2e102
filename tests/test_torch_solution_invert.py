"""The device inversion (``solution.o2p_from_p2o_device``) against the
JAX package's NumPy one (``sparse_linear_assignment_tpu.solution.
o2p_from_p2o``), and the one finish every batch entry point takes
(``batch._batch_solution``).

- bit for bit on the CPU: square and wide matchings, an all-unassigned
  row beside a full one, one instance, and persons naming one object
  (the highest person index wins, as NumPy's last write does);
- every route of ``solve_batch`` and every other single-process batch
  entry point inverts once a batch, on whichever device holds the final
  matching (the CPU after the plain route or a native tail), and returns
  the maps and the unassigned counts as int32, C-contiguous views of one
  host block (``parallel/dryrun.one_block``), each map the other's
  inverse; the sharded entry points: ``test_torch_sharded_batch.py``.
"""

import numpy as np
import pytest
import torch
from sparse_linear_assignment_tpu.solution import o2p_from_p2o

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch import batch, solution
from sparse_linear_assignment_tpu_torch.parallel import dryrun
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
    np.testing.assert_array_equal(o2p.numpy(), o2p_from_p2o(p2o, m))
    np.testing.assert_array_equal(free.numpy(), (p2o == U).sum(axis=1))


def test_duplicate_object_goes_to_the_highest_person():
    p2o, m = MATCHINGS["duplicate"]()
    o2p, free = solution.o2p_from_p2o_device(torch.from_numpy(p2o), m)
    assert o2p.tolist() == [[3, U, 4, U, U, U], [1, 2, U, U, 4, U]]
    assert free.tolist() == [1, 1]


def _ints(seed, b, n, m=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 100, size=(b, n, m or n)).astype(dtype)


#: route -> (keyword arguments of ``solve_batch``, whether it needs the
#: big-single route's size floor lowered)
ROUTES = {
    "fused-device": (lambda: dict(
        costs=None, costs_device=torch.from_numpy(_ints(11, 2, 128)),
        integer=True, max_cost=100), False),
    "fused-host": (lambda: dict(costs=_ints(12, 2, 128)), False),
    "big-device": (lambda: dict(
        costs=None, costs_device=torch.from_numpy(_ints(13, 1, 128)),
        eps=1.0 / 129), True),
    "big-host": (lambda: dict(costs=_ints(14, 1, 128), integer=False),
                 True),
    "forward": (lambda: dict(costs=_ints(15, 3, 12), solver="forward"),
                False),
    "khosla": (lambda: dict(costs=_ints(16, 3, 12), solver="khosla"),
               False),
    "rect": (lambda: dict(costs=_ints(17, 3, 8, 12)), False),
    "plain": (lambda: dict(costs=_ints(18, 3, 12, dtype=np.float64),
                           dtype=np.float64), False),
}


def _finished(monkeypatch, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its solutions as a list, and the device
    type of each matching the finish inverted."""
    inverted = []
    real = batch.o2p_from_p2o_device

    def counted(p2o, m):
        inverted.append(p2o.device.type)
        return real(p2o, m)

    monkeypatch.setattr(batch, "o2p_from_p2o_device", counted)
    out = fn(*args, **kwargs)
    return (out if isinstance(out, list) else [out]), inverted


def _assert_one_block(sol, m):
    p2o, o2p = sol.person_to_object, sol.object_to_person
    assert dryrun.one_block(sol)
    assert o2p.shape == (p2o.shape[0], m)
    np.testing.assert_array_equal(o2p, o2p_from_p2o(p2o, m))
    np.testing.assert_array_equal(sol.num_unassigned,
                                  (p2o == U).sum(axis=1))


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_solve_batch_inverts_where_the_final_matching_lies(name,
                                                           monkeypatch):
    kwargs, big = ROUTES[name]
    if big:
        monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 0)
    kw = kwargs()
    (sol,), inverted = _finished(monkeypatch, port.solve_batch,
                                 device="cpu", **kw)
    assert inverted == ["cpu"]
    costs = kw["costs"] if kw["costs"] is not None else kw["costs_device"]
    _assert_one_block(sol, costs.shape[2])
    assert int(sol.num_unassigned.sum()) == 0


def test_native_tail_keeps_the_host_inversion(monkeypatch):
    """A 10-round first chunk leaves every instance of host costs undone,
    so the native engine finishes them and rewrites ``p2o`` on the host:
    the same finish inverts that host matching on the CPU."""
    monkeypatch.setattr(batch, "_fr_fused_schedule", lambda b, n, m: 10)
    (sol,), inverted = _finished(monkeypatch, port.solve_batch,
                                 _ints(29, 3, 128), device="cpu")
    assert batch.LAST_TAIL_COUNT == 3
    assert inverted == ["cpu"]
    _assert_one_block(sol, 128)
    assert int(sol.num_unassigned.sum()) == 0


def _arcs(seed, b, n, m, k, lo=1, hi=40):
    rng = np.random.default_rng(seed)
    cols = np.stack([np.stack([rng.choice(m, size=k, replace=False)
                               for _ in range(n)]) for _ in range(b)])
    return cols.astype(np.int32), rng.integers(lo, hi, size=(b, n, k))


def _sparse(engine):
    cols, vals = _arcs(41, 3, 8, 128, 4)
    return port.solve_batch_sparse(cols, vals, 128, engine=engine,
                                   device="cpu")


def _sparse_stream(stage, **kwargs):
    """Two staged batches of one shape through the stream, window 2."""
    staged = [stage(*_arcs(42 + i, 2, 8, 128, 4), 128, device="cpu",
                    **kwargs) for i in range(2)]
    return port.solve_batch_sparse_stream(staged, window=2)


#: entry point -> (a call of it on the CPU, the number of objects)
ENTRIES = {
    "stream-fused": (lambda: port.solve_batch_stream(
        [torch.from_numpy(_ints(31 + i, 2, 128)) for i in range(2)],
        integer=True, max_cost=100), 128),
    "sparse-dense": (lambda: _sparse("dense"), 128),
    "sparse-padded": (lambda: _sparse("padded"), 128),
    # values near 1,000 with eps = 1/60,000: float32 cannot keep eps in
    # a profit, so the arcs run in float64
    "sparse-auto-arcs": (lambda: port.solve_batch_sparse(
        *_arcs(43, 2, 8, 128, 4, lo=300, hi=1000), 128, eps=1 / 60_000,
        device="cpu"), 128),
    "stream-host-plane": (lambda: _sparse_stream(port.stage_batch_sparse),
                          128),
    "stream-device-plane": (lambda: _sparse_stream(
        port.stage_batch_sparse_device), 128),
    "stream-device-compacted": (lambda: _sparse_stream(
        port.stage_batch_sparse_device, compact=True), 128),
}


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_every_batch_entry_point_finishes_in_one_block(name, monkeypatch):
    """One inversion a batch, and each result's maps and counts views of
    one block: the finish ``solve_batch`` takes, on every entry point."""
    call, m = ENTRIES[name]
    before = dict(batch.SPARSE_ROUTES)
    sols, inverted = _finished(monkeypatch, call)
    if name == "sparse-auto-arcs":
        assert batch.SPARSE_ROUTES["arcs"] == before["arcs"] + 1
    assert inverted == ["cpu"] * len(sols)
    for sol in sols:
        _assert_one_block(sol, m)
        assert int(sol.num_unassigned.sum()) == 0
