"""The port's dense engines off the FR kernels (``batch.py``: the forward
and Khosla engines, the kernel-route forward chunk, the plain-rounds FR
route, rectangular ``linear_sum_assignment``, ``BatchedLAP``) against
the JAX package and scipy.

Inputs come from NumPy seeds and go through both packages.  Matchings,
``nits``, ``num_unassigned`` and ``eps`` must be equal (tolerance 0); the
objective is evaluated on the host from the same costs in both packages
and must be equal too, except in the device-resident mode (1e-9: two
float64 summation orders).  The JAX side runs its XLA rounds on the CPU,
and its Pallas forward chunk in interpret mode where a test says so; the
port runs with ``device="cpu"``, i.e. the kernels' plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu import batch as jbatch
from sparse_linear_assignment_tpu.ops.auction import ForwardState as JState
from sparse_linear_assignment_tpu_torch import batch
from sparse_linear_assignment_tpu_torch.ops import dense_round as dr
from sparse_linear_assignment_tpu_torch.ops.auction import (
    forward_init,
    forward_state_to_numpy,
)

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1


def oracle(costs, maximize=False):
    out = []
    for mat in costs:
        r, c = scipy_lsa(mat, maximize=maximize)
        out.append(mat[r, c].sum())
    return np.array(out)


def assert_same(got, want, objective_atol=0.0):
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.object_to_person,
                                  want.object_to_person)
    np.testing.assert_array_equal(got.nits, want.nits)
    np.testing.assert_array_equal(got.num_unassigned, want.num_unassigned)
    np.testing.assert_array_equal(got.eps, want.eps)
    assert got.eps.dtype == np.float64 and got.nits.dtype == np.int32
    np.testing.assert_allclose(got.objective, want.objective, rtol=0,
                               atol=objective_atol)


def assert_inverse_consistent(sol):
    for bi, p2o in enumerate(sol.person_to_object):
        for i, j in enumerate(p2o):
            if j != UNASSIGNED:
                assert sol.object_to_person[bi, j] == i


# ----------------------------------------------------------------------
# solve_batch: every dense request the JAX package serves off its FR
# kernels, equal to JAX
# ----------------------------------------------------------------------
CASES = {
    "forward-f64-16": dict(shape=(4, 16, 16), solver="forward",
                           dtype=np.float64),
    "forward-f32-32": dict(shape=(3, 32, 32), solver="forward",
                           dtype=np.float32),
    "forward-f32-128-max": dict(shape=(2, 128, 128), solver="forward",
                                dtype=np.float32, maximize=True),
    "khosla-f64-16": dict(shape=(4, 16, 16), solver="khosla",
                          dtype=np.float64),
    "khosla-f32-32-max": dict(shape=(3, 32, 32), solver="khosla",
                              dtype=np.float32, maximize=True),
    "khosla-rect-f32": dict(shape=(3, 8, 20), solver="khosla",
                            dtype=np.float32),
    "auto-rect-f64": dict(shape=(5, 8, 20), solver="auto",
                          dtype=np.float64, uniform=True),
    "fr-rect-f32-128x256": dict(shape=(2, 128, 256), solver="fr",
                                dtype=np.float32),
    "forward-rect-eps": dict(shape=(3, 8, 16), solver="forward",
                             dtype=np.float32, eps=0.01, uniform=True),
    "fr-f64-128": dict(shape=(3, 128, 128), solver="fr", dtype=np.float64,
                       uniform=True),
    "fr-f32-off-tile-24": dict(shape=(4, 24, 24), solver="fr",
                               dtype=np.float32),
    "fr-f64-off-tile-40-max": dict(shape=(4, 40, 40), solver="auto",
                                   dtype=np.float64, maximize=True),
    "forward-start-eps-c-half": dict(shape=(3, 16, 16), solver="forward",
                                     dtype=np.float64,
                                     start_eps_divisor=2.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_batch_matches_jax(case):
    kw = dict(CASES[case])
    b, n, m = kw.pop("shape")
    rng = np.random.default_rng(sorted(CASES).index(case))
    if kw.pop("uniform", False):
        costs = rng.uniform(0.0, 10.0, size=(b, n, m))
    else:
        costs = rng.integers(1, 100, size=(b, n, m)).astype(np.float64)
    want = jbatch.solve_batch(costs, **kw)
    got = port.solve_batch(costs, device="cpu", **kw)
    assert_same(got, want)
    assert int(got.num_unassigned.sum()) == 0
    assert_inverse_consistent(got)
    best = oracle(costs, kw.get("maximize", False))
    gap = n * np.maximum(got.eps, 0) + 1e-3
    if kw.get("maximize", False):
        assert np.all(got.objective <= best + 1e-9)
        assert np.all(got.objective >= best - gap)
    else:
        assert np.all(got.objective >= best - 1e-9)
        assert np.all(got.objective <= best + gap)


@pytest.mark.parametrize("solver", ["forward", "khosla", "fr"])
def test_batch_integer_exact(solver):
    rng = np.random.default_rng(1)
    b, n = 6, 12
    costs = rng.integers(1, 100, size=(b, n, n)).astype(np.float64)
    sol = port.solve_batch(costs, solver=solver, dtype=np.float64,
                           eps=1.0 / (n + 1), device="cpu")
    assert np.all(sol.num_unassigned == 0)
    np.testing.assert_allclose(sol.objective, oracle(costs), atol=1e-9)


def test_forward_start_eps_below_target_skips_scaling():
    """A start eps below the target: the first complete assignment stops
    the instance, eps is never reduced."""
    rng = np.random.default_rng(4)
    costs = rng.uniform(1.0, 10.0, size=(3, 16, 16))
    kw = dict(solver="forward", dtype=np.float64, eps=0.5,
              start_eps_divisor=1e3)
    got = port.solve_batch(costs, device="cpu", **kw)
    assert_same(got, jbatch.solve_batch(costs, **kw))
    start = np.abs(costs.reshape(3, -1)).max(axis=1) / 1e3
    np.testing.assert_array_equal(got.eps, start)
    assert np.all(got.num_unassigned == 0)


def test_khosla_explicit_eps():
    rng = np.random.default_rng(4)
    n = 16
    costs = rng.uniform(1.0, 10.0, size=(2, n, n))
    sol = port.solve_batch(costs, solver="khosla", dtype=np.float64,
                           eps=0.25, device="cpu")
    assert sol.eps.tolist() == [0.25, 0.25]
    best = oracle(costs)
    assert np.all(sol.objective >= best - 1e-9)
    assert np.all(sol.objective <= best + n * 0.25 + 1e-9)


def test_auto_routes_square_to_fr_and_rectangular_to_forward(monkeypatch):
    seen = []
    real = batch._solve_batch_dense

    def spy(values_t, eps, target_eps, toleration, thresholds, solver,
            *args, **kw):
        seen.append(solver)
        return real(values_t, eps, target_eps, toleration, thresholds,
                    solver, *args, **kw)

    monkeypatch.setattr(batch, "_solve_batch_dense", spy)
    rng = np.random.default_rng(3)
    sq = rng.integers(1, 50, size=(2, 16, 16)).astype(np.float64)
    sol = port.solve_batch(sq, dtype=np.float64, device="cpu")
    assert seen == []  # the FR engine has its own loops
    np.testing.assert_allclose(sol.objective, oracle(sq), atol=1e-9)
    asym = rng.integers(1, 50, size=(2, 8, 16)).astype(np.float64)
    sol = port.solve_batch(asym, dtype=np.float64, device="cpu")
    assert seen == ["forward"]
    assert np.all(sol.num_unassigned == 0)


def test_routes_and_kernel_rule():
    assert batch._route(4, 256, 256, np.float32, None) == "fused"
    assert batch._route(4, 256, 256, np.float64, 257) == "fused"
    assert batch._route(4, 256, 256, np.float64, None) == "plain"
    assert batch._route(4, 200, 200, np.float32, None) == "plain"
    assert batch._route(1, 2048, 2048, np.float32, None) == "big"
    assert batch._route(65, 2048, 2048, np.float32, None) == "plain"
    assert batch._route(1, 2048, 2048, np.float64, None) == "plain"
    # the fused round kernel: forward, float32, state within shared memory;
    # no tiling limit and no N*M crossover
    assert batch._kernel_usable("forward", 256, 512, np.float32)
    assert batch._kernel_usable("forward", 24, 40, np.float32)
    assert batch._kernel_usable("forward", 1536, 1536, np.float32)
    assert batch._kernel_usable("forward", 128, 8192, np.float32)
    assert not batch._kernel_usable("forward", 128, 32768, np.float32)
    assert not batch._kernel_usable("forward", 256, 512, np.float64)
    assert not batch._kernel_usable("khosla", 256, 512, np.float32)


def test_device_resident_mode_needs_the_fr_engine():
    dev = torch.zeros((2, 16, 16))
    with pytest.raises(ValueError, match="requires solver='fr'"):
        port.solve_batch(None, solver="forward", costs_device=dev)
    with pytest.raises(ValueError, match="requires solver='fr'"):
        port.solve_batch(None, solver="khosla", costs_device=dev)
    with pytest.raises(ValueError, match="square"):
        port.solve_batch(None, costs_device=torch.zeros((2, 8, 16)))


# ----------------------------------------------------------------------
# the kernel-route forward chunk against the Pallas chunk in interpret
# mode
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n, m", [(128, 128), (128, 256)])
def test_kernel_route_chunk_matches_pallas_chunk(n, m):
    b, chunk = 3, 48
    rng = np.random.default_rng(n + m)
    vals_t = -rng.integers(1, 100, size=(b, m, n)).astype(np.float32)
    target = np.float32(1.0 / (n + 1))
    tol = np.float32(2.0**-47)
    start = np.full(b, 99 / 128.0 if n == m else target, np.float32)
    sfoe = n != m
    tv = torch.from_numpy(vals_t)
    ts = forward_init(tv, torch.from_numpy(start))
    js = JState(
        prices=jnp.zeros((b, m), np.float32),
        p2o=jnp.full((b, n), jnp.int32(UNASSIGNED)),
        o2p=jnp.full((b, m), jnp.int32(UNASSIGNED)),
        eps=jnp.asarray(start),
        nits=jnp.zeros((b,), jnp.int32),
        nreductions=jnp.zeros((b,), jnp.int32),
        optimal_found=jnp.zeros((b,), bool),
        done=jnp.zeros((b,), bool),
    )
    jv = jnp.asarray(vals_t)
    for step in range(2):
        js, jdone = jbatch._batch_chunk_pallas(
            jv, js, target, tol, 70, chunk, sfoe, interpret=True)
        ts, tdone = dr.fused_dense_chunk(tv.transpose(1, 2), ts, target,
                                         tol, 70, chunk, sfoe)
        got = forward_state_to_numpy(ts)
        for name in JState._fields:
            want = np.asarray(getattr(js, name))
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(got[name], want,
                                          err_msg=f"{name} chunk {step}")
        assert bool(tdone) == bool(jdone)
    assert bool(tdone)  # the 70-round cap at the latest
    if not sfoe:
        assert got["nreductions"].max() > 0, "the eps ladder never ran"


def test_forward_kernel_path_matches_jax_interpret(monkeypatch):
    """``solve_batch(solver="forward")`` in float32: the JAX package on
    its Pallas forward chunk in interpret mode, the port on the kernel
    route's plain version.  Integer costs with eps < 1/n: scipy-exact."""
    monkeypatch.setattr(jbatch, "_FORWARD_PALLAS_INTERPRET_ON_CPU", True)
    rng = np.random.default_rng(21)
    b, n = 3, 128
    costs = rng.integers(1, 100, size=(b, n, n)).astype(np.float64)
    kw = dict(solver="forward", dtype=np.float32, eps=1.0 / (n + 1))
    want = jbatch.solve_batch(costs, **kw)
    calls = []
    real = batch.fused_dense_chunk
    monkeypatch.setattr(batch, "fused_dense_chunk",
                        lambda *a: calls.append(1) or real(*a))
    got = port.solve_batch(costs, device="cpu", **kw)
    assert calls, "the kernel route was not taken"
    assert_same(got, want)
    np.testing.assert_array_equal(got.objective, oracle(costs))
    assert dr.LAUNCHES == 0  # CPU tensors run the plain version


# ----------------------------------------------------------------------
# the plain-rounds FR route: compaction, native tail, device-resident
# ----------------------------------------------------------------------
def test_plain_fr_compaction_device_resident_matches_jax(monkeypatch):
    """70 float64 instances with device-resident costs: after the first
    128-round chunk the unfinished ones are gathered into a 32-slot
    bucket and run on; the objective is evaluated on the device."""
    rng = np.random.default_rng(61)
    b, n = 70, 64
    costs = rng.integers(1, 1000, size=(b, n, n)).astype(np.float64)
    compactions = []
    real = batch._fr_compact
    monkeypatch.setattr(
        batch, "_fr_compact",
        lambda v, s, perm: compactions.append(len(perm)) or real(v, s, perm))
    got = port.solve_batch(None, costs_device=torch.from_numpy(costs),
                           dtype=np.float64)
    want = jbatch.solve_batch(None, costs_device=jnp.asarray(costs),
                              dtype=np.float64)
    assert compactions == [32], compactions
    assert_same(got, want, objective_atol=1e-9)
    np.testing.assert_allclose(got.objective, oracle(costs), atol=1e-9)
    assert got.nits.max() > 128


def test_plain_fr_native_tail_matches_jax(monkeypatch):
    """Host costs: the instances still undone after the first chunk go
    to the native engine and report the device rounds as their nits."""
    rng = np.random.default_rng(61)
    b, n = 70, 64
    costs = rng.integers(1, 1000, size=(b, n, n)).astype(np.float64)
    tails = []
    real = batch._native_tail
    monkeypatch.setattr(
        batch, "_native_tail",
        lambda c, mx, e, it, rows, p2o: tails.append(len(rows))
        or real(c, mx, e, it, rows, p2o))
    got = port.solve_batch(costs, dtype=np.float64, device="cpu")
    want = jbatch.solve_batch(costs, dtype=np.float64)
    assert tails and 0 < tails[0] < b
    assert_same(got, want)
    assert int((got.nits == 128).sum()) >= tails[0]
    np.testing.assert_allclose(got.objective, oracle(costs), atol=1e-9)


def test_stream_falls_back_to_sequential_solves_off_the_fused_route():
    rng = np.random.default_rng(56)
    c = rng.integers(1, 50, size=(2, 24, 24)).astype(np.float64)
    dev = torch.from_numpy(c.astype(np.float32))
    sols = port.solve_batch_stream([dev, dev], eps=1.0 / 25)
    assert len(sols) == 2
    want = jbatch.solve_batch_stream(
        [jnp.asarray(c.astype(np.float32))], eps=1.0 / 25)[0]
    for sol in sols:
        assert_same(sol, want, objective_atol=1e-9)
        np.testing.assert_allclose(sol.objective, oracle(c), atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        port.solve_batch_stream([torch.zeros((2, 8, 16))])


def test_stream_reports_the_callers_eps_on_the_fused_route():
    """On its fused route JAX's ``solve_batch_stream`` reports the
    caller's eps unrounded (its ``solve_batch`` reports it rounded to
    float32, a reference inconsistency); the port's stream reports the
    stream's value.  ``interpret=`` is accepted and ignored."""
    rng = np.random.default_rng(57)
    c = rng.uniform(1.0, 100.0, size=(2, 128, 128)).astype(np.float32)
    eps = 1.0 / 257
    assert float(np.float32(eps)) != eps
    kw = dict(eps=eps, integer=False, interpret=True)
    want = jbatch.solve_batch_stream([jnp.asarray(c)], **kw)[0]
    got = port.solve_batch_stream([torch.from_numpy(c)], **kw)[0]
    assert got.eps.tolist() == want.eps.tolist() == [eps, eps]
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.nits, want.nits)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
    one = port.solve_batch(None, costs_device=torch.from_numpy(c),
                           eps=eps, integer=False)
    assert one.eps.tolist() == [float(np.float32(eps))] * 2
    np.testing.assert_array_equal(one.person_to_object,
                                  got.person_to_object)


def test_beyond_the_kernel_sizes_runs_the_plain_rounds(monkeypatch):
    """Beyond the fused kernel's size, what the big-single route does
    not take (float64; more than 64 instances) runs the plain rounds.
    The limits are shrunk so that 128² counts as big."""
    monkeypatch.setattr(batch, "_FUSED_MAX_ELEMS", 64 * 64)
    monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 64 * 64)
    monkeypatch.setattr(batch, "_BIG_MAX_BATCH", 2)
    assert batch._route(1, 128, 128, np.float64, None) == "plain"
    assert batch._route(3, 128, 128, np.float32, None) == "plain"
    assert batch._route(2, 128, 128, np.float32, None) == "big"
    rng = np.random.default_rng(62)
    costs = rng.integers(1, 100, size=(3, 128, 128)).astype(np.float64)
    for dtype in (np.float64, np.float32):
        sol = port.solve_batch(costs, dtype=dtype, integer=False,
                               eps=1.0 / 129, device="cpu")
        assert np.all(sol.num_unassigned == 0)
        np.testing.assert_array_equal(sol.objective, oracle(costs))


# ----------------------------------------------------------------------
# linear_sum_assignment and BatchedLAP
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(12, 30), (30, 12), (128, 256), (1, 5),
                                   (5, 1)])
@pytest.mark.parametrize("maximize", [False, True])
def test_linear_sum_assignment_rectangular(shape, maximize):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    cost = rng.integers(1, 100, size=shape).astype(np.float64)
    rows, cols = port.linear_sum_assignment(cost, maximize=maximize,
                                            device="cpu")
    r, c = scipy_lsa(cost, maximize=maximize)
    k = min(shape)
    assert rows.dtype == np.intp and cols.dtype == np.intp
    assert len(rows) == len(cols) == k
    assert np.all(np.diff(rows) > 0) and len(set(cols.tolist())) == k
    assert cost[rows, cols].sum() == cost[r, c].sum()


def test_linear_sum_assignment_promotes_large_entries_to_float64():
    rng = np.random.default_rng(9)
    cost = rng.integers(1, 100, size=(6, 9)).astype(np.float64) + 2.0**25
    rows, cols = port.linear_sum_assignment(cost, device="cpu")
    r, c = scipy_lsa(cost)
    assert cost[rows, cols].sum() == cost[r, c].sum()


def test_batched_lap_reuse():
    lap = port.BatchedLAP(batch=3, num_rows=10, num_cols=10,
                          solver="khosla", dtype=np.float64, device="cpu")
    jlap = jbatch.BatchedLAP(batch=3, num_rows=10, num_cols=10,
                             solver="khosla", dtype=np.float64)
    rng = np.random.default_rng(4)
    for _ in range(2):
        costs = rng.uniform(1, 5, size=(3, 10, 10))
        sol = lap.solve(costs)
        assert_same(sol, jlap.solve(costs))
        assert np.all(sol.num_unassigned == 0)
        assert np.all(sol.objective <= oracle(costs) + 10 * sol.eps + 1e-9)
    with pytest.raises(ValueError, match="expected costs of shape"):
        lap.solve(np.zeros((2, 10, 10)))


def test_batched_lap_defaults_to_forward_and_stages_on_the_device():
    lap = port.BatchedLAP(batch=2, num_rows=8, num_cols=12, device="cpu")
    assert lap.solver == "forward"
    rng = np.random.default_rng(5)
    costs = rng.integers(1, 30, size=(2, 8, 12)).astype(np.float64)
    staged = lap.stage(costs)
    assert isinstance(staged, torch.Tensor)
    assert staged.dtype == torch.float32 and staged.device.type == "cpu"
    sol = lap.solve(costs, costs_device=staged)
    assert_same(sol, lap.solve(costs))
    np.testing.assert_array_equal(sol.objective, oracle(costs))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.BatchedLAP(2, 8, 12).stage(costs)
