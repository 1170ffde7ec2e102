"""The port's single sparse device engines against the JAX package's, on
the CPU.

Each route gives JAX's ``person_to_object``, ``object_to_person``,
prices, ``nits`` and ``num_unassigned`` (the forward routes also
``nreductions``, ``optimal_found`` and ``eps``), in float32 and float64:
``khosla_solve``, ``khosla_solve_compact`` (cold and warm),
``khosla_solve_scaled``, ``khosla_solve_hybrid`` (``tpu_phases`` 0, 1
and ``None``, its ``tail_threshold`` lowered so the device bulk runs at
test size), ``forward_solve`` and ``forward_solve_chunked`` (with the
infeasibility certificate), both solvers with ``engine="device"``, and
``solve_batch_sparse(engine="padded")``.  JAX runs on its CPU backend,
where ``KhoslaSolver`` takes the same ``khosla_solve`` route as the
port with ``device="cpu"``.  Tolerance 0 unless a line says otherwise;
scipy is the oracle of the mirrored ``test_random.py``,
``test_warmstart.py`` and ``test_infeasible.py`` cases.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import sparse_linear_assignment_tpu as jpkg
import sparse_linear_assignment_tpu.batch as jbatch
from sparse_linear_assignment_tpu import generators as jgen
from sparse_linear_assignment_tpu.hybrid import (
    khosla_solve_hybrid as jax_hybrid,
)
from sparse_linear_assignment_tpu.ops import auction as jauction
from sparse_linear_assignment_tpu.ops import compact as jcompact
from sparse_linear_assignment_tpu.ops.padded import (
    build_padded_problem as jax_build,
)
import sparse_linear_assignment_tpu_torch as tpkg
from sparse_linear_assignment_tpu_torch import generators as tgen
from sparse_linear_assignment_tpu_torch.hybrid import khosla_solve_hybrid
from sparse_linear_assignment_tpu_torch.ops import auction, compact
from sparse_linear_assignment_tpu_torch.ops.padded import (
    build_padded_problem,
)

torch.set_num_threads(1)

UNASSIGNED = tpkg.UNASSIGNED
DTYPES = [np.float32, np.float64]
BIG = 1e9


def csr(n, seed=5, density=0.03, hi=10.0, m=None):
    """A minimisation's CSR as ``init_solve`` leaves it (values
    negated): a symmetric instance, or a k-sparse one with ``m``
    columns."""
    solver, _ = jpkg.KhoslaSolver.new(1, 1, 1)
    if m is None:
        jgen.gen_symmetric_input(solver, seed, n, density, 0.0, hi)
    else:
        jgen.gen_ksparse_uniform(solver, seed, n, m, 6, hi)
    counts = np.asarray(solver.j_counts)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return (counts, starts, np.asarray(solver.column_indices),
            -np.asarray(solver.values), solver.num_cols)


def problems(n, dtype, **kw):
    counts, starts, cols, vals, m = csr(n, **kw)
    jp = jax_build(n, m, counts, cols, vals, dtype=dtype)
    tp = build_padded_problem(n, m, counts, cols, vals, dtype=dtype,
                              device="cpu")
    return jp, tp, (starts, cols, vals, m)


def assert_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        np.testing.assert_array_equal(g, w)


def pair(cls, gen, *args, dtype=np.float64):
    ts, tsol = getattr(tpkg, cls).new(1, 1, 1, dtype=dtype)
    js, jsol = getattr(jpkg, cls).new(1, 1, 1, dtype=dtype)
    getattr(tgen, gen)(ts, *args)
    getattr(jgen, gen)(js, *args)
    return ts, tsol, js, jsol


def assert_same(ts, tsol, js, jsol):
    np.testing.assert_array_equal(tsol.person_to_object,
                                  jsol.person_to_object)
    np.testing.assert_array_equal(tsol.object_to_person,
                                  jsol.object_to_person)
    np.testing.assert_array_equal(ts.prices, js.prices)
    assert tsol.num_unassigned == jsol.num_unassigned
    assert tsol.eps == jsol.eps
    assert ts.nits == js.nits
    for name in ("nreductions", "optimal_soln_found"):
        assert getattr(ts, name, None) == getattr(js, name, None)


def oracle(solver, maximize=False):
    mat = tgen.dense_cost_matrix(solver, big=-BIG if maximize else BIG,
                                 original_units=True)
    r, c = linear_sum_assignment(mat, maximize=maximize)
    assert np.all(np.abs(mat[r, c]) < BIG), "the oracle used a missing arc"
    return float(mat[r, c].sum())


def assert_near_optimal(solver, solution, maximize=False):
    want = oracle(solver, maximize)
    got = solver.get_objective(solution)
    bound = solver.num_rows * solution.eps
    if maximize:
        assert want - bound - 1e-9 <= got <= want + 1e-9, (got, want)
    else:
        assert want - 1e-9 <= got <= want + bound + 1e-9, (got, want)


def lstate_fields(state):
    if isinstance(state, compact.LState):
        return compact.lstate_to_numpy(state)
    return {k: np.asarray(v) for k, v in state._asdict().items()}


# ----------------------------------------------------------------------
# the drivers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("max_rounds", [10_000_000, 7])
@pytest.mark.parametrize("dtype", DTYPES)
def test_khosla_solve_equals_jax(dtype, max_rounds):
    jp, tp, _ = problems(60, dtype, density=0.1)
    thr = 30.0 * (10.0 + 1.0 / 60)
    want = jauction.khosla_solve(jp, 1.0 / 60, thr, max_rounds=max_rounds)
    got = auction.khosla_solve(tp, 1.0 / 60, thr, max_rounds=max_rounds)
    assert_arrays(got, want)
    if max_rounds == 7:
        assert int(got[4]) == 7 and int(got[3]) > 0


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_khosla_solve_compact_equals_jax(dtype, warm):
    n = 300
    jp, tp, _ = problems(n, dtype)
    eps, thr = 1.0 / n, (n / 2.0) * (10.0 + 1.0 / n)
    jinit = tinit = None
    if warm:
        rng = np.random.default_rng(1)
        prices = rng.uniform(0.0, 0.5, n).astype(dtype)
        jinit = jcompact.LState(
            prices=jax_numpy(prices), p2o=jax_full(n), o2p=jax_full(n),
            dropped=jax_numpy(np.zeros(n, bool)),
            slots=jax_numpy(np.arange(n, dtype=np.int32)),
            nits=jax_numpy(np.int32(0)),
        )
        tinit = compact.fresh_lstate(torch.from_numpy(prices), n)
    want = jcompact.khosla_solve_compact(jp, eps, thr, init_state=jinit)
    got = compact.khosla_solve_compact(tp, eps, thr, init_state=tinit,
                                       device="cpu")
    for k, v in lstate_fields(want).items():
        np.testing.assert_array_equal(lstate_fields(got)[k], v, err_msg=k)
    assert int(got.nits) > 0


def jax_numpy(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def jax_full(n):
    return jax_numpy(np.full(n, UNASSIGNED, np.int32))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_khosla_solve_scaled_equals_jax(dtype, warm):
    n = 200
    jp, tp, _ = problems(n, dtype, seed=8)
    start = None
    if warm:
        start = np.random.default_rng(2).uniform(0.0, 1.0, n)
    kw = dict(start_prices=start, threshold_pad=0.0 if start is None
              else float(start.max()))
    jstate, jrounds = jcompact.khosla_solve_scaled(jp, 1.0 / n, -10.0, 0.0,
                                                   **kw)
    tstate, trounds = compact.khosla_solve_scaled(tp, 1.0 / n, -10.0, 0.0,
                                                  device="cpu", **kw)
    assert trounds == jrounds
    for k, v in lstate_fields(jstate).items():
        np.testing.assert_array_equal(lstate_fields(tstate)[k], v,
                                      err_msg=k)


@pytest.mark.parametrize("tpu_phases", [0, 1, None])
@pytest.mark.parametrize("dtype", DTYPES)
def test_khosla_solve_hybrid_equals_jax(dtype, tpu_phases):
    """``tail_threshold`` lowered to 10 so that the device bulk of a
    phase runs at n = 200."""
    n = 200
    jp, tp, (starts, cols, vals, m) = problems(n, dtype)
    args = (n, m, starts, cols, vals)
    kw = dict(tail_threshold=10, tpu_phases=tpu_phases)
    lo, hi = float(vals.min()), float(vals.max())
    want = jax_hybrid(*args, jp, 1.0 / n, lo, hi, **kw)
    got = khosla_solve_hybrid(*args, tp, 1.0 / n, lo, hi, device="cpu",
                              **kw)
    assert_arrays(got[:4], want[:4])
    assert got[4:] == want[4:]
    assert got[4] == {0: 0, 1: 4, None: 12}[tpu_phases]
    assert (got[1] != UNASSIGNED).all()


def test_khosla_solve_hybrid_native_ladder_needs_no_problem():
    n = 200
    _, _, (starts, cols, vals, m) = problems(n, np.float32)
    args = (n, m, starts, cols, vals, None, 1.0 / n, float(vals.min()),
            float(vals.max()))
    got = khosla_solve_hybrid(*args, tpu_phases=0)
    want = jax_hybrid(*args, tpu_phases=0)
    assert_arrays(got[:4], want[:4])
    assert got[4:] == want[4:]
    with pytest.raises(ValueError, match="padded problem"):
        khosla_solve_hybrid(*args, tpu_phases=1, tail_threshold=10)


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_solve_and_chunked_equal_jax(dtype):
    n = 40
    jp, tp, (_, _, vals, _) = problems(n, dtype, density=0.2, hi=50.0,
                                       seed=4)
    c = float(np.abs(vals).max())
    args = (c / 2.0, 1.0 / n, 2.0 ** -47, False, 100_000)
    want = jauction.forward_solve(jp, *args)
    got = auction.forward_solve(tp, *args)
    assert_arrays(got, want)
    want = jauction.forward_solve_chunked(jp, *args, value_bound=c)
    got = auction.forward_solve_chunked(tp, *args, value_bound=c,
                                        device="cpu")
    assert_arrays(got, want)
    assert bool(got[6]) and int(got[5]) > 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_solve_chunked_certificate_equals_jax(dtype):
    """An infeasible instance (two persons, one object) stops on the
    price bound, far below ``max_iterations``, in both packages."""
    npd = np.dtype(dtype)
    counts, cols, vals = np.array([1, 1]), np.array([0, 0]), \
        np.array([-1.0, -2.0])
    jp = jax_build(2, 2, counts, cols, vals, dtype=dtype)
    tp = build_padded_problem(2, 2, counts, cols, vals, dtype=dtype,
                              device="cpu")
    args = (1.0, 0.5, 2.0 ** -52, False, 100_000)
    kw = dict(start_prices=np.array([0.25, 0.0]), value_bound=2.0)
    want = jauction.forward_solve_chunked(jp, *args, **kw)
    got = auction.forward_solve_chunked(tp, *args, device="cpu", **kw)
    assert_arrays(got, want)
    assert int(got[3]) == 1 and not bool(got[6])
    assert int(got[4]) < 10_000
    assert got[0].dtype == torch.from_numpy(np.zeros(1, npd)).dtype


def test_forward_certificate_disarms_loudly_on_overflow():
    counts, cols, vals = np.array([1, 1]), np.array([0, 0]), \
        np.array([-1.0, -2.0])
    tp = build_padded_problem(2, 2, counts, cols, vals, dtype=np.float32,
                              device="cpu")
    with pytest.warns(RuntimeWarning, match="disarmed"):
        got = auction.forward_solve_chunked(
            tp, 1.0, 0.5, 0.0, False, 200, value_bound=1e38, device="cpu")
    assert int(got[4]) == 200  # ran to max_iterations


# ----------------------------------------------------------------------
# the solvers' device routes against JAX
# ----------------------------------------------------------------------
KHOSLA_ROUTES = [
    {"engine": "device"},
    {"compact": True},
    {"scale_eps": True},
    {"hybrid": True},
    {"hybrid": True, "scale_eps": True},
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kw", KHOSLA_ROUTES, ids=lambda kw: "-".join(kw))
def test_khosla_device_routes_equal_jax(kw, dtype):
    ts, tsol, js, jsol = pair("KhoslaSolver", "gen_symmetric_input", 3, 60,
                              0.15, 1.0, 10.0, dtype=dtype)
    ts.solve(tsol, False, device="cpu", **kw)
    js.solve(jsol, False, **kw)
    assert_same(ts, tsol, js, jsol)
    assert tsol.num_unassigned == 0
    assert_near_optimal(ts, tsol)


@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_device_route_equals_jax(dtype, maximize):
    ts, tsol, js, jsol = pair("ForwardAuctionSolver", "gen_symmetric_input",
                              4, 40, 0.2, 1.0, 50.0, dtype=dtype)
    ts.solve(tsol, maximize, engine="device", device="cpu")
    js.solve(jsol, maximize, engine="device")
    assert_same(ts, tsol, js, jsol)
    assert ts.optimal_soln_found
    assert_near_optimal(ts, tsol, maximize)


@pytest.mark.parametrize("cls", ["KhoslaSolver", "ForwardAuctionSolver"])
def test_asymmetric_device_routes_equal_jax(cls):
    ts, tsol, js, jsol = pair(cls, "gen_asymmetric_input", 7, 50, 300, 8,
                              300.0, 700.0)
    ts.solve(tsol, False, engine="device", device="cpu")
    js.solve(jsol, False, engine="device")
    assert_same(ts, tsol, js, jsol)
    assert_near_optimal(ts, tsol)


def test_forward_solve_with_params_device_equals_jax():
    ts, tsol, js, jsol = pair("ForwardAuctionSolver", "gen_symmetric_input",
                              9, 30, 0.2, 1.0, 50.0)
    for kw in ({"eps": 0.01, "start_eps": 5.0},
               {"max_iterations": 30, "start_prices": np.ones(30)}):
        ts.solve_with_params(tsol, False, engine="device", device="cpu",
                             **kw)
        js.solve_with_params(jsol, False, engine="device", **kw)
        assert_same(ts, tsol, js, jsol)


def test_single_arc_forward_rows_take_the_device_route():
    out = []
    for pkg, kw in ((tpkg, {"device": "cpu"}), (jpkg, {})):
        solver, solution = pkg.ForwardAuctionSolver.new(3, 3, 6)
        solver.init(3, 3)
        solver.extend_from_values(0, [0, 1, 2], [5.0, 3.0, 8.0])
        solver.extend_from_values(1, [0, 1], [4.0, 7.0])
        solver.extend_from_values(2, [2], [2.0])
        solver.solve(solution, maximize=False, **kw)
        assert solution.num_unassigned == 0
        out.append((list(solution.person_to_object), solver.nits,
                    list(solver.prices)))
    assert out[0] == out[1]


# ----------------------------------------------------------------------
# no route leaves the card quietly
# ----------------------------------------------------------------------
DEVICE_ARGS = [
    {"engine": "device"}, {"scale_eps": True}, {"compact": True},
    {"hybrid": True}, {"start_prices": np.zeros(4)},
]


@pytest.mark.parametrize("kw", DEVICE_ARGS, ids=lambda kw: "-".join(kw))
def test_device_routes_need_a_card_unless_asked_for_the_cpu(kw):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    solver, solution = tpkg.KhoslaSolver.new(4, 4, 16)
    tgen.gen_symmetric_input(solver, 1, 4, 0.5, 1.0, 9.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve(solution, False, **kw)
    fsolver, fsolution = tpkg.ForwardAuctionSolver.new(4, 4, 16)
    tgen.gen_symmetric_input(fsolver, 1, 4, 0.5, 1.0, 9.0)
    fkw = {k: v for k, v in kw.items() if k in ("engine", "start_prices")}
    if fkw:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fsolver.solve_with_params(fsolution, False, **fkw)
    solver.solve(solution, False, device="cpu", **kw)
    assert solution.num_unassigned == 0


def test_drivers_check_the_problems_device():
    _, tp, _ = problems(20, np.float32, density=0.2)
    with pytest.raises(ValueError, match="lies on cpu"):
        compact.khosla_solve_compact(tp, 0.1, 10.0, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compact.khosla_solve_compact(tp, 0.1, 10.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            auction.forward_solve_chunked(tp, 1.0, 0.1, 0.0, False, 10)


# ----------------------------------------------------------------------
# test_warmstart.py on the port's device routes
# ----------------------------------------------------------------------
def test_khosla_warmstart_same_instance_fewer_rounds():
    n = 256
    solver, solution = tpkg.KhoslaSolver.new(n, n, 20 * n)
    tgen.gen_symmetric_input(solver, 21, n, 0.05, 0.0, 10.0)
    solver.solve(solution, False, compact=True, device="cpu")
    cold_nits = solver.nits
    assert solution.num_unassigned == 0
    assert_near_optimal(solver, solution)
    warm = solver.prices.copy()
    solver.solve(solution, False, compact=True, start_prices=warm,
                 device="cpu")
    assert solution.num_unassigned == 0
    assert_near_optimal(solver, solution)
    assert solver.nits <= cold_nits


def test_khosla_warmstart_scaled_path_equals_jax():
    ts, tsol, js, jsol = pair("KhoslaSolver", "gen_symmetric_input", 4, 128,
                              0.1, 0.0, 10.0)
    ts.solve(tsol, False, scale_eps=True, device="cpu")
    js.solve(jsol, False, scale_eps=True)
    assert_same(ts, tsol, js, jsol)
    assert_near_optimal(ts, tsol)
    ts.solve(tsol, False, scale_eps=True, start_prices=ts.prices.copy(),
             device="cpu")
    js.solve(jsol, False, scale_eps=True, start_prices=js.prices.copy())
    assert_same(ts, tsol, js, jsol)
    assert tsol.num_unassigned == 0
    assert_near_optimal(ts, tsol)


def test_forward_warmstart():
    n = 64
    rng = np.random.default_rng(13)
    costs = rng.integers(1, 100, size=(n, n)).astype(np.float64)
    solver, solution = tpkg.ForwardAuctionSolver.new(n, n, n * n)
    solver.init(n, n)
    solver.extend_from_csr(np.full(n, n), np.tile(np.arange(n), n),
                           costs.ravel())
    solver.solve(solution, False, engine="device", device="cpu")
    cold_nits = solver.nits
    obj_cold = solver.get_objective(solution)
    solver.solve_with_params(solution, False, start_eps=0.5 / n,
                             start_prices=solver.prices.copy(),
                             device="cpu")
    assert solution.num_unassigned == 0
    assert abs(solver.get_objective(solution) - obj_cold) < 1e-9
    assert solver.nits < cold_nits


def test_khosla_warmstart_shape_validation():
    n = 16
    solver, solution = tpkg.KhoslaSolver.new(n, n, 4 * n)
    tgen.gen_symmetric_input(solver, 2, n, 0.5, 0.0, 10.0)
    with pytest.raises(ValueError, match="start_prices"):
        solver.solve(solution, start_prices=np.zeros(n + 1), device="cpu")
    fsolver, fsolution = tpkg.ForwardAuctionSolver.new(n, n, 4 * n)
    tgen.gen_symmetric_input(fsolver, 2, n, 0.5, 0.0, 10.0)
    with pytest.raises(ValueError, match="start_prices"):
        fsolver.solve_with_params(fsolution, start_prices=np.zeros(n + 1),
                                  device="cpu")


@pytest.mark.parametrize("cls", ["KhoslaSolver", "ForwardAuctionSolver"])
def test_warmstart_asymmetric_ignored_with_a_warning(cls):
    """Warm prices on an asymmetric instance are unsound: both packages
    warn, run cold and give the cold solve's result."""
    ts, tsol, js, jsol = pair(cls, "gen_ksparse_uniform", 5, 50, 120, 6,
                              9.0)
    ts.solve(tsol, False, engine="device", device="cpu")
    cold = (tsol.person_to_object.copy(), ts.nits)
    assert_near_optimal(ts, tsol)
    warm = ts.prices.copy() + 3.0
    if cls == "KhoslaSolver":
        solve_t = lambda: ts.solve(tsol, False, start_prices=warm,
                                   device="cpu")
        solve_j = lambda: js.solve(jsol, False, start_prices=warm)
    else:
        solve_t = lambda: ts.solve_with_params(tsol, False,
                                               start_prices=warm,
                                               device="cpu")
        solve_j = lambda: js.solve_with_params(jsol, False,
                                               start_prices=warm)
    with pytest.warns(UserWarning, match="start_prices ignored"):
        solve_t()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        solve_j()
    assert_same(ts, tsol, js, jsol)
    np.testing.assert_array_equal(tsol.person_to_object, cold[0])
    assert ts.nits == cold[1]


@pytest.mark.parametrize("rekw", [{}, {"scale_eps": True},
                                  {"scale_eps": True, "hybrid": True}],
                         ids=["plain", "scaled", "hybrid"])
def test_warm_start_after_scaled_solve_stays_complete(rekw):
    n = m = 10
    ts, tsol, js, jsol = pair("KhoslaSolver", "gen_ksparse_uniform", 7, n,
                              m, 2, 50.0)
    ts.solve(tsol, False, scale_eps=True, hybrid=True, device="cpu")
    cold_obj = ts.get_objective(tsol)
    warm = ts.prices.copy()
    assert warm.max() > (m / 2.0) * (49.0 + tsol.eps) * 0.99
    ts.solve(tsol, False, start_prices=warm, device="cpu", **rekw)
    assert tsol.num_unassigned == 0
    assert abs(ts.get_objective(tsol) - cold_obj) <= n * tsol.eps + 1e-9
    js.solve(jsol, False, scale_eps=True, hybrid=True)
    js.solve(jsol, False, start_prices=js.prices.copy(), **rekw)
    assert_same(ts, tsol, js, jsol)


@pytest.mark.parametrize("n,seed", [(10, 269786713), (6, 394149180),
                                    (9, 485835358)])
@pytest.mark.parametrize("hybrid", [False, True])
def test_ladder_phase_boundary_never_drops_feasible(n, seed, hybrid):
    solver, solution = tpkg.KhoslaSolver.new(n, n, n * 10)
    tgen.gen_ksparse_uniform(solver, seed, n, n, 2, 1000.0)
    solver.solve(solution, False, scale_eps=True, hybrid=hybrid,
                 device="cpu")
    assert solution.num_unassigned == 0
    assert_near_optimal(solver, solution)
    solver._solve_native_ladder(solution, False, None)
    assert solution.num_unassigned == 0
    assert_near_optimal(solver, solution)


# ----------------------------------------------------------------------
# test_random.py on the port's device routes (scipy's oracle)
# ----------------------------------------------------------------------
SOLVERS = ["KhoslaSolver", "ForwardAuctionSolver"]


def check_matching(solution):
    p2o = np.asarray(solution.person_to_object)
    o2p = np.asarray(solution.object_to_person)
    assigned = p2o != UNASSIGNED
    assert len(set(p2o[assigned].tolist())) == int(assigned.sum())
    for i in np.nonzero(assigned)[0]:
        assert o2p[p2o[i]] == i
    assert solution.num_unassigned == int((~assigned).sum())


@pytest.mark.parametrize("cls", SOLVERS)
@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_symmetric_random_vs_oracle(cls, maximize, seed):
    n = 40
    solver, solution = getattr(tpkg, cls).new(n, n, n * n,
                                              dtype=np.float32)
    tgen.gen_symmetric_input(solver, seed, n, 0.12, 500.0, 1000.0)
    solver.solve(solution, maximize, engine="device", device="cpu")
    assert solution.num_unassigned == 0
    check_matching(solution)
    want = oracle(solver, maximize)
    got = solver.get_objective(solution)
    # float32 prices: the n-eps bound plus the rounding allowance
    slack = n * solution.eps + 1e-6 * abs(want)
    if maximize:
        assert want - slack <= got <= want + 1e-9
    else:
        assert want - 1e-9 <= got <= want + slack


@pytest.mark.parametrize("cls", SOLVERS)
@pytest.mark.parametrize("seed", [1, 2])
def test_symmetric_integer_exact_optimal(cls, seed):
    n = 24
    solver, solution = getattr(tpkg, cls).new(n, n, n * n)
    tgen.gen_symmetric_input(solver, seed, n, 0.2, 500.0, 1000.0)
    solver.map_values(np.floor)
    solver.solve(solution, False, eps=1.0 / (n + 1), engine="device",
                 device="cpu")
    assert solution.num_unassigned == 0
    assert solver.get_objective(solution) == pytest.approx(oracle(solver),
                                                           abs=1e-9)


@pytest.mark.parametrize("cls", SOLVERS)
@pytest.mark.parametrize("seed", [5, 6])
def test_asymmetric_ksparse_vs_oracle(cls, seed):
    num_rows, num_cols, k = 90, 900, 32
    solver, solution = getattr(tpkg, cls).new(num_rows, num_cols,
                                              num_rows * k)
    tgen.gen_ksparse_uniform(solver, seed, num_rows, num_cols, k, 10.0)
    solver.solve(solution, False, engine="device", device="cpu")
    assert solution.num_unassigned == 0
    check_matching(solution)
    assert_near_optimal(solver, solution)


@pytest.mark.parametrize("cls", SOLVERS)
def test_ecs_certificate(cls):
    n = 30
    solver, solution = getattr(tpkg, cls).new(n, n, n * n)
    tgen.gen_symmetric_input(solver, 11, n, 0.15, 1.0, 10.0)
    solver.solve(solution, False, engine="device", device="cpu")
    assert solution.num_unassigned == 0
    assert solver.ecs_satisfied(solution.person_to_object, solution.eps,
                                1e-9)
    # the device form of the certificate agrees
    problem = solver._staged_problem[2]
    assert bool(auction.ecs_satisfied_device(
        problem, torch.from_numpy(solver.prices),
        torch.from_numpy(solution.person_to_object), solution.eps, 1e-9))


@pytest.mark.parametrize("cls", SOLVERS)
def test_random_solve_small(cls):
    n, k = 5, 2
    solver, solution = getattr(tpkg, cls).new(n, n, n * k)
    for maximize in (False, True):
        tgen.gen_ksparse_uniform(solver, 1, n, n, k, 10.0)
        solver.solve(solution, maximize, engine="device", device="cpu")
        check_matching(solution)
        if solution.num_unassigned == 0:
            assert_near_optimal(solver, solution, maximize)


# ----------------------------------------------------------------------
# the device cases of test_infeasible.py on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{"engine": "device"}, {"compact": True},
                                {"scale_eps": True}, {"hybrid": True}],
                         ids=lambda kw: "-".join(kw))
def test_khosla_infeasible_terminates(kw):
    solver, solution = tpkg.KhoslaSolver.new(2, 2, 2)
    solver.init(2, 2)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 0, 2.0)
    solver.solve(solution, False, device="cpu", **kw)
    assert solution.num_unassigned == 1


@pytest.mark.parametrize("seed,expected_matching", [(6, 8), (22, 7)])
def test_khosla_device_no_perfect_matching_equals_jax(seed,
                                                      expected_matching):
    ts, tsol, js, jsol = pair("KhoslaSolver", "gen_ksparse_uniform", seed,
                              9, 9, 3, 10.0)
    ts.solve(tsol, False, engine="device", device="cpu")
    js.solve(jsol, False, engine="device")
    assert_same(ts, tsol, js, jsol)
    assert 9 - expected_matching <= tsol.num_unassigned < 9
    check_matching(tsol)


def test_forward_device_infeasibility_certificate_early_exit():
    solver, solution = tpkg.ForwardAuctionSolver.new(2, 2, 2)
    solver.init(2, 2)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 0, 2.0)
    solver.solve(solution, False, device="cpu")  # single arcs: device
    assert solution.num_unassigned >= 1
    assert not solver.optimal_soln_found
    assert solver.nits < 10_000


def test_forward_feasible_unaffected_by_certificate():
    n = 24
    rng = np.random.default_rng(17)
    costs = rng.integers(1, 100, size=(n, n)).astype(np.float64)
    solver, solution = tpkg.ForwardAuctionSolver.new(n, n, n * n)
    solver.init(n, n)
    for i in range(n):
        solver.extend_from_values(i, range(n), costs[i])
    solver.solve_with_params(solution, False, eps=1.0 / (n + 1),
                             engine="device", device="cpu")
    assert solution.num_unassigned == 0
    r, c = linear_sum_assignment(costs)
    assert abs(solver.get_objective(solution)
               - float(costs[r, c].sum())) < 1e-9


def test_certificate_fuzz_sound_and_live():
    rng = np.random.default_rng(0)
    for trial in range(36):
        n = 8 if trial % 2 else 17
        infeasible = trial % 3 == 0
        solver, sol = tpkg.ForwardAuctionSolver.new(n, n, n * n)
        solver.init(n, n)
        if infeasible:
            used = int(rng.integers(1, n))
            for i in range(n):
                k = int(rng.integers(1, used + 1))
                cols = np.sort(rng.choice(used, size=k, replace=False))
                solver.extend_from_values(i, cols, rng.uniform(0, 50, k))
        else:
            perm = rng.permutation(n)
            for i in range(n):
                extra = rng.choice(n, size=int(rng.integers(0, 4)),
                                   replace=False)
                cols = np.unique(np.concatenate([[perm[i]], extra]))
                solver.extend_from_values(i, cols,
                                          rng.uniform(0, 50, cols.size))
        solver.solve_with_params(sol, False, engine="device", device="cpu")
        if infeasible:
            assert sol.num_unassigned >= 1, trial
            assert solver.nits < 100_000, trial
        else:
            assert sol.num_unassigned == 0, trial


# ----------------------------------------------------------------------
# solve_batch_sparse(engine="padded") against JAX's padded engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_batch_sparse_padded_equals_jax(dtype):
    rng = np.random.default_rng(0)
    b, n, m, k = 3, 12, 40, 4
    columns = np.stack([
        np.stack([rng.choice(m, k, replace=False) for _ in range(n)])
        for _ in range(b)
    ]).astype(np.int32)
    columns[0, 3, 2:] = -1  # a person with two arcs
    columns[2, :, 1:] = np.where(np.arange(n)[:, None] < 4, 0,
                                 columns[2, :, 1:])  # crowd object 0
    values = rng.integers(1, 40, size=(b, n, k)).astype(np.float64)
    got = tpkg.solve_batch_sparse(columns, values, m, engine="padded",
                                  dtype=dtype, device="cpu")
    want = jbatch.solve_batch_sparse(columns, values, m, engine="padded",
                                     dtype=dtype)
    for name in ("person_to_object", "object_to_person", "num_unassigned",
                 "nits", "objective", "eps"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
