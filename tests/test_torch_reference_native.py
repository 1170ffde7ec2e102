"""The port's native engine routes against the JAX package's, on the CPU.

Mirrors ``test_native_engine.py``, ``test_router.py`` and the native
cases of ``test_infeasible.py`` on the port, and holds every native
result equal to JAX's field for field: ``person_to_object``,
``object_to_person``, prices, ``nits`` (stack pops), ``nreductions``,
``optimal_soln_found`` and ``eps``, including the native eps ladder
that ``KhoslaSolver``'s auto route takes from 4096 symmetric rows.
Tolerance 0 unless a line says otherwise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

import sparse_linear_assignment_tpu as jpkg
import sparse_linear_assignment_tpu_torch as tpkg
from sparse_linear_assignment_tpu import cpu_reference as jcpu
from sparse_linear_assignment_tpu import generators as jgen
from sparse_linear_assignment_tpu_torch import cpu_reference as tcpu
from sparse_linear_assignment_tpu_torch import generators as tgen

from test_fixed_cases import CASES, populate_dense

UNASSIGNED = tpkg.UNASSIGNED


def pair(cls, gen, *args, dtype=np.float64):
    """The same generated instance in both packages: ``(port solver,
    port solution, JAX solver, JAX solution)``."""
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
    assert tsol.eps == jsol.eps or (np.isnan(tsol.eps)
                                    and np.isnan(jsol.eps))
    assert ts.nits == js.nits
    for name in ("nreductions", "optimal_soln_found", "max_iterations"):
        assert getattr(ts, name, None) == getattr(js, name, None)


def oracle(solver):
    mat = tgen.dense_cost_matrix(solver, big=1e9, original_units=True)
    r, c = linear_sum_assignment(mat)
    return float(mat[r, c].sum())


# ----------------------------------------------------------------------
# test_native_engine.py on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", range(len(CASES)))
def test_native_khosla_fixed_cases(case):
    maximize, costs, optimal_cost, _ = CASES[case]
    solver, _ = tpkg.KhoslaSolver.new(10, 10, 100)
    populate_dense(solver, costs)
    solution, nits = tcpu.khosla_solve_cpu(solver, maximize)
    assert solution.num_unassigned == 0
    assert solver.get_objective(solution) == optimal_cost
    assert nits >= len(costs)
    jsolver, _ = jpkg.KhoslaSolver.new(10, 10, 100)
    populate_dense(jsolver, costs)
    jsolution, jnits = jcpu.khosla_solve_cpu(jsolver, maximize)
    assert nits == jnits
    np.testing.assert_array_equal(solution.person_to_object,
                                  jsolution.person_to_object)
    np.testing.assert_array_equal(solver.prices, jsolver.prices)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_native_forward_fixed_cases(case):
    maximize, costs, optimal_cost, _ = CASES[case]
    solver, _ = tpkg.ForwardAuctionSolver.new(10, 10, 100)
    populate_dense(solver, costs)
    got = tcpu.forward_solve_cpu(solver, maximize)
    assert got[0].num_unassigned == 0
    assert solver.get_objective(got[0]) == optimal_cost
    assert got[3]
    jsolver, _ = jpkg.ForwardAuctionSolver.new(10, 10, 100)
    populate_dense(jsolver, costs)
    want = jcpu.forward_solve_cpu(jsolver, maximize)
    assert got[1:] == want[1:]
    assert got[0].eps == want[0].eps
    np.testing.assert_array_equal(got[0].person_to_object,
                                  want[0].person_to_object)
    np.testing.assert_array_equal(solver.prices, jsolver.prices)


@pytest.mark.parametrize("engine", ["khosla", "forward"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_vs_oracle_symmetric(engine, seed):
    n = 40
    solver, _ = tpkg.KhoslaSolver.new(n, n, n * n)
    tgen.gen_symmetric_input(solver, seed, n, 0.25, 500.0, 1000.0)
    if engine == "khosla":
        solution, _ = tcpu.khosla_solve_cpu(solver)
    else:
        solution = tcpu.forward_solve_cpu(solver)[0]
    assert solution.num_unassigned == 0
    want = oracle(solver)
    got = solver.get_objective(solution)
    assert want - 1e-9 <= got <= want + n * solution.eps + 1e-9


@pytest.mark.parametrize("seed", [5, 6])
def test_native_agrees_with_device_solver(seed):
    """Integer costs with eps below 1/n: the sequential engine and the
    synchronous device rounds (on the CPU) reach the same optimum."""
    num_rows, num_cols, k = 80, 400, 16
    results = {}
    for engine in ("native", "device"):
        solver, solution = tpkg.KhoslaSolver.new(num_rows, num_cols,
                                                 num_rows * k)
        tgen.gen_ksparse_uniform(solver, seed, num_rows, num_cols, k, 10.0)
        solver.map_values(np.floor)
        solver.solve(solution, False, eps=1.0 / (num_rows + 1),
                     engine=engine, device="cpu")
        assert solution.num_unassigned == 0
        results[engine] = solver.get_objective(solution)
    assert abs(results["native"] - results["device"]) <= 1e-9


def test_native_khosla_infeasible_terminates():
    solver, _ = tpkg.KhoslaSolver.new(2, 2, 2)
    solver.init(2, 2)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 0, 2.0)
    solution, nits = tcpu.khosla_solve_cpu(solver)
    assert solution.num_unassigned == 1
    assert nits < 10_000


def test_native_forward_max_iterations():
    solver, _ = tpkg.ForwardAuctionSolver.new(2, 2, 2)
    solver.init(2, 2)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 0, 2.0)
    solution, nits, _, optimal = tcpu.forward_solve_cpu(
        solver, max_iterations=500)
    assert nits == 500
    assert not optimal
    assert solution.num_unassigned == 1


def test_native_trace_env_gated():
    """``SLAP_NATIVE_TRACE`` makes the port's copy of the engine print
    its state lines; off by default.  The level latches at the first
    native call, so the probe runs in a subprocess."""
    code = (
        "from sparse_linear_assignment_tpu_torch import KhoslaSolver\n"
        "from sparse_linear_assignment_tpu_torch.cpu_reference import"
        " khosla_solve_cpu, forward_solve_cpu\n"
        "from sparse_linear_assignment_tpu_torch.generators import"
        " gen_symmetric_input\n"
        "s, _ = KhoslaSolver.new(64, 64, 64 * 64)\n"
        "gen_symmetric_input(s, 5, 64, 0.2, 0.0, 10.0)\n"
        "sol, nits = khosla_solve_cpu(s)\n"
        "assert sol.num_unassigned == 0\n"
        "sol2, nits2, _, _ = forward_solve_cpu(s)\n"
        "print('PROBE_DONE', nits, nits2)\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, SLAP_NATIVE_TRACE="2",
               SLAP_NATIVE_TRACE_EVERY="16")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=root)
    assert "PROBE_DONE" in out.stdout, (out.stdout, out.stderr[-2000:])
    assert "[slap.native] khosla_solve start:" in out.stderr
    assert "[slap.native] pop=" in out.stderr
    assert "[slap.native] forward_solve done:" in out.stderr
    env.pop("SLAP_NATIVE_TRACE")
    env.pop("SLAP_NATIVE_TRACE_EVERY")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=root)
    assert "PROBE_DONE" in out.stdout
    assert "[slap.native]" not in out.stderr


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A native engine that does not build raises, naming g++; no route
    switches to the device engines instead."""
    monkeypatch.setattr(tcpu, "_lib", None)
    monkeypatch.setattr(tcpu, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tcpu, "GXX_FLAGS", ("-fno-such-flag-xyz",))
    solver, solution = tpkg.KhoslaSolver.new(2, 2, 4)
    populate_dense(solver, [[1.0, 2.0], [3.0, 4.0]])
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        solver.solve(solution, False)
    fsolver, fsolution = tpkg.ForwardAuctionSolver.new(2, 2, 4)
    populate_dense(fsolver, [[1.0, 2.0], [3.0, 4.0]])
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        fsolver.solve(fsolution, False, engine="native")
    assert not list(tmp_path.glob("*.so"))


# ----------------------------------------------------------------------
# the solvers' native routes, field for field against JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("engine", ["auto", "native"])
@pytest.mark.parametrize("cls", ["KhoslaSolver", "ForwardAuctionSolver"])
def test_native_routes_equal_jax(cls, engine, maximize):
    ts, tsol, js, jsol = pair(cls, "gen_symmetric_input", 7, 50, 0.15,
                              500.0, 1000.0)
    ts.solve(tsol, maximize, engine=engine)
    js.solve(jsol, maximize, engine=engine)
    assert_same(ts, tsol, js, jsol)
    assert tsol.num_unassigned == 0


@pytest.mark.parametrize("cls", ["KhoslaSolver", "ForwardAuctionSolver"])
def test_native_asymmetric_equal_jax(cls):
    ts, tsol, js, jsol = pair(cls, "gen_asymmetric_input", 3, 60, 600, 12,
                              300.0, 700.0)
    ts.solve(tsol, False, engine="native")
    js.solve(jsol, False, engine="native")
    assert_same(ts, tsol, js, jsol)


def test_forward_solve_with_params_native_equal_jax():
    ts, tsol, js, jsol = pair("ForwardAuctionSolver", "gen_symmetric_input",
                              9, 40, 0.2, 1.0, 50.0)
    for kw in ({"eps": 0.01, "start_eps": 5.0},
               {"max_iterations": 30},
               {"eps": 1e-3, "start_eps": 1e-4}):
        ts.solve_with_params(tsol, False, engine="native", **kw)
        js.solve_with_params(jsol, False, engine="native", **kw)
        assert_same(ts, tsol, js, jsol)
    assert ts.nits == 30 or ts.optimal_soln_found


def test_native_ladder_at_4096_rows_equals_jax():
    """The auto route's native eps ladder (the hybrid driver with no
    device phase) from ``NATIVE_LADDER_THRESHOLD`` symmetric rows."""
    n = tpkg.KhoslaSolver.NATIVE_LADDER_THRESHOLD
    assert n == jpkg.KhoslaSolver.NATIVE_LADDER_THRESHOLD == 4096
    ts, tsol, js, jsol = pair("KhoslaSolver", "gen_symmetric_input", 42, n,
                              5.0 / n, 0.0, 10.0)
    ts.solve(tsol, False)
    js.solve(jsol, False)
    assert_same(ts, tsol, js, jsol)
    assert tsol.num_unassigned == 0
    # a ladder (rounds + pops), not the direct sequential solve
    direct, direct_nits = tcpu.khosla_solve_cpu(ts)
    assert direct.num_unassigned == 0
    assert ts.nits != direct_nits
    assert ts.get_objective(tsol) <= ts.get_objective(direct) + n * tsol.eps


# ----------------------------------------------------------------------
# test_router.py on the port
# ----------------------------------------------------------------------
def _build(n=64, seed=11):
    solver, solution = tpkg.KhoslaSolver.new(n, n, n * n)
    tgen.gen_symmetric_input(solver, seed, n, 0.2, 1.0, 50.0)
    return solver, solution, n


@pytest.mark.parametrize("engine", ["auto", "native", "device"])
def test_khosla_engines_agree(engine):
    solver, solution, n = _build()
    solver.solve(solution, maximize=False, engine=engine, device="cpu")
    assert solution.num_unassigned == 0
    want = oracle(solver)
    got = solver.get_objective(solution)
    assert want - 1e-9 <= got <= want + n * solution.eps + 1e-9


@pytest.mark.parametrize("engine", ["auto", "native", "device"])
def test_forward_engines_agree(engine):
    solver, _, n = _build(seed=12)
    fsolver, fsol = tpkg.ForwardAuctionSolver.new(n, n,
                                                  solver.num_of_arcs())
    fsolver.init(n, n)
    fsolver.extend_from_csr(solver.j_counts, solver.column_indices,
                            solver.values)
    fsolver.solve(fsol, maximize=False, engine=engine, device="cpu")
    assert fsol.num_unassigned == 0
    assert fsolver.optimal_soln_found
    assert fsolver.get_objective(fsol) == pytest.approx(oracle(fsolver),
                                                        abs=1e-6)


def test_unknown_engine_rejected():
    solver, solution, _ = _build()
    with pytest.raises(ValueError, match="unknown engine"):
        solver.solve(solution, engine="gpu")
    fsolver, fsol = tpkg.ForwardAuctionSolver.new(2, 2, 4)
    populate_dense(fsolver, [[1.0, 2.0], [3.0, 4.0]])
    with pytest.raises(ValueError, match="unknown engine"):
        fsolver.solve(fsol, engine="gpu")


def test_single_arc_rows_route_to_device():
    """The auto route does not hand single-arc rows to the native engine
    (its reference bid rule bids +inf there); on the device route it
    needs the device, so with none given and no card it raises."""
    solver, solution = tpkg.ForwardAuctionSolver.new(3, 3, 6)
    solver.init(3, 3)
    solver.extend_from_values(0, [0, 1, 2], [5.0, 3.0, 8.0])
    solver.extend_from_values(1, [0, 1], [4.0, 7.0])
    solver.extend_from_values(2, [2], [2.0])
    solver.solve(solution, maximize=False, device="cpu")  # auto
    assert solution.num_unassigned == 0
    assert solver.nits < solver.max_iterations
    assert solver._staged_problem is not None  # the device route ran


def test_explicit_device_args_force_device_path():
    solver, solution, _ = _build(seed=13)
    solver.solve(solution, maximize=False, scale_eps=True, device="cpu")
    rounds_nits = solver.nits
    solver.solve(solution, maximize=False, engine="native")
    assert rounds_nits < solver.nits


# ----------------------------------------------------------------------
# the native cases of test_infeasible.py on the port
# ----------------------------------------------------------------------
def max_matching_size(solver) -> int:
    rows = np.repeat(np.arange(solver.num_rows),
                     solver.j_counts.astype(np.int64))
    mat = csr_matrix(
        (np.ones(len(rows)), (rows, solver.column_indices.astype(np.int64))),
        shape=(solver.num_rows, solver.num_cols),
    )
    match = maximum_bipartite_matching(mat, perm_type="column")
    return int((match != -1).sum())


@pytest.mark.parametrize("seed,expected_matching", [(6, 8), (22, 7)])
def test_khosla_no_perfect_matching(seed, expected_matching):
    n, k = 9, 3
    ts, tsol, js, jsol = pair("KhoslaSolver", "gen_ksparse_uniform", seed,
                              n, n, k, 10.0)
    assert max_matching_size(ts) == expected_matching
    ts.solve(tsol, False)
    js.solve(jsol, False)
    assert_same(ts, tsol, js, jsol)
    assert n - expected_matching <= tsol.num_unassigned < n
    p2o = np.asarray(tsol.person_to_object)
    assigned = p2o != UNASSIGNED
    assert int(assigned.sum()) == n - tsol.num_unassigned
    for i in np.nonzero(assigned)[0]:
        assert tsol.object_to_person[p2o[i]] == i


@pytest.mark.parametrize("seed", [6, 22])
def test_forward_max_iterations_cutoff(seed):
    n, k = 9, 3
    ts, tsol, js, jsol = pair("ForwardAuctionSolver", "gen_ksparse_uniform",
                              seed, n, n, k, 10.0)
    ts.solve_with_params(tsol, False, None, None, max_iterations=200)
    js.solve_with_params(jsol, False, None, None, max_iterations=200)
    assert_same(ts, tsol, js, jsol)
    assert ts.nits == 200
    assert not ts.optimal_soln_found
    assert tsol.num_unassigned >= 1


def test_khosla_two_persons_one_object():
    solver, solution = tpkg.KhoslaSolver.new(2, 2, 2)
    solver.init(2, 2)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 0, 2.0)
    solver.solve(solution, False)
    assert solution.num_unassigned == 1
    assert int((solution.person_to_object != UNASSIGNED).sum()) == 1


def test_forward_two_persons_one_object_native():
    solver, solution = tpkg.ForwardAuctionSolver.new(2, 2, 2)
    solver.init(2, 2)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 0, 2.0)
    solver.solve_with_params(solution, False, None, None,
                             max_iterations=100, engine="native")
    assert solution.num_unassigned == 1
    assert not solver.optimal_soln_found
    assert solver.nits == 100
