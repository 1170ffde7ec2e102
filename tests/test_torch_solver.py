"""The port's reference-crate API surface against the JAX package's: the
CSR builder, the fixed hand-checked cases, ``push_all_left`` and the
generators, on the CPU.

Mirrors ``test_csr.py``, ``test_fixed_cases.py`` and
``test_compact.py::TestPushAllLeft`` on the port's classes, and holds
the two packages equal on the same inputs.  Tolerance 0 (bit-equal)
unless a line says otherwise.  The device engines run with
``device="cpu"``.
"""

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment

import sparse_linear_assignment_tpu as jpkg
import sparse_linear_assignment_tpu_torch as tpkg
from sparse_linear_assignment_tpu import generators as jgen
from sparse_linear_assignment_tpu.utils import push_all_left as jax_push
from sparse_linear_assignment_tpu_torch import generators as tgen
from sparse_linear_assignment_tpu_torch.utils import push_all_left

from test_fixed_cases import CASES, populate_dense

SOLVERS = ["KhoslaSolver", "ForwardAuctionSolver"]
M = tpkg.UNASSIGNED
ENGINES = ["native", "device"]


def port(name):
    return getattr(tpkg, name)


def solve(solver, solution, maximize=False, engine="auto", **kw):
    """A port solve on the CPU: the native engine ignores ``device``,
    the device engines run their plain PyTorch rounds there."""
    solver.solve(solution, maximize, engine=engine, device="cpu", **kw)


# ----------------------------------------------------------------------
# test_csr.py on the port
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cls", SOLVERS)
def test_cumulative_idx_diff(cls):
    arr = [0, 0, 0, 1, 1, 1, 1]
    solver, _ = port(cls).new(len(arr), len(arr), len(arr))
    solver.init(len(arr), len(arr))
    for i in arr:
        solver.add_value(i, 0, 0.0)
    assert list(solver.i_starts_stops) == [0, 3, 7]
    assert list(solver.j_counts) == [3, 4]
    assert solver.num_of_arcs() == 7


@pytest.mark.parametrize("cls", SOLVERS)
def test_init_preseeds(cls):
    solver, _ = port(cls).new(4, 4, 16)
    solver.init(2, 4)
    assert list(solver.i_starts_stops) == [0, 0]
    assert list(solver.j_counts) == [0]


@pytest.mark.parametrize("cls", SOLVERS)
def test_row_order_enforced(cls):
    solver, _ = port(cls).new(4, 4, 16)
    solver.init(3, 4)
    solver.add_value(0, 0, 1.0)
    with pytest.raises(ValueError):
        solver.add_value(2, 0, 1.0)
    with pytest.raises(ValueError):
        solver.extend_from_values(3, [0], [1.0])


@pytest.mark.parametrize("cls", SOLVERS)
def test_empty_row_rejected(cls):
    solver, _ = port(cls).new(4, 4, 16)
    solver.init(3, 4)
    solver.add_value(0, 0, 1.0)
    solver.add_value(1, 1, 2.0)
    assert list(solver.j_counts) == [1, 1]
    fresh, _ = port(cls).new(4, 4, 16)
    fresh.init(3, 4)
    with pytest.raises(ValueError, match="no arcs"):
        fresh.add_value(1, 0, 1.0)  # row 0 is still empty


@pytest.mark.parametrize("cls", SOLVERS)
def test_mismatched_lengths(cls):
    solver, _ = port(cls).new(4, 4, 16)
    solver.init(1, 4)
    with pytest.raises(ValueError):
        solver.extend_from_values(0, [0, 1], [1.0])


@pytest.mark.parametrize("cls", SOLVERS)
def test_rows_must_not_exceed_cols(cls):
    solver, _ = port(cls).new(4, 4, 16)
    with pytest.raises(ValueError):
        solver.init(5, 4)


@pytest.mark.parametrize("engine", ["auto", "native", "device"])
@pytest.mark.parametrize("cls", SOLVERS)
def test_validate_empty(cls, engine):
    solver, sol = port(cls).new(4, 4, 16)
    solver.init(1, 1)
    with pytest.raises(ValueError, match="no arcs"):
        solve(solver, sol, engine=engine)


@pytest.mark.parametrize("engine", ["auto", "native", "device"])
@pytest.mark.parametrize("cls", SOLVERS)
def test_column_out_of_range(cls, engine):
    solver, sol = port(cls).new(4, 4, 16)
    solver.init(1, 2)
    solver.add_value(0, 5, 1.0)
    with pytest.raises(ValueError, match="out of range"):
        solve(solver, sol, engine=engine)


@pytest.mark.parametrize("cls", SOLVERS)
def test_extend_from_csr_matches_per_row(cls):
    rng = np.random.default_rng(5)
    n, m = 12, 16
    counts = rng.integers(1, 5, size=n)
    cols = np.concatenate(
        [np.sort(rng.choice(m, size=c, replace=False)) for c in counts]
    )
    vals = rng.uniform(-3.0, 7.0, size=cols.shape[0])

    a, sol_a = port(cls).new(n, m, cols.size)
    a.init(n, m)
    a.extend_from_csr(counts, cols, vals)
    b, sol_b = port(cls).new(n, m, cols.size)
    b.init(n, m)
    start = 0
    for i, c in enumerate(counts):
        b.extend_from_values(i, cols[start:start + c], vals[start:start + c])
        start += c

    assert list(a.i_starts_stops) == list(b.i_starts_stops)
    assert list(a.j_counts) == list(b.j_counts)
    assert list(a.column_indices) == list(b.column_indices)
    np.testing.assert_array_equal(a.values, b.values)
    solve(a, sol_a)
    solve(b, sol_b)
    assert a.get_objective(sol_a) == b.get_objective(sol_b)
    assert list(sol_a.person_to_object) == list(sol_b.person_to_object)


@pytest.mark.parametrize("cls", SOLVERS)
def test_extend_from_csr_appends_after_per_row(cls):
    solver, _ = port(cls).new(4, 4, 16)
    solver.init(4, 4)
    solver.extend_from_values(0, [0, 1], [1.0, 2.0])
    solver.extend_from_csr([1, 2], [2, 0, 3], [3.0, 4.0, 5.0])
    assert list(solver.i_starts_stops) == [0, 2, 3, 5]
    assert list(solver.j_counts) == [2, 1, 2]
    solver.add_value(3, 1, 6.0)
    assert list(solver.j_counts) == [2, 1, 2, 1]


@pytest.mark.parametrize("cls", SOLVERS)
def test_extend_from_csr_validation(cls):
    solver, _ = port(cls).new(4, 4, 16)
    solver.init(4, 4)
    with pytest.raises(ValueError):  # a zero-count row in the block
        solver.extend_from_csr([2, 0], [0, 1], [1.0, 2.0])
    with pytest.raises(ValueError):  # counts and arcs disagree
        solver.extend_from_csr([2, 2], [0, 1, 2], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):  # columns and values disagree
        solver.extend_from_csr([2], [0, 1], [1.0])
    with pytest.raises(ValueError):  # non-integral column indices
        solver.extend_from_csr([1], [0.5], [1.0])
    with pytest.raises(ValueError, match="int32"):
        solver.extend_from_csr([1], [2 ** 31], [1.0])
    with pytest.raises(ValueError, match="int32"):
        solver.extend_from_values(0, [2 ** 31], [1.0])
    solver.extend_from_csr([], [], [])  # an empty block is a no-op
    assert list(solver.j_counts) == [0]


@pytest.mark.parametrize("engine", ENGINES)
def test_extend_from_scipy_csr(engine):
    scipy_sparse = pytest.importorskip("scipy.sparse")
    rng = np.random.default_rng(9)
    # integer values: n * eps = 6/8 < 1 makes the auction exactly optimal
    dense = np.where(
        rng.random((6, 8)) < 0.5,
        rng.integers(1, 9, (6, 8)).astype(np.float64),
        0.0,
    )
    dense[np.arange(6), rng.permutation(8)[:6]] = 5.0
    mat = scipy_sparse.csr_matrix(dense)

    solver, sol = tpkg.KhoslaSolver.new(6, 8, 48)
    solver.init(6, 8)
    solver.extend_from_scipy_csr(mat)
    assert solver.num_of_arcs() == mat.nnz
    solve(solver, sol, engine=engine)
    assert sol.num_unassigned == 0
    oracle = np.where(dense == 0.0, 1e9, dense)
    r, c = linear_sum_assignment(oracle)
    assert np.isclose(solver.get_objective(sol), oracle[r, c].sum())


def test_get_toleration():
    solver, _ = tpkg.KhoslaSolver.new(1, 1, 1)
    assert solver.get_toleration(1000.0) == 2.0 ** (9 - 53)
    assert solver.get_toleration(10.0) == 2.0 ** (3 - 53)
    assert solver.get_toleration(1.0) == 2.0 ** (0 - 53)
    jsolver, _ = jpkg.KhoslaSolver.new(1, 1, 1)
    for c in (0.0, 0.5, 3.7, 1e6):
        assert solver.get_toleration(c) == jsolver.get_toleration(c)


@pytest.mark.parametrize("cls", SOLVERS)
def test_capacity_hints_preallocate_and_reuse(cls):
    n, k = 64, 4
    solver, solution = port(cls).new(n, n, n * k)
    assert solver._cols.shape[0] == n * k
    assert solver._vals.shape[0] == n * k

    def build(shift):
        solver.init(n, n)
        for i in range(n):
            cols = sorted((i + j + shift) % n for j in range(k))
            solver.extend_from_values(i, cols, [1.0 + c for c in cols])

    build(0)
    bufs = (id(solver._cols), id(solver._vals), id(solver._jc),
            id(solver._iss))
    solve(solver, solution)
    assert solution.num_unassigned == 0
    build(1)
    assert bufs == (id(solver._cols), id(solver._vals), id(solver._jc),
                    id(solver._iss))
    solve(solver, solution)
    assert solution.num_unassigned == 0


@pytest.mark.parametrize("cls", SOLVERS)
def test_capacity_overflow_grows(cls):
    solver, solution = port(cls).new(2, 4, 1)
    solver.init(3, 4)
    for i in range(3):
        solver.extend_from_values(i, [0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0])
    assert solver.num_of_arcs() == 12
    solve(solver, solution)
    assert solution.num_unassigned == 0


def test_staged_cache_invalidated_by_value_mutation():
    """The staged-problem cache keys on ``_csr_version``: an edit through
    ``map_values`` restages, on the device route."""
    n = 16
    solver, solution = tpkg.KhoslaSolver.new(n, n, n * n)
    solver.init(n, n)
    rng = np.random.default_rng(5)
    costs = rng.integers(1, 50, size=(n, n)).astype(float)
    for i in range(n):
        solver.extend_from_values(i, list(range(n)), list(costs[i]))
    solve(solver, solution, engine="device", eps=1.0 / (n + 1))
    obj1 = solver.get_objective(solution)
    staged = solver._staged_problem[2]
    solver.map_values(lambda v: v * 2.0)
    solve(solver, solution, engine="device", eps=1.0 / (n + 1))
    assert solver._staged_problem[2] is not staged
    assert solver.get_objective(solution) == pytest.approx(2.0 * obj1,
                                                           rel=1e-6)


def test_staged_cache_keys_on_the_device(monkeypatch):
    """A solve on another device never reuses the staged tensors: the
    cache key holds the device."""
    from sparse_linear_assignment_tpu_torch.ops import padded

    built = []
    real = padded.build_padded_problem

    def spy(*args, **kwargs):
        built.append(str(kwargs["device"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(padded, "build_padded_problem", spy)
    n = 8
    solver, solution = tpkg.KhoslaSolver.new(n, n, n * n)
    tgen.gen_symmetric_input(solver, 3, n, 0.5, 1.0, 9.0)
    solve(solver, solution, engine="device")
    solve(solver, solution, engine="device")  # unchanged: reused
    assert built == ["cpu"]
    version, meta, problem = solver._staged_problem
    assert meta[-1] == "cpu"
    # as if the last solve had staged it on the card
    solver._staged_problem = (version, meta[:-1] + ("cuda:0",), problem)
    solve(solver, solution, engine="device")
    assert built == ["cpu", "cpu"]
    assert solver._staged_problem[1][-1] == "cpu"


def test_map_values_inplace_and_shape_guard():
    solver, _ = tpkg.KhoslaSolver.new(2, 2, 4)
    solver.init(2, 2)
    solver.extend_from_values(0, [0, 1], [1.5, 2.5])
    solver.extend_from_values(1, [0, 1], [3.5, 4.5])

    def floor_inplace(v):
        np.floor(v, out=v)

    solver.map_values(lambda v: floor_inplace(v))
    assert list(solver.values) == [1.0, 2.0, 3.0, 4.0]
    with pytest.raises(ValueError, match="shape"):
        solver.map_values(lambda v: 7.0)
    assert list(solver.values) == [1.0, 2.0, 3.0, 4.0]
    with pytest.raises(ValueError):
        solver.values[0] = 9.0  # the views are read-only


# ----------------------------------------------------------------------
# test_fixed_cases.py on the port, on both engines, against JAX
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cls", SOLVERS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_fixed_cases(cls, case, engine):
    maximize, costs, optimal_cost, optimal_p2os = CASES[case]
    solver, solution = port(cls).new(10, 10, 100)
    populate_dense(solver, costs)
    solve(solver, solution, maximize, engine=engine)
    assert solution.num_unassigned == 0
    assert solver.get_objective(solution) == optimal_cost
    p2o = tuple(int(x) for x in solution.person_to_object)
    assert p2o in optimal_p2os, p2o
    o2p = np.asarray(solution.object_to_person)
    for i, j in enumerate(p2o):
        assert o2p[j] == i
    assert int((o2p != M).sum()) == len(costs)

    jsolver, jsolution = getattr(jpkg, cls).new(10, 10, 100)
    populate_dense(jsolver, costs)
    jsolver.solve(jsolution, maximize, engine=engine)
    np.testing.assert_array_equal(solution.person_to_object,
                                  jsolution.person_to_object)
    np.testing.assert_array_equal(solver.prices, jsolver.prices)
    assert solver.nits == jsolver.nits


@pytest.mark.parametrize("engine", ["auto", "native", "device"])
@pytest.mark.parametrize("cls", SOLVERS)
def test_readme_example(cls, engine):
    weights = [[10, 6, 14, 1], [17, 18, 16]]
    solver, solution = port(cls).new(10, 10, 100)
    solver.init(2, 4)
    for i, row in enumerate(weights):
        solver.extend_from_values(i, list(range(len(row))),
                                  [float(v) for v in row])
    solve(solver, solution, False, engine=engine)
    assert solution.num_unassigned == 0
    assert solver.get_objective(solution) == 1.0 + 16.0
    assert list(solution.person_to_object) == [3, 2]
    assert list(solution.object_to_person) == [M, M, 1, 0]
    # the u16 view of the reference's index genericity
    small = solution.astype_index(np.uint16)
    assert list(small.object_to_person) == [65535, 65535, 1, 0]
    assert small.person_to_object.dtype == np.uint16


@pytest.mark.parametrize("cls", SOLVERS)
def test_solver_reuse_and_maximize_reflip(cls):
    costs = [[10, 10, 13], [4, 8, 8], [8, 5, 8]]
    solver, solution = port(cls).new(3, 3, 9)
    results = []
    for maximize in (False, True, False, True):
        populate_dense(solver, costs)
        solve(solver, solution, maximize)
        assert solution.num_unassigned == 0
        results.append(solver.get_objective(solution))
    assert results[0] == results[2] == 22.0
    assert results[1] == results[3] == 13.0 + 8.0 + 8.0


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cls", SOLVERS)
def test_negative_values_reference_quirk(cls, engine):
    """``test_options.py::test_negative_values_reference_quirk`` on the
    port: all-negative values meet the reference's ``values[0]`` sign
    heuristic (``solver.rs:111-115``, ``:214-216``), so ``maximize``
    picks the |cost|-largest matching and reports +12, ``minimize`` the
    |cost|-smallest and reports +5; and the JAX package's solver gives
    the same answers on the same input and engine."""
    costs = [[-5.0, -2.0], [-3.0, -7.0]]
    jax_solver, jax_solution = getattr(jpkg, cls).new(2, 2, 4)
    solver, solution = port(cls).new(2, 2, 4)
    for maximize, objective, matching in ((True, 12.0, [0, 1]),
                                          (False, 5.0, [1, 0])):
        for s in (solver, jax_solver):
            s.init(2, 2)
            for i, row in enumerate(costs):
                s.extend_from_values(i, [0, 1], row)
        solve(solver, solution, maximize, engine=engine)
        jax_solver.solve(jax_solution, maximize=maximize, engine=engine)
        assert solver.get_objective(solution) == objective
        assert list(solution.person_to_object) == matching
        assert (solver.get_objective(solution)
                == jax_solver.get_objective(jax_solution))
        np.testing.assert_array_equal(solution.person_to_object,
                                      jax_solution.person_to_object)
        np.testing.assert_array_equal(solution.object_to_person,
                                      jax_solution.object_to_person)


def test_solution_new_and_index_conventions():
    sol = tpkg.AuctionSolution.new(4, 4)
    jsol = jpkg.AuctionSolution.new(4, 4)
    assert sol.num_unassigned == jsol.num_unassigned == M
    assert np.isnan(sol.eps) and sol.person_to_object.size == 0
    assert tpkg.INDEX_DTYPE == jpkg.INDEX_DTYPE
    for dt in (np.int32, np.uint16, np.uint32):
        assert tpkg.unassigned_value(dt) == jpkg.unassigned_value(dt)
    full = tpkg.AuctionSolution(np.array([70000, M], np.int32),
                                np.array([M, 0], np.int32), 1, 0.5)
    with pytest.raises(ValueError, match="does not fit"):
        full.astype_index(np.uint16)


# ----------------------------------------------------------------------
# push_all_left (test_compact.py::TestPushAllLeft on the port)
# ----------------------------------------------------------------------
class TestPushAllLeft:
    def test_reference_case_u16(self):
        none = np.uint16(np.iinfo(np.uint16).max)
        arr = np.array([none, 1, 2, 3, none, none], dtype=np.uint16)
        mapper = np.array([none, 1, 2, 3], dtype=np.uint16)
        push_all_left(arr, mapper, 3, 3)
        np.testing.assert_array_equal(
            arr, np.array([3, 1, 2, none, none, none], dtype=np.uint16))
        assert mapper[3] == 0

    @pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.int32])
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_random_partition_equals_jax(self, dtype, seed):
        rng = np.random.default_rng(seed)
        size = int(rng.integers(1, 40))
        num = int(rng.integers(0, size + 1))
        sentinel = np.iinfo(dtype).max
        ids = rng.permutation(size)[:num]
        data = np.full(size, sentinel, dtype=dtype)
        pos = rng.permutation(size)[:num]
        data[pos] = ids
        mapper = np.full(size, sentinel, dtype=dtype)
        mapper[ids] = pos
        jdata, jmapper = data.copy(), mapper.copy()
        push_all_left(data, mapper, num, size)
        jax_push(jdata, jmapper, num, size)
        np.testing.assert_array_equal(data, jdata)
        np.testing.assert_array_equal(mapper, jmapper)
        assert set(int(x) for x in data[:num]) == set(int(x) for x in ids)
        assert all(int(x) == sentinel for x in data[num:])
        for j in range(num):
            assert int(mapper[int(data[j])]) == j

    def test_validation(self):
        with pytest.raises(ValueError):
            push_all_left(np.zeros(4, np.uint16), np.zeros(4, np.uint32),
                          1, 4)
        with pytest.raises(ValueError):
            push_all_left(np.zeros(4, np.float32), np.zeros(4, np.float32),
                          1, 4)
        with pytest.raises(ValueError):
            push_all_left(np.zeros((2, 2), np.int32),
                          np.zeros((2, 2), np.int32), 1, 4)


# ----------------------------------------------------------------------
# the same seeds give the same instances and evaluators in both packages
# ----------------------------------------------------------------------
GENERATED = [
    ("gen_symmetric_input", (3, 40, 0.12, 500.0, 1000.0)),
    ("gen_symmetric_input", (42, 5000, 5.0 / 5000, 0.0, 10.0)),
    ("gen_asymmetric_input", (7, 30, 200, 8, 300.0, 700.0)),
    ("gen_ksparse_uniform", (5, 20, 90, 6, 10.0)),
]


@pytest.mark.parametrize("gen,args", GENERATED)
def test_generators_and_evaluators_equal_jax(gen, args):
    ts, tsol = tpkg.KhoslaSolver.new(1, 1, 1)
    js, jsol = jpkg.KhoslaSolver.new(1, 1, 1)
    getattr(tgen, gen)(ts, *args)
    getattr(jgen, gen)(js, *args)
    for name in ("i_starts_stops", "j_counts", "column_indices", "values"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
        assert getattr(ts, name).dtype == getattr(js, name).dtype
    assert (ts.num_rows, ts.num_cols) == (js.num_rows, js.num_cols)
    np.testing.assert_array_equal(tgen.dense_cost_matrix(ts, big=1e6),
                                  jgen.dense_cost_matrix(js, big=1e6))

    solve(ts, tsol)
    js.solve(jsol, False)
    np.testing.assert_array_equal(tsol.person_to_object,
                                  jsol.person_to_object)
    assert ts.get_objective(tsol) == js.get_objective(jsol)
    # the flipped values densify back to the caller's units
    np.testing.assert_array_equal(
        tgen.dense_cost_matrix(ts, big=1e9, original_units=True),
        jgen.dense_cost_matrix(js, big=1e9, original_units=True))
    if tsol.num_unassigned == 0:
        for eps in (tsol.eps, 0.0):
            assert ts.ecs_satisfied(tsol.person_to_object, eps, 1e-9) \
                == js.ecs_satisfied(jsol.person_to_object, eps, 1e-9)
        assert ts.ecs_satisfied(tsol.person_to_object, tsol.eps, 1e-9)


def test_ecs_satisfied_rejects_partial_assignments():
    ts, tsol = tpkg.KhoslaSolver.new(2, 2, 2)
    ts.init(2, 2)
    ts.add_value(0, 0, 1.0)
    ts.add_value(1, 0, 2.0)
    solve(ts, tsol)
    assert tsol.num_unassigned == 1
    with pytest.raises(ValueError, match="full assignment"):
        ts.ecs_satisfied(tsol.person_to_object, tsol.eps, 0.0)


def test_gen_symmetric_value_seed_decouples_structure():
    a, _ = tpkg.KhoslaSolver.new(64, 64, 4096)
    tgen.gen_symmetric_input(a, 3, 64, 0.1, 1.0, 9.0)
    b, _ = tpkg.KhoslaSolver.new(64, 64, 4096)
    tgen.gen_symmetric_input(b, 3, 64, 0.1, 1.0, 9.0, value_seed=777)
    assert list(a.column_indices) == list(b.column_indices)
    assert list(a.j_counts) == list(b.j_counts)
    assert not np.allclose(a.values, b.values)
    c, _ = tpkg.KhoslaSolver.new(64, 64, 4096)
    tgen.gen_symmetric_input(c, 3, 64, 0.1, 1.0, 9.0, value_seed=3)
    np.testing.assert_array_equal(a.values, c.values)


@pytest.mark.parametrize("module", ["ksparse", "symmetric"])
def test_docstring_examples(module):
    """The README example in each solver module's docstring runs as a
    doctest (the native route: no device needed)."""
    import doctest
    import importlib

    mod = importlib.import_module(
        f"sparse_linear_assignment_tpu_torch.{module}")
    result = doctest.testmod(mod)
    assert result.attempted > 0
    assert result.failed == 0
