"""The port's sharded single-instance modes against the JAX package's.

The port runs on worlds of 1, 2 and 4 gloo ranks (``parallel/dryrun.
RankPool``: one world of 4 for the module, whose first ranks' subgroups
are the worlds of 1 and 2), the JAX package on its virtual CPU mesh of
the same size.  Inputs come from NumPy seeds and
go through both.  Every collective of these modes is exact, so the
tolerance is 0: ``person_to_object``, ``object_to_person``, prices and
``nits`` bit-equal, objectives equal; every rank returns the same
result.  scipy is the oracle of the optimum.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh
from scipy.optimize import linear_sum_assignment

import sparse_linear_assignment_tpu as jslap
import sparse_linear_assignment_tpu.generators  # noqa: F401
import sparse_linear_assignment_tpu.parallel as jpar
import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch.parallel import dryrun, sharded

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_single")
    made = dryrun.RankPool(4, str(root / "store"), sizes=(1, 2))
    yield made
    made.close()


def run_ranks(pool, d, fn, *args, **kwargs):
    """``fn`` with ``device="cpu"`` on a world of ``d`` ranks: the whole
    pool, or the subgroup of its first ``d`` ranks.  The pool checks
    that the ranks agree bit for bit."""
    return pool.run(fn, *args, size=None if d == pool.world else d,
                    device="cpu", **kwargs)


def make_mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("shard",))


def ksparse_pair(cls_name, n, m, k, seed, max_value=10.0):
    """The same k-sparse instance in both packages' solvers."""
    jsolver, _ = getattr(jslap, cls_name).new(n, m, n * k)
    jslap.generators.gen_ksparse_uniform(jsolver, seed, n, m, k,
                                         max_value=max_value)
    psolver, _ = getattr(port, cls_name).new(n, m, n * k)
    port.generators.gen_ksparse_uniform(psolver, seed, n, m, k,
                                        max_value=max_value)
    np.testing.assert_array_equal(psolver.values, jsolver.values)
    return jsolver, psolver


def dense_pair(cls_name, costs):
    n = costs.shape[0]
    out = []
    for pkg in (jslap, port):
        solver, _ = getattr(pkg, cls_name).new(n, n, n * n)
        solver.init(n, n)
        for i in range(n):
            solver.extend_from_values(i, range(n), costs[i])
        out.append(solver)
    return out


def assert_solver_solves_equal(got: dict, jsolver, jres):
    """The port's ``run_solver`` dict against the JAX solve
    ``(solution, nits)`` on ``jsolver``: tolerance 0."""
    jsol, jnits = jres
    sol = got["solution"]
    np.testing.assert_array_equal(sol.person_to_object,
                                  jsol.person_to_object)
    np.testing.assert_array_equal(sol.object_to_person,
                                  jsol.object_to_person)
    np.testing.assert_array_equal(got["prices"], jsolver.prices)
    assert got["nits"] == jnits
    assert sol.num_unassigned == jsol.num_unassigned
    assert sol.eps == jsol.eps
    assert got["objective"] == jsolver.get_objective(jsol)


def scipy_sparse_optimum(solver):
    mat = jslap.generators.dense_cost_matrix(solver, big=1e9,
                                             original_units=True)
    r, c = linear_sum_assignment(mat)
    return float(mat[r, c].sum())


def forward_costs():
    return np.random.default_rng(11).integers(1, 100, size=(32, 32)).astype(
        np.float64)


def fr_dense_costs():
    """42 is a multiple of 2 but not of 4: padded rows at d = 4."""
    return np.random.default_rng(21).integers(1, 300, size=(42, 42)).astype(
        np.float64)


KHOSLA = ("KhoslaSolver", 96, 200, 8, 9)

#: the port's call of each case that runs at several world sizes
CASES = {
    "khosla": lambda: (dryrun.run_solver, (sharded.solve_sharded_khosla,
                                           ksparse_pair(*KHOSLA)[1]), {}),
    "forward": lambda: (dryrun.run_solver, (
        sharded.solve_sharded_forward,
        dense_pair("ForwardAuctionSolver", forward_costs())[1]), {}),
    "fr_dense": lambda: (sharded.solve_fr_dense_sharded, (fr_dense_costs(),),
                         {"chunk": 16}),
}

#: the port's result of each case by world size, computed once: the tests
#: against JAX fill it, the d = 1 against d = N test reads it
RESULTS = {}


def port_case(pool, case, d):
    """The port's result of ``CASES[case]`` on a world of ``d`` ranks."""
    if (case, d) not in RESULTS:
        fn, args, kwargs = CASES[case]()
        RESULTS[case, d] = run_ranks(pool, d, fn, *args, **kwargs)
    return RESULTS[case, d]


# ----------------------------------------------------------------------
# sharded Khosla
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", WORLDS)
def test_sharded_khosla_matches_jax(pool, d):
    jsolver, _ = ksparse_pair(*KHOSLA)
    jres = jpar.solve_sharded_khosla(jsolver, make_mesh(d))
    got = port_case(pool, "khosla", d)
    assert_solver_solves_equal(got, jsolver, jres)
    sol = got["solution"]
    assert sol.num_unassigned == 0 and got["nits"] > 0
    want = scipy_sparse_optimum(jsolver)
    assert want - 1e-9 <= got["objective"] <= want + 96 * sol.eps + 1e-9
    for i, j in enumerate(sol.person_to_object):
        assert sol.object_to_person[j] == i


@pytest.mark.parametrize("d", (4,))
def test_sharded_khosla_padding_sizes(pool, d):
    # sizes that do NOT divide the world: padding persons start dropped
    jsolver, psolver = ksparse_pair("KhoslaSolver", 13, 29, 4, 5)
    jres = jpar.solve_sharded_khosla(jsolver, make_mesh(d))
    got = run_ranks(pool, d, dryrun.run_solver,
                    sharded.solve_sharded_khosla, psolver)
    assert_solver_solves_equal(got, jsolver, jres)
    sol = got["solution"]
    assert len(sol.person_to_object) == 13
    assert len(sol.object_to_person) == 29
    assert sol.num_unassigned == 0


# ----------------------------------------------------------------------
# sharded ε-scaling forward auction
# ----------------------------------------------------------------------
def assert_forward_flags_equal(got, jsolver):
    assert got["nreductions"] == jsolver.nreductions
    assert got["optimal_soln_found"] == jsolver.optimal_soln_found


@pytest.mark.parametrize("d", WORLDS)
def test_sharded_forward_symmetric(pool, d):
    costs = forward_costs()
    jsolver, _ = dense_pair("ForwardAuctionSolver", costs)
    jres = jpar.solve_sharded_forward(jsolver, make_mesh(d))
    got = port_case(pool, "forward", d)
    assert_solver_solves_equal(got, jsolver, jres)
    assert_forward_flags_equal(got, jsolver)
    sol = got["solution"]
    assert sol.num_unassigned == 0 and got["optimal_soln_found"]
    # integer costs and eps-scaling to eps < 1/n: the exact optimum
    r, c = linear_sum_assignment(costs)
    assert got["objective"] == costs[r, c].sum()


@pytest.mark.parametrize("d", (4,))
def test_sharded_forward_asymmetric_and_padding(pool, d):
    # asymmetric (scaling disabled, `symmetric.rs:256-267`), sizes that
    # do NOT divide the world
    jsolver, psolver = ksparse_pair("ForwardAuctionSolver", 13, 29, 5, 6)
    jres = jpar.solve_sharded_forward(jsolver, make_mesh(d))
    got = run_ranks(pool, d, dryrun.run_solver,
                    sharded.solve_sharded_forward, psolver)
    assert_solver_solves_equal(got, jsolver, jres)
    assert_forward_flags_equal(got, jsolver)
    sol = got["solution"]
    assert len(sol.person_to_object) == 13
    assert len(sol.object_to_person) == 29
    assert sol.num_unassigned == 0
    want = scipy_sparse_optimum(jsolver)
    assert want - 1e-9 <= got["objective"] <= want + 13 * sol.eps + 1e-9


def test_sharded_forward_matches_single_device_objective(pool):
    costs = forward_costs()
    n = costs.shape[0]
    single, solution = port.ForwardAuctionSolver.new(n, n, n * n)
    single.init(n, n)
    for i in range(n):
        single.extend_from_values(i, range(n), costs[i])
    single.solve(solution, maximize=False)
    jsolver, _ = dense_pair("ForwardAuctionSolver", costs)
    jres = jpar.solve_sharded_forward(jsolver, make_mesh(2))
    got = port_case(pool, "forward", 2)
    assert_solver_solves_equal(got, jsolver, jres)
    # both reach the exact optimum on integer costs
    assert got["objective"] == single.get_objective(solution)


@pytest.mark.parametrize("d", (2,))
def test_sharded_forward_infeasibility_certificate(pool, d):
    """Two persons sharing one object: the price bound stops the solve
    long before max_iterations."""
    solvers = []
    for pkg in (jslap, port):
        solver, _ = pkg.ForwardAuctionSolver.new(2, 2, 2)
        solver.init(2, 2)
        solver.add_value(0, 0, 1.0)
        solver.add_value(1, 0, 2.0)
        solvers.append(solver)
    jsolver, psolver = solvers
    jres = jpar.solve_sharded_forward(jsolver, make_mesh(d))
    got = run_ranks(pool, d, dryrun.run_solver,
                    sharded.solve_sharded_forward, psolver)
    assert_solver_solves_equal(got, jsolver, jres)
    assert_forward_flags_equal(got, jsolver)
    assert got["solution"].num_unassigned >= 1
    assert not got["optimal_soln_found"]
    assert got["nits"] < 10_000


# ----------------------------------------------------------------------
# sharded single-instance dense forward-reverse auction
# ----------------------------------------------------------------------
def assert_fr_dense_equal(got, want):
    p2o, o2p, unassigned, nits, objective = got
    np.testing.assert_array_equal(p2o, want[0])
    np.testing.assert_array_equal(o2p, want[1])
    assert (unassigned, nits, objective) == tuple(want[2:])


def fr_dense_case(pool, d):
    """The dense FR single at world ``d`` against JAX's on a mesh of
    ``d`` and scipy's optimum; returns the port's result and the
    costs."""
    costs = fr_dense_costs()
    want = jpar.solve_fr_dense_sharded(costs, make_mesh(d), chunk=16)
    got = port_case(pool, "fr_dense", d)
    assert_fr_dense_equal(got, want)
    assert got[2] == 0
    r, c = linear_sum_assignment(costs)
    assert got[4] == costs[r, c].sum()  # integer costs: exact optimum
    return got, costs


@pytest.mark.parametrize("d", (1, 2))
def test_sharded_fr_dense_matches_jax_and_rounds(pool, d):
    """Bit-identical to JAX's sharded solve and to the port's own
    single-device plain rounds (``ops/fr_dense.fr_round``)."""
    import torch

    from sparse_linear_assignment_tpu_torch.ops.fr_dense import (
        fr_init,
        fr_round,
    )

    got, costs = fr_dense_case(pool, d)
    p2o, o2p, unassigned, nits, objective = got
    n = costs.shape[0]

    vals_t = torch.from_numpy(-costs.T.astype(np.float32))[None]
    state = fr_init(vals_t, np.float32(1.0 / (n + 1)))
    for _ in range(nits):
        state = fr_round(vals_t, state, 0.0, 0.0, 10**9,
                         skip_certificate=True)
    np.testing.assert_array_equal(p2o, state.p2o[0].numpy())
    assert bool(state.done[0]) and int(state.nits[0]) == nits
    for i, j in enumerate(p2o):
        assert o2p[j] == i


@pytest.mark.parametrize("d", (4,))
def test_sharded_fr_dense_padding(pool, d):
    """Object count not a multiple of the world (padded -inf rows); the
    world of 4 of the same instance as the test above."""
    got, _ = fr_dense_case(pool, d)
    assert sorted(got[0]) == list(range(42))


def test_sharded_fr_dense_rejects_rectangular(pool):
    with pytest.raises(ValueError, match="square"):
        run_ranks(pool, 2, sharded.solve_fr_dense_sharded, np.ones((3, 4)))


# ----------------------------------------------------------------------
# d = 1 against d = N, and the collective audit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_d1_vs_dN_bit_identical(pool, case):
    """Each single-instance engine gives the same bits on worlds of 1
    and 4 ranks (the batch-sharded engines:
    ``test_torch_sharded_batch.py``)."""
    assert dryrun.same(port_case(pool, case, 1), port_case(pool, case, 4))


@pytest.mark.parametrize("d", WORLDS)
def test_collective_count_audit(pool, d):
    """The per-round and per-chunk collective counts of every mode,
    read from ``collectives.COUNTS``, equal the audit table of
    ``parallel/sharded.py`` (the JAX module's, ``sharded.py:36-46``)."""
    audit = run_ranks(pool, d, dryrun.collective_audit)
    assert dryrun.audit_matches(audit), audit


def test_collectives_two_ranks(pool):
    """Rank-dependent inputs through every collective on two gloo ranks:
    gathers in rank order, exact reductions, bool kept, each call
    counted (tolerance 0).  ``collectives_probe`` checks the world-size
    formulas itself; these are the values written out."""
    got = run_ranks(pool, 2, dryrun.collectives_probe)
    np.testing.assert_array_equal(got["gather"], [0, 0, 10, 1, -1, 11])
    np.testing.assert_array_equal(got["gather_bool"], [False, True])
    np.testing.assert_array_equal(got["max"], [1, 0, 11])
    np.testing.assert_array_equal(got["min"], [0, -1, 10])
    np.testing.assert_array_equal(got["sum"], [1, -1, 21])
    np.testing.assert_array_equal(got["any"], [True])
    np.testing.assert_array_equal(got["parts"][0], [0, 0, 1, -1])
    np.testing.assert_array_equal(got["parts"][1],
                                  [[0, 0], [0, 0], [1, 1], [1, 1]])
    np.testing.assert_array_equal(got["parts"][2], [False, True])
    assert got["counts"] == {"all_gather": 3, "max": 2, "min": 1, "sum": 1}


def test_audit_table_is_jax_traced_count():
    """The table the port is held to is what JAX's traced programs
    count (``experiments/exp_collective_audit.py``), by total a round
    and a chunk."""
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, "experiments")
    try:
        import exp_collective_audit as audit
    finally:
        sys.path.pop(0)
    S = jax.ShapeDtypeStruct
    mesh = make_mesh(4)
    f8 = jnp.float64
    K, N, M, Kc = 2, 16, 16, 4
    khosla = (S((K, N), jnp.int32), S((K, N), f8), S((K, N), jnp.bool_),
              S((Kc, M), jnp.int32), S((Kc, M), jnp.bool_),
              S((M,), f8), S((N,), jnp.int32), S((M,), jnp.int32),
              S((N,), jnp.bool_), S((), jnp.int32), S((), f8), S((), f8))
    forward = khosla[:5] + (
        S((N,), jnp.bool_), S((M,), f8), S((N,), jnp.int32),
        S((M,), jnp.int32), S((), f8), S((), jnp.int32), S((), jnp.int32),
        S((), jnp.bool_), S((), jnp.bool_), S((), f8), S((), f8),
        S((), jnp.bool_), S((), jnp.int32), S((), f8),
    )
    fr = (S((N, N), jnp.float32), S((N,), jnp.float32), S((N,), jnp.int32),
          S((N,), jnp.float32), S((N,), jnp.int32), S((), jnp.bool_),
          S((), jnp.bool_), S((), jnp.int32), S((), jnp.int32),
          S((), jnp.int32), S((), jnp.float32))

    def total(counts):
        return sum(counts.values())

    for core, args, mode in (
        (jpar.sharded_khosla_core(mesh, chunk=4), khosla, "khosla"),
        (jpar.sharded_forward_core(mesh, chunk=4), forward, "forward"),
    ):
        per_round, per_chunk = audit.count_collectives(
            jax.make_jaxpr(core)(*args))
        want_round, want_chunk = dryrun.AUDIT_TABLE[mode]
        assert total(per_round) == total(want_round), mode
        assert total(per_chunk) == total(want_chunk), mode
    per_round, _ = audit.count_collectives(jax.make_jaxpr(
        jpar.sharded_fr_dense_core(mesh, chunk=4))(*fr))
    assert total(per_round) == total(dryrun.FR_DENSE_TABLE)
