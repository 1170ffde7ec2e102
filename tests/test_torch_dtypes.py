"""Every entry point of the port against the JAX package across the cost
dtypes, on the CPU.

The same NumPy inputs, made from a seed, go through the JAX function and
the port's with ``device="cpu"``.  Twelve cost dtypes, from ``bool`` to
``uint64`` and the three float types, hold random costs in [0, 100) with
at least one 0; each integer type also has cases on the forward and
Khosla engines that hold the type's minimum and maximum (run at
``max_iterations=50``: uncapped, some run to the default cap of 100,000
rounds on both packages).  The other
``solve_batch`` cases run under a cap of 500 rounds, where the
feasible ones need at most a few hundred: unsigned costs with
``maximize=False`` stall the float32 eps ladder of the forward engine
in both packages (reference behaviour, pinned below), and would run to
the default cap too.

Tolerance 0 on every field both packages return: ``person_to_object``,
``object_to_person``, ``num_unassigned``, ``nits``, ``objective`` and
``eps`` of a ``BatchSolution``; the matching, ``eps``, prices, ``nits``,
the objective and the eps-CS certificate of the single solvers.  Where
the JAX package raises, the port must raise an exception of the same
type (bool costs with ``maximize=False`` on the dense engines: numpy
has no boolean negative).
"""

import jax
import numpy as np
import pytest
import scipy.sparse
import torch
from jax.sharding import Mesh

from scipy.optimize import linear_sum_assignment as scipy_lsa

import sparse_linear_assignment_tpu as jslap
import sparse_linear_assignment_tpu.batch as jbatch
import sparse_linear_assignment_tpu.parallel as jpar
import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch import batch as tbatch
from sparse_linear_assignment_tpu_torch.parallel import dryrun, sharded

torch.set_num_threads(1)

DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
          "uint32", "uint64", "float16", "float32", "float64")
INTEGERS = tuple(d for d in DTYPES if np.dtype(d).kind in "iu")
SENSES = {"min": False, "max": True}
SOLVERS = ("fr", "forward", "khosla")


def random_costs(dtype, shape, seed):
    """Integers in [0, 100), one of them 0, cast to ``dtype``."""
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 100, size=shape)
    costs.reshape(-1)[rng.integers(costs.size)] = 0
    return costs.astype(dtype)


def extreme_costs(dtype, shape, seed):
    """Integers over the whole range of ``dtype``, its minimum and its
    maximum among them in every instance."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(seed)
    costs = rng.integers(info.min, info.max, size=shape, dtype=dtype,
                         endpoint=True)
    costs[..., 0, 0] = info.min
    costs[..., -1, -1] = info.max
    return costs


def outcome(fn):
    """``("ok", result)``, or ``("raised", exception type)``."""
    try:
        return "ok", fn()
    except Exception as exc:  # noqa: BLE001 - the type is compared
        return "raised", type(exc)


def assert_same_outcome(got, want, compare):
    """The port's outcome against JAX's: the same exception type, or
    results that ``compare`` holds equal."""
    assert got[0] == want[0], (got, want)
    if want[0] == "raised":
        assert got[1] is want[1]
    else:
        compare(got[1], want[1])


BATCH_FIELDS = ("person_to_object", "object_to_person", "num_unassigned",
                "nits", "objective", "eps")


def assert_batch_equal(got, want):
    for field in BATCH_FIELDS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


# ----------------------------------------------------------------------
# solve_batch
# ----------------------------------------------------------------------
#: the round cap of the sweep's ``solve_batch`` cases
CAP = 500

#: one variant of the square float32 default each: the shape and eps,
#: the solve's float type or the round cap, and the solvers it runs.
#: At these shapes the FR engine reads the costs only through their cast
#: to the solve's type (its integer lattice needs N % 128 == 0), so its
#: float64 and round-cap variants would see nothing of the cost dtype
#: that its square case does not.
VARIANTS = {
    "square": (dict(shape=(2, 7, 7)), SOLVERS),
    "rect-eps": (dict(shape=(2, 4, 9), eps=0.5), SOLVERS),
    "f64": (dict(shape=(2, 7, 7), dtype=np.float64), ("forward", "khosla")),
    "cap3": (dict(shape=(2, 7, 7), max_iterations=3), ("forward", "khosla")),
}
SOLVE_BATCH_CASES = [
    (dtype, solver, sense, variant)
    for dtype in DTYPES for variant, (_, solvers) in VARIANTS.items()
    for solver in solvers for sense in SENSES
]


def solve_both(costs, **kw):
    want = outcome(lambda: jslap.solve_batch(costs, **kw))
    got = outcome(lambda: port.solve_batch(costs, device="cpu", **kw))
    assert_same_outcome(got, want, assert_batch_equal)
    return got


@pytest.mark.parametrize("dtype,solver,sense,variant", SOLVE_BATCH_CASES)
def test_solve_batch(dtype, solver, sense, variant):
    kw = {"max_iterations": CAP, **VARIANTS[variant][0]}
    costs = random_costs(dtype, kw.pop("shape"), DTYPES.index(dtype))
    solve_both(costs, solver=solver, maximize=SENSES[sense], **kw)


@pytest.mark.parametrize("sense", SENSES)
@pytest.mark.parametrize("solver", ("forward", "khosla"))
@pytest.mark.parametrize("dtype", INTEGERS)
def test_solve_batch_integer_extremes(dtype, solver, sense):
    """The host parameters at the integer types' extremes (FR at 7²
    reads the costs only through their cast, which ``test_solve_batch``
    covers)."""
    costs = extreme_costs(dtype, (2, 7, 7), INTEGERS.index(dtype))
    solve_both(costs, solver=solver, maximize=SENSES[sense],
               max_iterations=50)


def test_solve_batch_uint32_forward_maximize():
    """The forward engine's start eps and toleration come from
    ``C = max |cost|`` of ``costs if maximize else -costs``.  Taken as
    ``max(max, -min)`` of the unsigned costs themselves, ``-min`` wraps
    to nearly 2^32, and a start eps that large stalls the float32 eps
    ladder: the first instance ended at the round cap with two persons
    unassigned, where JAX is at scipy's optimum in 13 rounds."""
    costs = np.random.default_rng(1).integers(0, 100, (3, 7, 7)).astype(
        np.uint32)
    got = solve_both(costs, maximize=True, solver="forward")[1]
    np.testing.assert_array_equal(got.num_unassigned, [0, 0, 0])
    np.testing.assert_array_equal(got.nits, [13, 11, 7])
    np.testing.assert_array_equal(got.objective, [621, 595, 628])


@pytest.mark.parametrize("dtype", ("uint32", "uint64"))
def test_solve_batch_unsigned_minimize_forward_keeps_jaxs_stall(dtype):
    """Reference behaviour: with ``maximize=False`` the JAX package takes
    C from ``-costs``, which wraps on unsigned costs to about 2^32 or
    2^64; the float32 eps ladder then stalls, and feasible instances end
    at the round cap with persons unassigned.  The port gives the same
    answer, bit for bit."""
    costs = random_costs(dtype, (2, 7, 7), DTYPES.index(dtype))
    got = solve_both(costs, solver="forward", max_iterations=CAP)[1]
    assert got.num_unassigned.sum() > 0
    assert got.nits.max() == CAP


@pytest.mark.parametrize("dtype", ("int8", "int16"))
def test_solve_batch_khosla_span_of_the_signed_minimum(dtype):
    """The Khosla drop rule's threshold ``(M/2)(span + eps)`` takes the
    span of ``-costs`` with ``maximize=False``, where the type's minimum
    negates to itself: a span of about 50 here.  The span of the costs
    themselves wraps to a negative number, a negative threshold that
    dropped every person of a feasible instance in the first round."""
    info = np.iinfo(dtype)
    costs = np.random.default_rng(3).integers(
        info.max - 50, info.max, (1, 5, 5), endpoint=True, dtype=dtype)
    costs[0, 1, 1] = info.min
    got = solve_both(costs, solver="khosla")[1]
    np.testing.assert_array_equal(got.num_unassigned, [0])
    rows, cols = scipy_lsa(costs[0].astype(np.float64))
    assert got.objective[0] == costs[0].astype(np.float64)[rows, cols].sum()


@pytest.mark.parametrize("sense", SENSES)
def test_solve_batch_khosla_int8_full_range_drops_everyone(sense):
    """Reference behaviour: int8 costs holding -128 and 127 give a span
    of 255, which wraps to -1 in int8 in both senses; the drop threshold
    ``(M/2)(-1 + eps)`` is negative, and the first round drops every
    person of these feasible instances, in both packages."""
    costs = random_costs("int64", (2, 7, 7), 0) * 2 - 100
    costs[:, 0, 0], costs[:, 1, 1] = -128, 127
    got = solve_both(costs.astype(np.int8), solver="khosla",
                     maximize=SENSES[sense])[1]
    np.testing.assert_array_equal(got.num_unassigned, [7, 7])
    np.testing.assert_array_equal(got.nits, [1, 1])


# ----------------------------------------------------------------------
# the FR engine's integer lattice
# ----------------------------------------------------------------------
@pytest.mark.parametrize("low", (0, 1))
@pytest.mark.parametrize("dtype", DTYPES)
def test_integer_scale(dtype, low):
    """The lattice scale of a 128-square batch (``None``: the float
    path), or the exception, equal to JAX's: ``max(max, -min)`` with
    JAX's wraps.  Reference behaviour: an unsigned minimum other than 0
    negates to nearly 2^16, 2^32 or 2^64, so such costs stay off the
    lattice from ``uint16`` up; bool costs raise numpy's ``TypeError``."""
    costs = np.random.default_rng(0).integers(low, 100, (1, 128, 128)).astype(
        dtype)
    args = (costs, None, 128, 128, None, None)
    want = outcome(lambda: jbatch._integer_scale(*args))
    got = outcome(lambda: tbatch._integer_scale(*args))
    assert got == want
    if dtype == "bool":
        assert want == ("raised", TypeError)
    elif low == 1 and dtype in ("uint16", "uint32", "uint64"):
        assert want == ("ok", None)
    else:
        assert want == ("ok", 129)


# ----------------------------------------------------------------------
# linear_sum_assignment
# ----------------------------------------------------------------------
#: a tall matrix is solved as its transpose, the wide case, in both
#: packages, so the dtype sees nothing there that the wide case does not
LSA_SHAPES = {"square": (7, 7), "wide": (4, 9)}


def assert_pairs_equal(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", LSA_SHAPES)
@pytest.mark.parametrize("sense", SENSES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_sum_assignment(dtype, sense, shape):
    costs = random_costs(dtype, LSA_SHAPES[shape], DTYPES.index(dtype))
    maximize = SENSES[sense]
    want = outcome(lambda: jslap.linear_sum_assignment(costs, maximize))
    got = outcome(lambda: port.linear_sum_assignment(costs, maximize,
                                                     device="cpu"))
    assert_same_outcome(got, want, assert_pairs_equal)


# ----------------------------------------------------------------------
# the batched sparse mode
# ----------------------------------------------------------------------
SPARSE_M = 16


def sparse_arcs(dtype, seed, b=3, n=6, k=4):
    """``columns [B, N, K]`` (person i's arcs include column i, so every
    instance is feasible) and values of ``dtype``."""
    rng = np.random.default_rng(seed)
    columns = np.empty((b, n, k), dtype=np.int32)
    for g in range(b):
        for i in range(n):
            others = rng.choice(np.delete(np.arange(SPARSE_M), i), k - 1,
                                replace=False)
            columns[g, i] = np.concatenate([[i], others])
    return columns, random_costs(dtype, (b, n, k), seed)


#: the JAX engine that serves the port's request: the port's ``"auto"``
#: takes the dense plane wherever it fits, on either device, as JAX's
#: does on an accelerator; on its CPU backend JAX's takes the padded
#: engine (ROADMAP.md, "CPU routing")
JAX_ENGINE = {"auto": "dense", "padded": "padded"}


@pytest.mark.parametrize("engine", JAX_ENGINE)
@pytest.mark.parametrize("sense", SENSES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_batch_sparse(dtype, sense, engine):
    columns, values = sparse_arcs(dtype, DTYPES.index(dtype))
    maximize = SENSES[sense]
    want = outcome(lambda: jslap.solve_batch_sparse(
        columns, values, SPARSE_M, maximize, engine=JAX_ENGINE[engine]))
    got = outcome(lambda: port.solve_batch_sparse(
        columns, values, SPARSE_M, maximize, engine=engine, device="cpu"))
    assert_same_outcome(got, want, assert_batch_equal)


@pytest.mark.parametrize("sense", SENSES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_stage_batch_sparse_stream(dtype, sense):
    batches = [sparse_arcs(dtype, 100 + s) for s in range(2)]
    maximize = SENSES[sense]

    def run(pkg, **kw):
        staged = [pkg.stage_batch_sparse(c, v, SPARSE_M, maximize, **kw)
                  for c, v in batches]
        return pkg.solve_batch_sparse_stream(staged)

    def compare(got, want):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert_batch_equal(a, b)

    assert_same_outcome(outcome(lambda: run(port, device="cpu")),
                        outcome(lambda: run(jslap)), compare)


# ----------------------------------------------------------------------
# the reference API: KhoslaSolver and ForwardAuctionSolver
# ----------------------------------------------------------------------
SOLVER_N = 6


def build_add_value(solver, columns, values):
    for i in range(SOLVER_N):
        for j, v in zip(columns[i], values[i]):
            solver.add_value(i, int(j), v)


def build_extend_from_values(solver, columns, values):
    for i in range(SOLVER_N):
        solver.extend_from_values(i, columns[i], values[i])


def build_extend_from_scipy_csr(solver, columns, values):
    rows = np.repeat(np.arange(SOLVER_N), columns.shape[1])
    solver.extend_from_scipy_csr(scipy.sparse.csr_matrix(
        (values.reshape(-1), (rows, columns.reshape(-1))),
        shape=(SOLVER_N, SOLVER_N)))


BUILDERS = {"add_value": build_add_value,
            "extend_from_values": build_extend_from_values,
            "extend_from_scipy_csr": build_extend_from_scipy_csr}


def reference_solve(pkg, cls, builder, columns, values, maximize, **kw):
    solver, solution = getattr(pkg, cls).new(SOLVER_N, SOLVER_N,
                                             columns.size)
    solver.init(SOLVER_N, SOLVER_N)
    BUILDERS[builder](solver, columns, values)
    solver.solve(solution, maximize, **kw)
    out = {
        "p2o": np.asarray(solution.person_to_object),
        "o2p": np.asarray(solution.object_to_person),
        "num_unassigned": solution.num_unassigned, "eps": solution.eps,
        "prices": np.asarray(solver.prices), "nits": solver.nits,
        "objective": solver.get_objective(solution),
    }
    if solution.num_unassigned == 0:
        tol = solver.get_toleration(float(np.abs(solver.values).max()))
        out["ecs_satisfied"] = solver.ecs_satisfied(
            solution.person_to_object, solution.eps, tol)
    return out


def assert_dicts_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("sense", SENSES)
@pytest.mark.parametrize("dtype", ("bool",) + INTEGERS)
@pytest.mark.parametrize("builder", BUILDERS)
@pytest.mark.parametrize("cls", ("KhoslaSolver", "ForwardAuctionSolver"))
def test_reference_solvers(cls, builder, dtype, sense):
    seed = DTYPES.index(dtype)
    rng = np.random.default_rng(seed)
    # a full row of arcs each: every row has several, so the auto route
    # of both packages takes the native engine
    columns = np.stack([rng.permutation(SOLVER_N)
                        for _ in range(SOLVER_N)]).astype(np.int32)
    values = random_costs(dtype, columns.shape, seed)
    args = (cls, builder, columns, values, SENSES[sense])
    want = outcome(lambda: reference_solve(jslap, *args))
    got = outcome(lambda: reference_solve(port, *args, device="cpu"))
    assert_same_outcome(got, want, assert_dicts_equal)


# ----------------------------------------------------------------------
# the sharded dense forward-reverse single, a world of one gloo rank
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    made = dryrun.RankPool(1, str(tmp_path_factory.mktemp("dtypes")
                                  / "store"))
    yield made
    made.close()


def assert_tuples_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def sharded_both(pool, costs, maximize):
    """JAX's sharded dense FR single on a mesh of one CPU device and the
    port's on one gloo rank, capped at 100 rounds (these instances need
    at most 30)."""
    mesh = Mesh(np.array(jax.devices()[:1]), ("shard",))
    kw = dict(maximize=maximize, max_iterations=100, chunk=16)
    want = outcome(lambda: jpar.solve_fr_dense_sharded(costs, mesh, **kw))
    got = outcome(lambda: pool.run(sharded.solve_fr_dense_sharded, costs,
                                   device="cpu", **kw))
    assert_same_outcome(got, want, assert_tuples_equal)
    return got


@pytest.mark.parametrize("sense", SENSES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_solve_fr_dense_sharded(pool, dtype, sense):
    costs = random_costs(dtype, (7, 7), DTYPES.index(dtype))
    sharded_both(pool, costs, SENSES[sense])


def test_solve_fr_dense_sharded_unsigned_minimize_keeps_jaxs_stall(pool):
    """Reference behaviour: with ``maximize=False`` both packages negate
    the host costs before the cast, and ``-costs`` wraps on unsigned
    costs to values near 2^32; at ε = 1/8 the float32 auction stalls and
    the feasible instance ends at the round cap with persons unassigned."""
    costs = random_costs("uint32", (7, 7), DTYPES.index("uint32"))
    p2o, o2p, unassigned, nits, objective = sharded_both(pool, costs,
                                                         False)[1]
    assert unassigned > 0 and nits >= 100
