"""The port's batch-sharded modes against the JAX package's.

The port runs on worlds of 1, 2 and 4 gloo ranks (``parallel/dryrun.
RankPool``: one world of 4 for the module, whose first ranks' subgroups
are the worlds of 1 and 2; the pool checks that every rank returns the
same bits), the JAX package on its virtual CPU mesh of the same size.  On the port's kernel route a CPU tensor runs
the kernel's plain version (``fr_chunk_reference``,
``ksp_chunk_reference``); the JAX side runs its kernel in interpret
mode where the test says so (``_SHARDED_KERNEL_INTERPRET_ON_CPU``, as
``tests/test_sharded.py`` does, kept at 128² and B <= 8), else its XLA
rounds.  Tolerance: 0 on ``person_to_object``, ``object_to_person``,
``nits``, ``num_unassigned`` and ``eps``; objectives equal (integer
costs, so every sum is exact); scipy is the oracle of the optimum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from scipy.optimize import linear_sum_assignment

import sparse_linear_assignment_tpu.batch as jbatch
import sparse_linear_assignment_tpu.parallel.sharded as jsh
from sparse_linear_assignment_tpu.solution import UNASSIGNED, o2p_from_p2o
import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch.parallel import dryrun, sharded

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_batch")
    made = dryrun.RankPool(4, str(root / "store"), sizes=(1, 2))
    yield made
    made.close()


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's kernels in interpret mode on its CPU mesh."""
    monkeypatch.setattr(jsh, "_SHARDED_KERNEL_INTERPRET_ON_CPU", True)
    monkeypatch.setattr(jbatch, "_SPARSE_KERNEL_INTERPRET_ON_CPU", True)


def run_ranks(pool, d, fn, *args, **kwargs):
    """``fn`` with ``device="cpu"`` on a world of ``d`` ranks: the whole
    pool, or the subgroup of its first ``d`` ranks."""
    return pool.run(fn, *args, size=None if d == pool.world else d,
                    device="cpu", **kwargs)


def make_mesh(d):
    return Mesh(np.array(jax.devices()[:d]), ("shard",))


def assert_batch_equal(got, want):
    for field in ("person_to_object", "object_to_person", "nits",
                  "num_unassigned", "eps", "objective"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)


def assert_scipy_optimal(sol, costs, rows, maximize=False):
    for bi in rows:
        r, c = linear_sum_assignment(costs[bi], maximize=maximize)
        assert sol.objective[bi] == costs[bi][r, c].sum(), bi


def int_costs(seed, shape, hi):
    return np.random.default_rng(seed).integers(1, hi, size=shape).astype(
        np.float64)


def sparse_arcs(seed, b, n, m, k):
    rng = np.random.default_rng(seed)
    columns = np.stack([
        np.stack([rng.choice(m, size=k, replace=False) for _ in range(n)])
        for _ in range(b)
    ]).astype(np.int32)
    return columns, rng.integers(1, 60, size=(b, n, k)).astype(np.float64)


def batched_costs():
    """Plain rounds in float64; B = 11 is no multiple of 2 or 4."""
    return int_costs(21, (11, 64, 64), 500)


def kernel_costs():
    """On the FR kernel's contract; B = 3 pads to 4 at d = 2."""
    return int_costs(61, (3, 128, 128), 100)


def stream_batches():
    """The integer kernel route; B = 2, so two ranks of 4 hold only
    padding."""
    return [torch.from_numpy(int_costs(77 + i, (2, 128, 128), 200)
                             .astype(np.float32)) for i in range(2)]


SPARSE = (61, 7, 16, 128, 4)  # seed, B (no multiple of 2 or 4), n, m, k
KERNEL_KW = dict(eps=1.0 / 129, integer=False, max_cost=None)
STREAM_KW = dict(integer=True, max_cost=200)

#: the port's call of each case that runs at several world sizes
CASES = {
    "batched": lambda: (sharded.solve_batch_sharded, (batched_costs(),),
                        {"dtype": np.float64}),
    "batched_kernel": lambda: (sharded.solve_batch_sharded,
                               (kernel_costs(),), KERNEL_KW),
    "stream": lambda: (sharded.solve_batch_sharded_stream,
                       (stream_batches(),), STREAM_KW),
    "sparse": lambda: (sharded.solve_batch_sparse_sharded,
                       (*sparse_arcs(*SPARSE), SPARSE[3]), {}),
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
# solve_batch_sharded
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", WORLDS)
def test_sharded_batched_fr_float64(pool, d):
    """float64 is off the kernel's contract: plain rounds on both
    sides."""
    costs = batched_costs()
    want = jsh.solve_batch_sharded(costs, make_mesh(d), dtype=np.float64)
    got = port_case(pool, "batched", d)
    assert_batch_equal(got, want)
    assert np.all(got.num_unassigned == 0)
    assert_scipy_optimal(got, costs, range(11))
    for bi in range(11):
        for i, j in enumerate(got.person_to_object[bi]):
            assert got.object_to_person[bi, j] == i


@pytest.mark.parametrize("d", (2,))
def test_sharded_batched_fr_integer_mode(pool, d):
    """The auto-detected int32 lattice on the kernel route (its plain
    version here; JAX's XLA rounds): B not a multiple of the world."""
    costs = int_costs(41, (3, 128, 128), 200)
    got = run_ranks(pool, d, sharded.solve_batch_sharded, costs)
    assert_batch_equal(got, jsh.solve_batch_sharded(costs, make_mesh(d)))
    assert np.all(got.num_unassigned == 0)
    np.testing.assert_array_equal(got.eps, np.full(3, 1.0 / 129))
    assert_scipy_optimal(got, costs, range(3))
    # integer=False keeps the float path; the same exact optimum
    ref = run_ranks(pool, d, sharded.solve_batch_sharded, costs,
                    integer=False)
    assert_batch_equal(ref, jsh.solve_batch_sharded(costs, make_mesh(d),
                                                    integer=False))
    np.testing.assert_array_equal(ref.objective, got.objective)
    assert not np.allclose(ref.eps, got.eps)


@pytest.mark.parametrize("d", (1, 2))
def test_sharded_batched_fr_device_staged(pool, d):
    """``costs_device``: each rank stages its slice from the tensor
    (at d = 1 the tensor itself); the same result as the host-staged
    solve and JAX's."""
    costs = batched_costs()
    got = run_ranks(pool, d, sharded.solve_batch_sharded, costs,
                    dtype=np.float64, costs_device=torch.from_numpy(costs))
    assert_batch_equal(got, port_case(pool, "batched", d))
    assert_batch_equal(got, jsh.solve_batch_sharded(
        costs, make_mesh(d), dtype=np.float64,
        costs_device=jnp.asarray(costs)))
    assert np.all(got.num_unassigned == 0)


@pytest.mark.parametrize("d", (2,))
def test_sharded_batched_fr_device_staged_objective_from_host(pool, d):
    """A float32 ``costs_device`` beside fractional float64 host costs:
    the rounds run on the float32 values, and the objective picks each
    person's cost from the host costs in float64, as JAX picks it."""
    costs = np.random.default_rng(35).uniform(1.0, 500.0, size=(5, 64, 64))
    dev32 = costs.astype(np.float32)
    got = run_ranks(pool, d, sharded.solve_batch_sharded, costs,
                    costs_device=torch.from_numpy(dev32))
    assert_batch_equal(got, jsh.solve_batch_sharded(
        costs, make_mesh(d), costs_device=jnp.asarray(dev32)))
    assert np.all(got.num_unassigned == 0)
    # the float32 values' sum differs: the test sees where the pick is made
    picked32 = np.take_along_axis(dev32.astype(np.float64),
                                  got.person_to_object[:, :, None],
                                  axis=2)[:, :, 0].sum(axis=1)
    assert not np.array_equal(picked32, got.objective)


@pytest.mark.parametrize("integer", [False, True])
def test_sharded_batched_kernel_variant(pool, jax_kernels, integer):
    """The kernel route on both sides (JAX's kernel in interpret mode):
    the one-dispatch schedule on each rank's slice; B = 3 pads to 4."""
    costs = kernel_costs()
    kw = dict(KERNEL_KW, integer=integer, max_cost=100 if integer else None)
    want = jsh.solve_batch_sharded(costs, make_mesh(2), **kw)
    got = (run_ranks(pool, 2, sharded.solve_batch_sharded, costs, **kw)
           if integer else port_case(pool, "batched_kernel", 2))
    assert_batch_equal(got, want)
    assert int(got.num_unassigned.sum()) == 0
    assert_scipy_optimal(got, costs, range(3))


# ----------------------------------------------------------------------
# solve_batch_sharded_stream
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", WORLDS)
def test_sharded_batched_stream(pool, d):
    """Off the kernel's contract (n = 32): lockstep plain chunks; two
    batches in input order, then maximize; B = 6 pads at d = 4."""
    n = 32
    host = [int_costs(61 + i, (6, n, n), 200) for i in range(2)]
    eps = 1.0 / (n + 1)
    want = jsh.solve_batch_sharded_stream(
        [jnp.asarray(c.astype(np.float32)) for c in host], make_mesh(d),
        eps=eps, window=2)
    sols = run_ranks(pool, d, sharded.solve_batch_sharded_stream,
                     [torch.from_numpy(c.astype(np.float32)) for c in host],
                     eps=eps, window=2)
    assert len(sols) == 2
    for c, sol, w in zip(host, sols, want):
        assert_batch_equal(sol, w)
        assert int(sol.num_unassigned.sum()) == 0
        assert_scipy_optimal(sol, c, range(6))

    host_m = int_costs(63, (6, n, n), 200)
    sols_m = run_ranks(pool, d, sharded.solve_batch_sharded_stream,
                       [torch.from_numpy(host_m.astype(np.float32))],
                       maximize=True, eps=eps)
    want_m = jsh.solve_batch_sharded_stream(
        [jnp.asarray(host_m.astype(np.float32))], make_mesh(d),
        maximize=True, eps=eps)
    assert_batch_equal(sols_m[0], want_m[0])
    assert_scipy_optimal(sols_m[0], host_m, range(6), maximize=True)


def test_sharded_batched_stream_validation(pool):
    fn = sharded.solve_batch_sharded_stream
    assert run_ranks(pool, 2, fn, []) == []
    with pytest.raises(ValueError, match="square"):
        run_ranks(pool, 2, fn, [torch.zeros((2, 8, 16))])
    with pytest.raises(ValueError, match="share one shape"):
        run_ranks(pool, 2, fn, [torch.zeros((2, 16, 16)),
                                 torch.zeros((4, 16, 16))])


def test_sharded_stream_kernel_variant(pool, jax_kernels):
    """The streamed kernel route on both sides (JAX's kernel in
    interpret mode), integer mode, window 2."""
    batches = [int_costs(63 + i, (4, 128, 128), 100) for i in range(2)]
    sols = run_ranks(pool, 2, sharded.solve_batch_sharded_stream,
                     [torch.from_numpy(b.astype(np.float32))
                      for b in batches], integer=True, max_cost=100)
    want = jsh.solve_batch_sharded_stream(
        [jnp.asarray(b.astype(np.float32)) for b in batches], make_mesh(2),
        integer=True, max_cost=100)
    for bt, sol, w in zip(batches, sols, want):
        assert_batch_equal(sol, w)
        assert int(sol.num_unassigned.sum()) == 0
        assert_scipy_optimal(sol, bt, (0, 3))


def test_sharded_batched_odd_n_int32_readback(pool):
    """Odd N: off the kernel's contract on both sides (JAX reads back
    plain int32 indices there); batch and stream."""
    rng = np.random.default_rng(71)
    for n in (3, 9):
        costs = rng.integers(1, 30, size=(2, n, n)).astype(np.float64)
        eps = 1.0 / (n + 1)
        got = run_ranks(pool, 2, sharded.solve_batch_sharded, costs,
                        eps=eps)
        assert_batch_equal(got, jsh.solve_batch_sharded(
            costs, make_mesh(2), eps=eps))
        assert_scipy_optimal(got, costs, range(2))
        sols = run_ranks(pool, 2, sharded.solve_batch_sharded_stream,
                         [torch.from_numpy(costs.astype(np.float32))],
                         eps=eps)
        want = jsh.solve_batch_sharded_stream(
            [jnp.asarray(costs.astype(np.float32))], make_mesh(2), eps=eps)
        assert_batch_equal(sols[0], want[0])
        assert_scipy_optimal(sols[0], costs, range(2))


def test_sharded_stream_d1_vs_dN_bit_identical(pool):
    """The streamed integer kernel route: worlds of 1 and 4 give the
    same bits (B = 2: two ranks of the 4 hold only padding), and the
    port's unsharded ``solve_batch_stream`` too."""
    results = [port_case(pool, "stream", d) for d in (1, 4)]
    assert dryrun.same(*results)
    single = port.solve_batch_stream(stream_batches(), **STREAM_KW)
    for got, want in zip(results[0], single):
        assert_batch_equal(got, want)


# ----------------------------------------------------------------------
# solve_batch_sparse_sharded
# ----------------------------------------------------------------------
@pytest.mark.parametrize("d", (2, 4))
def test_batch_sparse_sharded_matches_jax(pool, jax_kernels, d):
    """The Khosla kernel route on both sides (JAX's in interpret mode);
    bit-equal to JAX's sharded solve, to the world of one and to the
    port's unsharded dense engine; B = 7 exercises the padding."""
    _, b, n, m, k = SPARSE
    columns, values = sparse_arcs(*SPARSE)
    want = jsh.solve_batch_sparse_sharded(columns, values, m, make_mesh(d))
    got = port_case(pool, "sparse", d)
    assert_batch_equal(got, want)
    assert dryrun.same(got, port_case(pool, "sparse", 1))
    ref = port.solve_batch_sparse(columns, values, m, engine="dense",
                                  device="cpu")
    assert_batch_equal(got, ref)
    assert int(got.num_unassigned.sum()) == 0
    for bi in (0, b - 1):
        full = np.full((n, m), 1e9)
        for i in range(n):
            full[i, columns[bi, i]] = values[bi, i]
        r, c = linear_sum_assignment(full)
        assert got.objective[bi] == full[r, c].sum()


def test_batch_sparse_sharded_validation(pool):
    fn = sharded.solve_batch_sparse_sharded
    columns, values = sparse_arcs(3, 2, 12, 128, 4)
    with pytest.raises(ValueError, match="N%8==0"):
        run_ranks(pool, 2, fn, columns, values, 128)
    columns, values = sparse_arcs(3, 2, 8, 100, 4)
    with pytest.raises(ValueError, match="num_cols%128==0"):
        run_ranks(pool, 2, fn, columns, values, 100)
    columns, values = sparse_arcs(3, 2, 8, 128, 4)
    columns[1, 3] = -1
    with pytest.raises(ValueError, match="at least one arc"):
        run_ranks(pool, 2, fn, columns, values, 128)


# ----------------------------------------------------------------------
# the batch finish
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["batched", "stream", "sparse"])
def test_sharded_entry_points_finish_in_one_block(pool, case):
    """Each batch-sharded entry point finishes as ``solve_batch`` does:
    on every rank of a world of 2, the maps and the unassigned counts are
    int32, C-contiguous views of one host block (checked on the rank,
    before pickling), object→person is the JAX package's inversion of
    the matching, and the result is the world of one's."""
    fn, args, kwargs = CASES[case]()
    got, blocks = run_ranks(pool, 2, dryrun.with_blocks, fn, *args,
                            **kwargs)
    assert blocks and all(blocks)
    for sol in (got if isinstance(got, list) else [got]):
        p2o = sol.person_to_object
        np.testing.assert_array_equal(
            sol.object_to_person,
            o2p_from_p2o(p2o, sol.object_to_person.shape[1]))
        np.testing.assert_array_equal(sol.num_unassigned,
                                      (p2o == UNASSIGNED).sum(axis=1))
    assert dryrun.same(got, port_case(pool, case, 1))


# ----------------------------------------------------------------------
# d = 1 against d = N
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", list(CASES))
def test_d1_vs_dN_bit_identical(pool, case):
    """Each batch-sharded engine gives the same bits on worlds of 1 and
    4 ranks (the single-instance engines:
    ``test_torch_sharded_single.py``)."""
    assert dryrun.same(port_case(pool, case, 1), port_case(pool, case, 4))
