"""The port's padded layout, prefix sums and single padded rounds against
the JAX package's, on the CPU.

``build_padded_problem`` equals JAX's array for array, with and without
the degree split; ``prefix_sum`` and ``compact_indices`` equal JAX's MXU
forms (mirrors ``test_prefix.py``); one padded ``khosla_round``,
``_full_round``, ``_slot_round`` and ``forward_round`` started from the
same carried state in both packages give the same state, in float32 and
float64.  Tolerance 0 (bit-equal) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_linear_assignment_tpu as jpkg
from sparse_linear_assignment_tpu import generators as jgen
from sparse_linear_assignment_tpu.ops import auction as jauction
from sparse_linear_assignment_tpu.ops import compact as jcompact
from sparse_linear_assignment_tpu.ops.padded import (
    build_padded_problem as jax_build,
)
from sparse_linear_assignment_tpu.ops.prefix import (
    compact_indices as jax_compact_indices,
    prefix_sum as jax_prefix_sum,
)
from sparse_linear_assignment_tpu_torch.ops import auction, compact
from sparse_linear_assignment_tpu_torch.ops.padded import (
    _FIELDS,
    build_padded_problem,
    padded_problem_from_numpy,
)
from sparse_linear_assignment_tpu_torch.ops.prefix import (
    compact_indices,
    prefix_sum,
)

torch.set_num_threads(1)

# one compiled JAX round a shape instead of op-by-op dispatch
jax_khosla_round = jax.jit(jauction.khosla_round)
jax_forward_round = jax.jit(jauction.forward_round,
                            static_argnames=("keep_valid",))

UNASSIGNED = 2**31 - 1
DTYPES = [np.float32, np.float64]


def instance(n, density, seed=17, hi=10.0):
    """A symmetric instance's CSR with the values negated (a
    minimisation, as ``init_solve`` leaves them)."""
    solver, _ = jpkg.KhoslaSolver.new(n, n, 30 * n)
    jgen.gen_symmetric_input(solver, seed, n, density, 0.0, hi)
    return (np.asarray(solver.j_counts), np.asarray(solver.column_indices),
            -np.asarray(solver.values))


def both_problems(n, density, dtype, seed=17):
    counts, cols, vals = instance(n, density, seed)
    jp = jax_build(n, n, counts, cols, vals, dtype=dtype, to_device=False)
    tp = build_padded_problem(n, n, counts, cols, vals, dtype=dtype,
                              device="cpu")
    return jp, tp, counts


def padded_problem_to_numpy(problem):
    return {name: (None if getattr(problem, name) is None
                   else getattr(problem, name).numpy())
            for name in _FIELDS}


def jax_fields(problem):
    return {name: (None if getattr(problem, name) is None
                   else np.asarray(getattr(problem, name)))
            for name in _FIELDS}


# ----------------------------------------------------------------------
# the layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,density,split", [(60, 0.05, False),
                                             (400, 0.04, True)])
def test_build_padded_problem_equals_jax(n, density, split, dtype):
    jp, tp, counts = both_problems(n, density, dtype)
    assert (counts.max() > 8) == split
    want = jax_fields(jp)
    got = padded_problem_to_numpy(tp)
    assert (got["row_cols8"] is not None) == split
    for name in _FIELDS:
        if want[name] is None:
            assert got[name] is None, name
            continue
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert tp.num_rows == jp.num_rows and tp.num_cols == jp.num_cols
    assert tp.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype


def test_padded_problem_round_trips_jax_arrays():
    jp, _, _ = both_problems(400, 0.04, np.float32)
    tp = padded_problem_from_numpy(jax_fields(jp), device="cpu")
    got = padded_problem_to_numpy(tp)
    for name, arr in jax_fields(jp).items():
        if arr is not None:
            np.testing.assert_array_equal(got[name], arr)


def test_build_padded_problem_pads_to_a_multiple():
    counts, cols, vals = instance(40, 0.1)
    jp = jax_build(40, 40, counts, cols, vals, k_pad_multiple=8,
                   to_device=False)
    tp = build_padded_problem(40, 40, counts, cols, vals, k_pad_multiple=8,
                              device="cpu")
    assert tp.row_cols.shape[0] % 8 == 0
    np.testing.assert_array_equal(tp.row_cols.numpy(),
                                  np.asarray(jp.row_cols))
    np.testing.assert_array_equal(tp.col_mask.numpy(),
                                  np.asarray(jp.col_mask))


def test_build_padded_problem_needs_a_device_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    counts, cols, vals = instance(20, 0.2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_padded_problem(20, 20, counts, cols, vals)
    with pytest.raises(ValueError, match="sum"):
        build_padded_problem(20, 20, counts + 1, cols, vals, device="cpu")


# ----------------------------------------------------------------------
# prefix sums (test_prefix.py on the port)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 128, 129, 1000, 16384, 100_000])
def test_prefix_sum_matches_numpy_and_jax(n):
    rng = np.random.default_rng(n)
    mask = rng.random(n) < 0.3
    got = prefix_sum(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.cumsum(mask).astype(np.int32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_prefix_sum(jnp.asarray(mask))))


@pytest.mark.parametrize("n,size", [(1000, 256), (1000, 2048),
                                    (100_000, 4096), (300, 8)])
def test_compact_indices_equals_jax(n, size):
    rng = np.random.default_rng(size)
    mask = rng.random(n) < 0.05
    ids, count = compact_indices(torch.from_numpy(mask), size)
    jids, jcount = jax_compact_indices(jnp.asarray(mask), size)
    want = np.nonzero(mask)[0]
    assert int(count) == int(jcount) == len(want)
    take = min(size, len(want))
    np.testing.assert_array_equal(ids.numpy()[:take], want[:take])
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.dtype == torch.int32 and count.dtype == torch.int32


# ----------------------------------------------------------------------
# one round of each package from the same carried state
# ----------------------------------------------------------------------
def warm_khosla_state(jp, dtype, rounds=3):
    """A JAX KhoslaState after a few padded rounds (some assigned, some
    displaced, prices moved)."""
    n = jp.num_rows
    eps = np.dtype(dtype).type(1.0 / n)
    thr = np.dtype(dtype).type(n / 2.0 * (10.0 + 1.0 / n))
    s = jauction.KhoslaState(
        prices=jnp.zeros(n, dtype), p2o=jnp.full(n, jnp.int32(UNASSIGNED)),
        o2p=jnp.full(n, jnp.int32(UNASSIGNED)), dropped=jnp.zeros(n, bool),
        nits=jnp.zeros((), jnp.int32),
    )
    for _ in range(rounds):
        s = jax_khosla_round(jp, s, eps, thr)
    return s, eps, thr


def jax_to_numpy(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def assert_states_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("low_threshold", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_padded_khosla_round_equals_jax(dtype, low_threshold):
    jp_np, tp, _ = both_problems(120, 0.05, dtype)
    jp = jax_build(120, 120, *instance(120, 0.05), dtype=dtype)
    s, eps, thr = warm_khosla_state(jp, dtype)
    if low_threshold:  # persons whose best object is priced drop
        thr = np.dtype(dtype).type(0.05)
    ts = auction.khosla_state_from_jax(jax_to_numpy(s), device="cpu")
    for _ in range(2):
        s = jax_khosla_round(jp, s, eps, thr)
        ts = auction.khosla_round(tp, ts, eps, thr)
    assert_states_equal(auction.khosla_state_to_numpy(ts), jax_to_numpy(s))
    if low_threshold:
        assert np.asarray(s.dropped).any()


def lstate_pair(jp, tp, dtype, start_rounds=3):
    """The same warm LState in both packages: a few padded rounds, then
    the slot list of the active persons."""
    js, eps, thr = warm_khosla_state(jp, dtype, start_rounds)
    n = jp.num_rows
    jl = jcompact.LState(prices=js.prices, p2o=js.p2o, o2p=js.o2p,
                         dropped=js.dropped,
                         slots=jnp.arange(n, dtype=jnp.int32),
                         nits=js.nits)
    jl = jcompact.repack_slots(jl, n)
    tl = compact.lstate_from_jax(jax_to_numpy(jl), device="cpu")
    return jl, tl, eps, thr


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("split", [False, True])
def test_full_round_equals_jax(dtype, split):
    n, density = (400, 0.04) if split else (60, 0.05)
    _, tp, _ = both_problems(n, density, dtype)
    jp = jax_build(n, n, *instance(n, density), dtype=dtype)
    assert (jp.row_cols8 is not None) == split
    jl, tl, eps, thr = lstate_pair(jp, tp, dtype)
    jl, jact = jcompact.khosla_full_chunk(jp, jl, eps, thr, 3)
    tl, tact = compact.khosla_full_chunk(tp, tl, eps, thr, 3)
    assert int(tact) == int(jact)
    assert_states_equal(compact.lstate_to_numpy(tl), jax_to_numpy(jl))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [None, 64])
def test_slot_round_equals_jax(dtype, p):
    n = 400
    _, tp, _ = both_problems(n, 0.04, dtype)
    jp = jax_build(n, n, *instance(n, 0.04), dtype=dtype)
    jl, tl, eps, thr = lstate_pair(jp, tp, dtype, start_rounds=6)
    active = int(jnp.sum(jl.slots != UNASSIGNED))
    if p is not None:
        assert active <= p
        jl = jcompact.repack_slots(jl, p)
        tl = compact.repack_slots(tl, p)
        assert_states_equal(compact.lstate_to_numpy(tl), jax_to_numpy(jl))
    jl, jocc = jcompact.khosla_run_chunk(jp, jl, eps, thr, 4)
    tl, tocc = compact.khosla_run_chunk(tp, tl, eps, thr, 4)
    assert int(tocc) == int(jocc)
    assert_states_equal(compact.lstate_to_numpy(tl), jax_to_numpy(jl))


def test_full_round_matches_slot_round():
    """``_full_round`` and ``_slot_round`` evolve the state identically
    when every active person holds a slot (test_compact.py on the port,
    with the degree split)."""
    n = 400
    _, tp, _ = both_problems(n, 0.04, np.float64)
    assert tp.row_cols8 is not None
    eps = np.float64(1.0 / n)
    thr = np.float64((n / 2.0) * (10.0 + eps))
    init = compact.fresh_lstate(torch.zeros(n, dtype=torch.float64), n)
    s_full, _ = compact.khosla_full_chunk(tp, init, eps, thr, 12)
    s_slot, _ = compact.khosla_run_chunk(tp, init, eps, thr, 12)
    for name in ("prices", "p2o", "o2p", "dropped", "nits"):
        assert torch.equal(getattr(s_full, name), getattr(s_slot, name))


@pytest.mark.parametrize("dtype", DTYPES)
def test_padded_forward_round_equals_jax(dtype):
    n = 60
    counts, cols, vals = instance(n, 0.1, seed=4, hi=50.0)
    jp = jax_build(n, n, counts, cols, vals, dtype=dtype)
    tp = build_padded_problem(n, n, counts, cols, vals, dtype=dtype,
                              device="cpu")
    npd = np.dtype(dtype)
    target, tol = npd.type(1.0 / n), npd.type(2.0 ** -47)
    s = jauction.ForwardState(
        prices=jnp.zeros(n, dtype), p2o=jnp.full(n, jnp.int32(UNASSIGNED)),
        o2p=jnp.full(n, jnp.int32(UNASSIGNED)), eps=jnp.asarray(
            npd.type(25.0)), nits=jnp.zeros((), jnp.int32),
        nreductions=jnp.zeros((), jnp.int32),
        optimal_found=jnp.zeros((), bool), done=jnp.zeros((), bool),
    )
    for _ in range(20):
        s = jax_forward_round(jp, s, target, tol, False, 100_000)
    ts = auction.forward_state_from_jax(jax_to_numpy(s), device="cpu")
    # long enough to cross an eps reduction on this instance
    for _ in range(60):
        s = jax_forward_round(jp, s, target, tol, False, 100_000)
        ts = auction.forward_round(tp, ts, target, tol, False, 100_000)
    assert int(s.nreductions) >= 1
    assert_states_equal(auction.forward_state_to_numpy(ts),
                        jax_to_numpy(s))
    chosen, maxp = auction.ecs_margins(tp, ts.prices, ts.p2o)
    jchosen, jmaxp = jauction.ecs_margins(jp, s.prices, s.p2o)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    np.testing.assert_array_equal(maxp.numpy(), np.asarray(jmaxp))


def test_padded_top2_and_resolve_equal_jax():
    n = 400
    dtype = np.float32
    _, tp, _ = both_problems(n, 0.04, dtype)
    jp = jax_build(n, n, *instance(n, 0.04), dtype=dtype)
    rng = np.random.default_rng(3)
    prices = rng.uniform(0, 3, n).astype(dtype)
    got = auction.top2_profits(tp, torch.from_numpy(prices))
    want = jauction.top2_profits(jp, jnp.asarray(prices))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bid = np.where(rng.random(n) < 0.5, got[0].numpy() + 1, -np.inf)
    bid = bid.astype(dtype)
    p2o = np.where(rng.random(n) < 0.3, rng.permutation(n),
                   UNASSIGNED).astype(np.int32)
    o2p = np.full(n, UNASSIGNED, np.int32)
    res = auction.resolve_and_assign(
        tp, torch.from_numpy(prices), torch.from_numpy(p2o),
        torch.from_numpy(o2p), torch.from_numpy(bid), got[2])
    jres = jauction.resolve_and_assign(
        jp, jnp.asarray(prices), jnp.asarray(p2o), jnp.asarray(o2p),
        jnp.asarray(bid), want[2])
    for g, w in zip(res, jres):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_graphs_run_is_the_plain_chunk_on_the_cpu():
    """``ops/graphs.run`` captures CUDA graphs on the card only; on the
    CPU it runs the chunk as it is, with the scalars as 0-dim tensors
    of the given dtypes, and keeps nothing on the problem."""
    from sparse_linear_assignment_tpu_torch.ops import graphs

    n = 120
    _, tp, _ = both_problems(n, 0.05, np.float32)
    eps, thr = np.float32(1.0 / n), np.float32(600.0)
    init = compact.fresh_lstate(torch.zeros(n), n)
    got, count = graphs.run(compact._run_chunk, tp, init,
                            ((eps, torch.float32), (thr, torch.float32)), 5)
    want, wcount = compact.khosla_run_chunk(tp, init, eps, thr, 5)
    assert_states_equal(compact.lstate_to_numpy(got),
                        compact.lstate_to_numpy(want))
    assert int(count) == int(wcount)
    assert tp.graphs == {}
