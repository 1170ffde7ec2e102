"""The port's dense forward round and eps-CS margins (``ops/auction.py``)
against the JAX package's ``forward_round`` and ``ecs_margins`` on the
same inputs.

Inputs come from NumPy seeds.  Every state field must be bit-identical
(tolerance 0) after each of 60 rounds, in float32 and float64, with and
without keep-valid pairs, on square instances (the eps ladder runs),
rectangular ones (started at the target eps) and a plane with ``-inf``
non-arcs that holds single-arc persons.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu.ops.auction import ForwardState as JState
from sparse_linear_assignment_tpu.ops.auction import (
    ecs_margins as jax_ecs_margins,
)
from sparse_linear_assignment_tpu.ops.auction import (
    forward_round as jax_forward_round,
)
from sparse_linear_assignment_tpu.ops.dense import DenseProblem as JDense
from sparse_linear_assignment_tpu_torch.ops.auction import (
    ForwardState,
    ecs_margins,
    forward_init,
    forward_round,
    forward_state_from_jax,
    forward_state_to_numpy,
)
from sparse_linear_assignment_tpu_torch.ops.dense import DenseProblem

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1
MAX_ITERATIONS = 45  # below 60: the round cap is reached too


def make_values(kind, seed, dtype):
    """``vals_t [B, M, N]`` (sign-adjusted for a minimisation) with the
    start eps, target eps and toleration ``solve_batch`` would choose."""
    rng = np.random.default_rng(seed)
    if kind == "square":
        b, n, m = 4, 16, 16
    elif kind == "rect":
        b, n, m = 3, 8, 16
    else:
        b, n, m = 3, 12, 30
    vals_t = -rng.integers(1, 60, size=(b, m, n)).astype(dtype)
    if kind == "sparse":
        keep = rng.random((b, m, n)).argsort(axis=1) < 4
        keep[:, :, :3] = False          # persons 0..2: one arc each
        keep[:, np.arange(3), np.arange(3)] = True
        vals_t = np.where(keep, vals_t, -np.inf).astype(dtype)
    c = np.abs(np.where(np.isfinite(vals_t), vals_t, 0)).reshape(b, -1).max(
        axis=1)
    target = 1.0 / (n + 1)
    start = (c / 8.0) if kind == "square" else np.full(b, target)
    toleration = 2.0 ** (int(np.log2(float(c.max()))) - 53)
    return (vals_t, start.astype(dtype), dtype(target), dtype(toleration),
            kind != "square")


def jax_init(vals_t, start):
    b, m, n = vals_t.shape
    return JState(
        prices=jnp.zeros((b, m), vals_t.dtype),
        p2o=jnp.full((b, n), jnp.int32(UNASSIGNED)),
        o2p=jnp.full((b, m), jnp.int32(UNASSIGNED)),
        eps=jnp.asarray(start),
        nits=jnp.zeros((b,), jnp.int32),
        nreductions=jnp.zeros((b,), jnp.int32),
        optimal_found=jnp.zeros((b,), bool),
        done=jnp.zeros((b,), bool),
    )


def np_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


@functools.partial(jax.jit, static_argnames=("sfoe", "keep_valid"))
def jax_round(vals_t, s, target, tol, sfoe, keep_valid):
    return jax.vmap(
        lambda v, st: jax_forward_round(
            JDense(v), st, target, tol, jnp.asarray(sfoe),
            jnp.asarray(MAX_ITERATIONS, jnp.int32), keep_valid=keep_valid,
        )
    )(vals_t, s)


@pytest.mark.parametrize("kind", ["square", "rect", "sparse"])
@pytest.mark.parametrize("keep_valid", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_forward_round_matches_jax(dtype, keep_valid, kind):
    vals_t, start, target, tol, sfoe = make_values(kind, 5, dtype)
    jv = jnp.asarray(vals_t)
    js = jax_init(jv, start)
    ts = forward_state_from_jax(np_fields(js), device="cpu")
    problem = DenseProblem(torch.from_numpy(vals_t))
    for rnd in range(60):
        js = jax_round(jv, js, target, tol, sfoe, keep_valid)
        ts = forward_round(problem, ts, target, tol, sfoe, MAX_ITERATIONS,
                           keep_valid=keep_valid)
        want, got = np_fields(js), forward_state_to_numpy(ts)
        for name in JState._fields:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(
                got[name], want[name], err_msg=f"{name} after {rnd + 1}"
            )
    assert got["done"].all()
    assert np.isfinite(got["prices"]).all()
    if kind == "square":
        assert got["nreductions"].max() > 0, "the eps ladder never ran"
    else:
        assert got["nreductions"].max() == 0
        assert got["optimal_found"].all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ecs_margins_match_jax(dtype):
    vals_t, start, target, tol, sfoe = make_values("sparse", 6, dtype)
    problem = DenseProblem(torch.from_numpy(vals_t))
    ts = forward_init(problem.vals_t, torch.from_numpy(start))
    ts = forward_round(problem, ts, target, tol, sfoe, 100, keep_valid=True)
    chosen, maxp = ecs_margins(problem, ts.prices, ts.p2o)
    got = forward_state_to_numpy(ts)
    want_c, want_m = jax.vmap(
        lambda v, p, a: jax_ecs_margins(JDense(v), p, a)
    )(jnp.asarray(vals_t), jnp.asarray(got["prices"]),
      jnp.asarray(got["p2o"]))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(maxp.numpy(), np.asarray(want_m))
    assert (got["p2o"] == UNASSIGNED).any()
    assert np.isneginf(chosen.numpy()[got["p2o"] == UNASSIGNED]).all()


def test_done_instance_comes_out_unchanged():
    vals_t, start, target, tol, sfoe = make_values("square", 7, np.float32)
    problem = DenseProblem(torch.from_numpy(vals_t))
    s = forward_init(problem.vals_t, torch.from_numpy(start))
    s = forward_round(problem, s, target, tol, sfoe, 100, keep_valid=True)
    frozen = s._replace(done=torch.ones_like(s.done))
    out = forward_round(problem, frozen, target, tol, sfoe, 100,
                        keep_valid=True)
    for name in ForwardState._fields:
        assert torch.equal(getattr(out, name), getattr(frozen, name)), name


def test_single_arc_forward_terminates_optimally():
    """The deliberate deviation: a person with one arc bids ``price +
    eps`` (the reference crate bids ``+inf``, which poisons the price).
    Prices stay finite and the matching is optimal."""
    dense = np.full((3, 3), 1e6)
    dense[0, [0, 1, 2]] = [5.0, 3.0, 8.0]
    dense[1, [0, 1]] = [4.0, 7.0]
    dense[2, [2]] = [2.0]
    vals_t = np.where(dense < 1e6, -dense, -np.inf).T[None].copy()
    problem = DenseProblem(torch.from_numpy(vals_t))
    s = forward_init(problem.vals_t, 4.0)  # C / 2, the reference start
    for _ in range(200):
        s = forward_round(problem, s, 1.0 / 3, 2.0**-50, False, 200)
        if bool(s.done.all()):
            break
    assert int((s.p2o == UNASSIGNED).sum()) == 0
    assert bool(torch.isfinite(s.prices).all()), "prices must stay finite"
    assert int(s.nits[0]) < 200
    r, c = scipy_lsa(dense)
    got = dense[np.arange(3), s.p2o[0].numpy()].sum()
    assert got == pytest.approx(dense[r, c].sum(), abs=1e-9)


def test_state_carrier_round_trip():
    vals_t, start, target, tol, sfoe = make_values("rect", 8, np.float32)
    js = jax_round(jnp.asarray(vals_t), jax_init(jnp.asarray(vals_t), start),
                   target, tol, sfoe, True)
    fields = np_fields(js)
    back = port.forward_state_to_numpy(
        port.forward_state_from_jax(fields, device="cpu"))
    assert set(back) == set(JState._fields)
    for name in JState._fields:
        assert back[name].dtype == fields[name].dtype, name
        np.testing.assert_array_equal(back[name], fields[name])
