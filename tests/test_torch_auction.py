"""The port's dense Khosla round (``ops/auction.py``) against the JAX
package's ``khosla_round`` on the same inputs.

Inputs come from NumPy seeds.  Every state field must be bit-identical
(tolerance 0) after each round, in float32 and float64, on batches that
hold a feasible instance, tie-heavy values, persons with one arc and an
infeasible instance on which the drop rule fires.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu.ops.auction import KhoslaState as JState
from sparse_linear_assignment_tpu.ops.auction import (
    khosla_round as jax_khosla_round,
)
from sparse_linear_assignment_tpu.ops.dense import DenseProblem as JDense
from sparse_linear_assignment_tpu_torch.ops.auction import (
    KhoslaState,
    _price_at_best,
    _top2_profits_dense,
    khosla_round,
    khosla_state_from_jax,
    khosla_state_to_numpy,
)
from sparse_linear_assignment_tpu_torch.ops.dense import DenseProblem

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1


def make_plane(seed, b=4, n=12, m=40, k=4, hi=30, dtype=np.float32):
    """``vals_t [B, M, N]`` of k-sparse instances (-inf at non-arcs),
    sign-adjusted for a minimisation, with thresholds.  Instance 1 is
    tie-heavy, instance 2 infeasible (all persons share object 3), and
    person 0 of instance 0 has one arc."""
    rng = np.random.default_rng(seed)
    vals_t = np.full((b, m, n), -np.inf, dtype=dtype)
    for bi in range(b):
        top = 3 if bi == 1 else hi
        for i in range(n):
            cols = rng.choice(m, size=k, replace=False)
            if bi == 2:
                cols = np.array([3])
            elif bi == 0 and i == 0:
                cols = cols[:1]
            vals_t[bi, cols, i] = -rng.integers(1, top, size=cols.size)
    finite = np.where(np.isfinite(vals_t), vals_t, np.nan)
    w_lo = np.nanmin(finite.reshape(b, -1), axis=1)
    w_hi = np.nanmax(finite.reshape(b, -1), axis=1)
    eps = 0.5 / n
    thresholds = ((m / 2.0) * (w_hi - w_lo + eps)).astype(dtype)
    # a low threshold on the infeasible instance: the drop rule fires
    # within a few rounds
    thresholds[2] = dtype(0.1)
    return vals_t, dtype(eps), thresholds


def jax_init(vals_t):
    b, m, n = vals_t.shape
    return JState(
        prices=jnp.zeros((b, m), vals_t.dtype),
        p2o=jnp.full((b, n), jnp.int32(UNASSIGNED)),
        o2p=jnp.full((b, m), jnp.int32(UNASSIGNED)),
        dropped=jnp.zeros((b, n), bool),
        nits=jnp.zeros((b,), jnp.int32),
    )


def np_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def jax_round(vals_t, s, eps, thresholds):
    return jax.vmap(
        lambda v, st, t: jax_khosla_round(JDense(v), st, eps, t)
    )(vals_t, s, thresholds)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_khosla_round_matches_jax(dtype, seed):
    vals_t, eps, thresholds = make_plane(seed, dtype=dtype)
    jv, jt = jnp.asarray(vals_t), jnp.asarray(thresholds)
    js = jax_init(jv)
    ts = khosla_state_from_jax(np_fields(js), device="cpu")
    problem = DenseProblem(torch.from_numpy(vals_t))
    tt = torch.from_numpy(thresholds)
    dropped_seen = False
    for rnd in range(12):
        js = jax_round(jv, js, eps, jt)
        ts = khosla_round(problem, ts, eps, tt)
        want, got = np_fields(js), khosla_state_to_numpy(ts)
        for name in JState._fields:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(
                got[name], want[name], err_msg=f"{name} after {rnd + 1}"
            )
        dropped_seen |= bool(got["dropped"].any())
    assert dropped_seen, "the drop rule never fired"
    # the infeasible instance ended: one owner, every other one dropped
    n = vals_t.shape[2]
    assert int(got["dropped"][2].sum()) == n - 1
    # finished instances stopped counting rounds
    assert got["nits"].max() < 12


def test_round_without_active_person_is_a_no_op():
    vals_t, eps, thresholds = make_plane(3)
    problem = DenseProblem(torch.from_numpy(vals_t))
    tt = torch.from_numpy(thresholds)
    b, m, n = vals_t.shape
    s = KhoslaState(
        prices=torch.rand((b, m)),
        p2o=torch.full((b, n), UNASSIGNED, dtype=torch.int32),
        o2p=torch.full((b, m), UNASSIGNED, dtype=torch.int32),
        dropped=torch.ones((b, n), dtype=torch.bool),
        nits=torch.full((b,), 5, dtype=torch.int32),
    )
    out = khosla_round(problem, s, eps, tt)
    for name in KhoslaState._fields:
        assert torch.equal(getattr(out, name), getattr(s, name)), name


def test_price_at_best_is_reconstructed_not_gathered():
    """``best_val - (best_val - price)`` differs from the stored price in
    float32; the port must use the reconstruction, as JAX does."""
    vals_t = np.full((1, 2, 1), -np.inf, dtype=np.float32)
    vals_t[0, 0, 0] = -700.0
    price = np.float32(0.1)
    prices = torch.tensor([[price, 0.0]])
    problem = DenseProblem(torch.from_numpy(vals_t))
    best, second, best_j, best_val = _top2_profits_dense(problem, prices)
    pab = _price_at_best(problem, prices, best_j, best, best_val)
    want = np.float32(-700.0) - (np.float32(-700.0) - price)
    assert float(pab[0, 0]) == float(want)
    assert float(pab[0, 0]) != float(price)
    assert float(second[0, 0]) == -np.inf


def test_state_carrier_round_trip():
    vals_t, eps, thresholds = make_plane(4)
    js = jax_round(jnp.asarray(vals_t), jax_init(jnp.asarray(vals_t)), eps,
                   jnp.asarray(thresholds))
    fields = np_fields(js)
    back = khosla_state_to_numpy(khosla_state_from_jax(fields, device="cpu"))
    assert set(back) == set(JState._fields)
    for name in JState._fields:
        assert back[name].dtype == fields[name].dtype, name
        np.testing.assert_array_equal(back[name], fields[name])
