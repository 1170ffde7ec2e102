"""The port's plain FR rounds against the JAX package's ``fr_round``.

Same numpy-seeded inputs through both; every ``FRState`` field must be
bit-identical after every round (tolerance 0): the round arithmetic is
adds, subtracts and max/min reductions in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu.ops import fr_dense as jfr
from sparse_linear_assignment_tpu_torch.ops import fr_dense as tfr

# the tensors here are small and the suite runs several test workers
# at once: one intra-op thread per worker avoids oversubscribing the
# host's cores
torch.set_num_threads(1)


B, N, ROUNDS = 4, 128, 40


def _jax_init(values_t, eps):
    b, m, n = values_t.shape
    return jfr.FRState(
        prices=jnp.zeros((b, m), values_t.dtype),
        profits=jnp.max(values_t, axis=1),
        p2o=jnp.full((b, n), jnp.int32(2**31 - 1)),
        o2p=jnp.full((b, m), jnp.int32(2**31 - 1)),
        eps=jnp.full((b,), eps, values_t.dtype),
        forward_mode=jnp.ones((b,), bool),
        since_inc=jnp.zeros((b,), jnp.int32),
        stall_k=jnp.full((b,), jfr.STALL_K0, jnp.int32),
        nits=jnp.zeros((b,), jnp.int32),
        nreductions=jnp.zeros((b,), jnp.int32),
        optimal_found=jnp.zeros((b,), bool),
        done=jnp.zeros((b,), bool),
    )


def _np_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def _assert_same(jstate, tstate, where):
    want = _np_fields(jstate)
    got = tfr.state_to_numpy(tstate)
    for k in jfr.FRState._fields:
        np.testing.assert_array_equal(
            got[k], want[k], err_msg=f"{k} differs {where}"
        )


def _instance(mode, seed):
    rng = np.random.default_rng(seed)
    if mode == "int":
        costs = rng.integers(1, 100, size=(B, N, N)).astype(np.float64)
        values_t = np.swapaxes(-costs, 1, 2).astype(np.int32) * (N + 1)
        return values_t, np.int32(1)
    costs = rng.random((B, N, N)) * 100.0
    values_t = np.swapaxes(-costs, 1, 2).astype(np.float32)
    return values_t, np.float32(1.0 / N)


def _run_both(values_t, start_eps, target_eps, skip_certificate,
              rounds=ROUNDS):
    tol = values_t.dtype.type(0)

    @jax.jit
    def jround(vals_t, s):
        return jax.vmap(
            lambda v, st: jfr.fr_round(
                v, st, target_eps, tol, jnp.int32(10**6),
                skip_certificate=skip_certificate,
            )
        )(vals_t, s)

    jv = jnp.asarray(values_t)
    js = _jax_init(jv, start_eps)
    tv = torch.from_numpy(values_t)
    ts = tfr.weights_from_jax_state(_np_fields(js), device="cpu")
    _assert_same(js, tfr.fr_init(tv, torch.tensor(start_eps)), "at init")
    _assert_same(js, tfr.fr_init(tv, torch.tensor(start_eps),
                                 values=tv.transpose(1, 2).contiguous()),
                 "at init from the person-major layout")
    for r in range(rounds):
        js = jround(jv, js)
        ts = tfr.fr_round(
            tv, ts, target_eps, tol, 10**6,
            skip_certificate=skip_certificate,
        )
        _assert_same(js, ts, f"after round {r + 1}")
    return ts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["f32", "int"])
def test_fr_round_matches_jax_no_ladder(mode, seed):
    values_t, eps = _instance(mode, seed)
    final = _run_both(values_t, eps, eps, skip_certificate=True)
    # 40 rounds change the state: the comparison is not of idle tensors
    assert int((final.p2o != tfr._INT_MAX).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fr_round_matches_jax_certificate_ladder(seed):
    """The ε-CS certificate branch from an ε-ladder start (start ε = 1
    over costs in [1, 100), target 1/n): ε reductions, pair release and
    profit refresh must match bit for bit.  120 rounds take every seed
    through at least one reduction."""
    rng = np.random.default_rng(100 + seed)
    costs = rng.integers(1, 100, size=(B, N, N)).astype(np.float64)
    values_t = np.swapaxes(-costs, 1, 2).astype(np.float32)
    final = _run_both(
        values_t, np.float32(1.0), np.float32(1.0 / N),
        skip_certificate=False, rounds=120,
    )
    assert int(final.nreductions.sum()) > 0


def test_integer_rounds_require_no_ladder():
    values_t, eps = _instance("int", 0)
    s = tfr.fr_init(torch.from_numpy(values_t), torch.tensor(eps))
    with pytest.raises(ValueError, match="skip_certificate"):
        tfr.fr_round(torch.from_numpy(values_t), s, 1, 0, 10)
