"""The port's ``fr_chunk`` (plain version, CPU tensors) against the JAX
package's ``fr_chunk_pallas`` run in interpret mode.

Tie-heavy integer costs in [1, 8) stress the smallest-index tie rules;
every ``FRState`` field must be bit-identical (tolerance 0).  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu.ops.fr_dense import FRState as JState
from sparse_linear_assignment_tpu.ops.pallas_fr import fr_chunk_pallas
from sparse_linear_assignment_tpu_torch.ops import fr_kernel
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (
    FRState,
    fr_init,
    state_to_numpy,
    weights_from_jax_state,
)

# the tensors here are small and the suite runs several test workers
# at once: one intra-op thread per worker avoids oversubscribing the
# host's cores
torch.set_num_threads(1)


B = 4


def _values(mode, n, seed=11):
    rng = np.random.default_rng(seed)
    costs = rng.integers(1, 8, size=(B, n, n)).astype(np.float64)
    if mode == "int":
        return np.swapaxes(-costs, 1, 2).astype(np.int32) * (n + 1), 1
    return np.swapaxes(-costs, 1, 2).astype(np.float32), 1.0 / n


def _jax_state(values_t, eps):
    b, m, n = values_t.shape
    return JState(
        prices=jnp.zeros((b, m), values_t.dtype),
        profits=jnp.max(values_t, axis=1),
        p2o=jnp.full((b, n), jnp.int32(2**31 - 1)),
        o2p=jnp.full((b, m), jnp.int32(2**31 - 1)),
        eps=jnp.full((b,), eps, values_t.dtype),
        forward_mode=jnp.ones((b,), bool),
        since_inc=jnp.zeros((b,), jnp.int32),
        stall_k=jnp.full((b,), 8, jnp.int32),
        nits=jnp.zeros((b,), jnp.int32),
        nreductions=jnp.zeros((b,), jnp.int32),
        optimal_found=jnp.zeros((b,), bool),
        done=jnp.zeros((b,), bool),
    )


def _np_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


@pytest.mark.parametrize("n", [128, 256])
@pytest.mark.parametrize("mode", ["f32", "int"])
@pytest.mark.parametrize("rounds", [1, 7, 40])
def test_fr_chunk_matches_pallas_interpret(rounds, mode, n):
    values_t, eps = _values(mode, n)
    jv = jnp.asarray(values_t)
    js0 = _jax_state(jv, eps)
    # a finished instance must stay frozen through the chunk
    js0 = js0._replace(done=js0.done.at[B - 1].set(True))
    want, want_all = fr_chunk_pallas(jv, js0, rounds, interpret=True)

    tv = torch.from_numpy(values_t)
    ts0 = weights_from_jax_state(_np_fields(js0), device="cpu")
    got, got_all = fr_kernel.fr_chunk(tv, ts0, rounds)

    want_np = _np_fields(want)
    got_np = state_to_numpy(got)
    for k in FRState._fields:
        np.testing.assert_array_equal(got_np[k], want_np[k], err_msg=k)
    assert bool(got_all) == bool(want_all)
    assert got_np["nits"][B - 1] == 0
    if rounds == 40:
        assert (got_np["p2o"] != fr_kernel.UNASSIGNED).sum() > 0


def test_fr_chunk_bid_rows_counts_unassigned_bidders():
    """Round 1 of a fresh instance: every person bids (n rows each); the
    pre-finished instance reads nothing."""
    values_t, eps = _values("int", 128)
    tv = torch.from_numpy(values_t)
    s0 = fr_init(tv, torch.tensor(eps, dtype=torch.int32))
    s0 = s0._replace(done=torch.tensor([False, False, False, True]))
    counts = torch.zeros(B, dtype=torch.int64)
    fr_kernel.fr_chunk(tv, s0, 1, bid_rows=counts)
    assert counts.tolist() == [128, 128, 128, 0]


def test_fr_chunk_rejects_bad_shapes():
    tv = torch.zeros((2, 128, 64), dtype=torch.float32)
    s0 = fr_init(torch.zeros((2, 128, 128)), 0.1)
    with pytest.raises(ValueError, match="square"):
        fr_kernel.fr_chunk(tv, s0, 1)
    with pytest.raises(ValueError, match="float32 or int32"):
        fr_kernel.fr_chunk(torch.zeros((2, 128, 128), dtype=torch.float64),
                           s0, 1)


def test_fr_chunk_checks_its_counter_arguments():
    """``phase_cycles`` and ``stamps`` read the CUDA kernel's clocks: on
    CPU tensors they raise; elsewhere each must be a contiguous int64
    tensor of its shape on the values' device (checked on the meta
    device, which runs nothing)."""
    values_t, eps = _values("int", 128)
    tv = torch.from_numpy(values_t)
    s0 = fr_init(tv, torch.tensor(eps, dtype=torch.int32))
    n_phases = len(fr_kernel.PHASES)
    assert fr_kernel.PHASES[-2:] == ("total", "rounds")
    for kw in ({"phase_cycles": torch.zeros(n_phases, dtype=torch.int64)},
               {"stamps": torch.zeros((B, 2), dtype=torch.int64)}):
        with pytest.raises(ValueError, match="plain version has none"):
            fr_kernel.fr_chunk(tv, s0, 1, **kw)
    mv = tv.to("meta")
    ms0 = type(s0)(*(x.to("meta") for x in s0))

    def meta(shape, dtype=torch.int64):
        return torch.zeros(shape, dtype=dtype, device="meta")

    for kw in ({"phase_cycles": meta(n_phases - 1)},
               {"phase_cycles": meta(n_phases, torch.int32)},
               {"phase_cycles": torch.zeros(n_phases, dtype=torch.int64)},
               {"stamps": meta((B, 3))},
               {"stamps": meta((2, B)).t()},
               {"stamps": meta((B, 2), torch.float32)}):
        name = next(iter(kw))
        with pytest.raises(ValueError, match=f"{name} must be a contiguous "
                                             f"int64"):
            fr_kernel.fr_chunk(mv, ms0, 1, **kw)
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        fr_kernel.fr_chunk(mv, ms0, 1, phase_cycles=meta(n_phases),
                           stamps=meta((B, 2)))
    assert fr_kernel.LAUNCHES == 0  # CPU tensors never launch


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    values_t, eps = _values("f32", 128)
    fields = _np_fields(_jax_state(jnp.asarray(values_t), eps))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights_from_jax_state(fields)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        weights_from_jax_state(fields, device="cuda")


@pytest.mark.parametrize("mode", ["f32", "int"])
def test_weights_from_jax_state_round_trip(mode):
    values_t, eps = _values(mode, 128)
    js = _jax_state(jnp.asarray(values_t), eps)
    js = js._replace(
        p2o=js.p2o.at[0, 3].set(5), forward_mode=js.forward_mode.at[1].set(
            False),
    )
    fields = _np_fields(js)
    ts = weights_from_jax_state(fields, device="cpu")
    assert ts.prices.dtype == (
        torch.int32 if mode == "int" else torch.float32
    )
    assert ts.done.dtype == torch.bool and ts.p2o.dtype == torch.int32
    back = state_to_numpy(ts)
    for k in FRState._fields:
        np.testing.assert_array_equal(back[k], fields[k], err_msg=k)
        assert back[k].dtype == fields[k].dtype or k in (
            "nits", "since_inc", "stall_k", "nreductions", "p2o", "o2p"
        )
