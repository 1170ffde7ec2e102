"""The fused dense round's plain version (``ops/dense_round.py``) against
the JAX package's Pallas kernels in interpret mode
(``ops/pallas_dense.py``: ``fused_dense_round_batch`` and
``fused_dense_round``) and against the port's own plain rounds.

Inputs come from NumPy seeds.  All five outputs (prices, p2o, o2p,
chosen, maxp) must be bit-identical (tolerance 0), from the initial state
and from states several rounds into a solve, with instances marked done
and a per-instance eps.  On CPU tensors the entry points run the plain
version; the CUDA kernel is held against the same plain version on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu.ops import pallas_dense as jdense
from sparse_linear_assignment_tpu_torch import batch
from sparse_linear_assignment_tpu_torch.ops import dense_round as dr
from sparse_linear_assignment_tpu_torch.ops.auction import (
    _price_at_best,
    _resolve_and_assign_dense,
    _top2_profits_dense,
    ecs_margins,
    forward_init,
)
from sparse_linear_assignment_tpu_torch.ops.dense import DenseProblem

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1
NAMES = ("prices", "p2o", "o2p", "chosen", "maxp")


def make_state(seed, b, n, m, rounds, sparse=False, dtype=np.float32):
    """``vals_t [B, M, N]`` and the forward state ``rounds`` rounds into
    the solve (run by the port's kernel-route chunk on the CPU)."""
    rng = np.random.default_rng(seed)
    vals_t = -rng.integers(1, 50, size=(b, m, n)).astype(dtype)
    if sparse:
        keep = rng.random((b, m, n)).argsort(axis=1) < 5
        keep[:, :, :4] = False          # persons 0..3: one arc each
        keep[:, np.arange(4), np.arange(4)] = True
        vals_t = np.where(keep, vals_t, -np.inf).astype(dtype)
    vals = torch.from_numpy(vals_t)
    target = 1.0 / (n + 1)
    st = forward_init(vals, 49 / 16.0 if n == m else target)
    if rounds:
        st, _ = batch._batch_chunk_kernel(vals, st, target, 2.0**-48,
                                          10_000, rounds, n != m)
    return vals, st


def jax_batch_round(vals, st, eps, done):
    out = jdense.fused_dense_round_batch(
        jnp.asarray(vals.numpy()), jnp.asarray(st.prices.numpy()),
        jnp.asarray(st.p2o.numpy()), jnp.asarray(st.o2p.numpy()),
        jnp.asarray(eps.numpy()), jnp.asarray(done.numpy()),
        interpret=True,
    )
    return [np.asarray(x) for x in out]


def assert_outputs_equal(got, want, note=""):
    for name, g, w in zip(NAMES, got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype, (name, note)
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {note}")


@pytest.mark.parametrize("forced", [False, True],
                         ids=["as-it-stands", "done-and-eps-forced"])
@pytest.mark.parametrize("n, m", [(128, 128), (128, 256)])
def test_plain_round_matches_pallas_interpret(n, m, forced):
    b = 3
    for rounds in (0, 1, 6, 30):
        vals, st = make_state(11 + rounds, b, n, m, rounds)
        eps, done = st.eps, st.done
        if forced:
            done = torch.tensor([False, True, False])
            eps = st.eps * torch.tensor([1.0, 0.5, 1.75])
        got = dr.fused_dense_round_batch(vals, st.prices, st.p2o, st.o2p,
                                         eps, done)
        want = jax_batch_round(vals, st, eps, done)
        assert_outputs_equal(got, want, f"after {rounds} rounds")
        if forced:  # a done instance bids nothing, margins all the same
            assert torch.equal(got[0][1], st.prices[1])
            assert torch.equal(got[1][1], st.p2o[1])
            assert torch.equal(got[2][1], st.o2p[1])
            assert bool(torch.isfinite(got[4][1]).all())


def test_plain_round_matches_pallas_on_a_plane_with_single_arcs():
    for rounds in (0, 2, 9):
        vals, st = make_state(23, 2, 128, 256, rounds, sparse=True)
        got = dr.fused_dense_round_batch(vals, st.prices, st.p2o, st.o2p,
                                         st.eps, st.done)
        want = jax_batch_round(vals, st, st.eps, st.done)
        assert_outputs_equal(got, want, f"after {rounds} rounds")
        assert bool(torch.isfinite(got[0]).all()), "prices must stay finite"


def test_single_entry_matches_pallas_single_and_batch_at_b1():
    vals, st = make_state(17, 1, 128, 128, 3)
    single = dr.fused_dense_round(vals[0], st.prices[0], st.p2o[0],
                                  st.o2p[0], float(st.eps[0]), False)
    batched = dr.fused_dense_round_batch(vals, st.prices, st.p2o, st.o2p,
                                         st.eps, st.done)
    assert_outputs_equal(single, [x[0].numpy() for x in batched])
    want = jdense.fused_dense_round(
        jnp.asarray(vals[0].numpy()), jnp.asarray(st.prices[0].numpy()),
        jnp.asarray(st.p2o[0].numpy()), jnp.asarray(st.o2p[0].numpy()),
        np.float32(st.eps[0]), False, interpret=True,
    )
    assert_outputs_equal(single, [np.asarray(x) for x in want])
    # a round from a fresh state assigns someone and raises a price
    vals, st = make_state(17, 1, 128, 128, 0)
    prices, p2o, _, _, _ = dr.fused_dense_round(
        vals[0], st.prices[0], st.p2o[0], st.o2p[0], float(st.eps[0]),
        False)
    assert int((p2o != UNASSIGNED).sum()) > 0 and float(prices.max()) > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_round_matches_the_plain_rounds_pieces(dtype):
    """Off every TPU tile (24 x 40) and in float64, where the Pallas
    kernel cannot go: the round equals top-2, bid, resolve-and-assign
    and margins of ``ops/auction.py`` put together."""
    vals, st = make_state(29, 4, 24, 40, 4, dtype=dtype)
    done = torch.tensor([False, False, True, False])
    got = dr.fused_dense_round_batch(vals, st.prices, st.p2o, st.o2p,
                                     st.eps, done)
    problem = DenseProblem(vals)
    best, second, best_j, best_val = _top2_profits_dense(problem, st.prices)
    neg_inf = torch.tensor(-np.inf, dtype=vals.dtype)
    raw = torch.where(
        second != neg_inf, best_val - second + st.eps[:, None],
        _price_at_best(problem, st.prices, best_j, best, best_val)
        + st.eps[:, None],
    )
    bidding = (st.p2o == UNASSIGNED) & ~done[:, None] & (best != neg_inf)
    prices, p2o, o2p = _resolve_and_assign_dense(
        problem, st.prices, st.p2o, st.o2p,
        torch.where(bidding, raw, neg_inf), best_j)
    chosen, maxp = ecs_margins(problem, prices, p2o)
    for name, g, w in zip(NAMES, got, (prices, p2o, o2p, chosen, maxp)):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_second_equals_best_on_a_tie_and_smallest_object_wins():
    """Two objects with the same profit: the person bids on the smaller
    one and its bid is ``eps`` above the price (best - second == 0)."""
    vals = torch.tensor([[[-3.0], [-7.0], [-3.0]]])         # [1, 3, 1]
    prices, p2o, o2p, chosen, maxp = dr.fused_dense_round_batch(
        vals, torch.zeros((1, 3)),
        torch.full((1, 1), UNASSIGNED, dtype=torch.int32),
        torch.full((1, 3), UNASSIGNED, dtype=torch.int32),
        torch.tensor([0.25]), torch.tensor([False]))
    assert p2o.tolist() == [[0]] and o2p.tolist() == [[0, UNASSIGNED,
                                                       UNASSIGNED]]
    assert prices.tolist() == [[0.25, 0.0, 0.0]]
    assert chosen.tolist() == [[-3.25]] and maxp.tolist() == [[-3.0]]


def test_wrapper_rejects_bad_shapes_and_states_its_shared_memory():
    vals, st = make_state(31, 2, 8, 16, 0)
    with pytest.raises(ValueError, match="prices_b has shape"):
        dr.fused_dense_round_batch(vals, st.prices[:, :3], st.p2o, st.o2p,
                                   st.eps, st.done)
    with pytest.raises(ValueError, match=r"\[B, M, N\]"):
        dr.fused_dense_round_batch(vals[0], st.prices, st.p2o, st.o2p,
                                   st.eps, st.done)
    with pytest.raises(ValueError, match="float values"):
        dr.fused_dense_round_batch(vals.to(torch.int32), st.prices, st.p2o,
                                   st.o2p, st.eps, st.done)
    assert dr.smem_bytes(256, 512) == 12 * 512 + 8 * 256 + 4096
    assert dr.kernel_fits(128, 8192) and dr.kernel_fits(1024, 1024)
    assert not dr.kernel_fits(128, 20_000)
    assert dr.LAUNCHES == 0  # CPU tensors never launch
