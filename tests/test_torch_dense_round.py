"""The forward round's and the forward chunk's plain versions
(``ops/dense_round.py``) against the JAX package's Pallas kernels in
interpret mode (``ops/pallas_dense.py``: ``fused_dense_round_batch`` and
``fused_dense_round``, whose port is ``ops/dense_round_single.py``;
``batch._batch_chunk_pallas``, the Pallas round
with its XLA eps-scaling bookkeeping) and against the port's own plain
rounds.

Inputs come from NumPy seeds.  All five outputs (prices, p2o, o2p,
chosen, maxp) must be bit-identical (tolerance 0), from the initial state
and from states several rounds into a solve, with instances marked done
and a per-instance eps; every ``ForwardState`` field of the chunk after
1, 2, 5 and 64 rounds and at done.  On CPU tensors the entry points run
the plain versions; the CUDA kernel is held against the same plain
versions on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu import batch as jbatch
from sparse_linear_assignment_tpu.ops import pallas_dense as jdense
from sparse_linear_assignment_tpu.ops.auction import ForwardState as JState
from sparse_linear_assignment_tpu_torch.ops import dense_round as dr
from sparse_linear_assignment_tpu_torch.ops import dense_round_single as drs
from sparse_linear_assignment_tpu_torch.ops.auction import (
    _price_at_best,
    _resolve_and_assign_dense,
    _top2_profits_dense,
    ecs_margins,
    forward_init,
    forward_state_to_numpy,
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
        st, _ = dr.dense_chunk_reference(vals.transpose(1, 2), st, target,
                                         2.0**-48, 10_000, rounds, n != m)
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
    single = drs.fused_dense_round(vals[0], st.prices[0], st.p2o[0],
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
    prices, p2o, _, _, _ = drs.fused_dense_round(
        vals[0], st.prices[0], st.p2o[0], st.o2p[0], float(st.eps[0]),
        False)
    assert int((p2o != UNASSIGNED).sum()) > 0 and float(prices.max()) > 0


# the single-instance round (``ops/dense_round_single.py``) against
# JAX's ``fused_dense_round(interpret=True)``
SINGLE_CASES = {
    "fresh": dict(n=128, m=128, rounds=0),
    "after-3-rounds": dict(n=128, m=128, rounds=3),
    "after-9-rounds": dict(n=128, m=128, rounds=9),
    "inf-plane-single-arc-persons": dict(n=128, m=256, rounds=2,
                                         sparse=True),
    "done": dict(n=128, m=128, rounds=3, done=True),
    "eps-0d-tensor": dict(n=128, m=128, rounds=3, eps_tensor=True),
    "n-below-m-128x256": dict(n=128, m=256, rounds=3),
    "off-tile-24x40": dict(n=24, m=40, rounds=2),
}


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_round_matches_pallas_single(case):
    """``fused_dense_round`` bit-equal to JAX's ``fused_dense_round(...,
    interpret=True)``: eps a Python float, or a 0-d tensor (which must
    give the float's answer), done a bool."""
    kw = SINGLE_CASES[case]
    vals, st = make_state(sorted(SINGLE_CASES).index(case) + 60, 1,
                          kw["n"], kw["m"], kw["rounds"],
                          sparse=kw.get("sparse", False))
    done = kw.get("done", False)
    eps = float(st.eps[0])
    args = (vals[0], st.prices[0], st.p2o[0], st.o2p[0])
    got = drs.fused_dense_round(*args, eps, done)
    if kw.get("eps_tensor"):
        as_tensor = drs.fused_dense_round(*args, st.eps[0].clone(),
                                          torch.tensor(done))
        assert_outputs_equal(as_tensor, [x.numpy() for x in got],
                             "eps and done as 0-d tensors")
        got = as_tensor
    want = jdense.fused_dense_round(
        *(jnp.asarray(x.numpy()) for x in args), np.float32(eps), done,
        interpret=True)
    assert_outputs_equal(got, [np.asarray(x) for x in want], case)
    unassigned = int((st.p2o[0] == UNASSIGNED).sum())
    if done or not unassigned:  # nobody bids: the state stands
        assert torch.equal(got[0], st.prices[0])
        assert torch.equal(got[1], st.p2o[0])
    else:
        assert bool((got[0] >= st.prices[0]).all())
        assert bool((got[0] > st.prices[0]).any()), "no bid was placed"
    assert dr.LAUNCHES == 0 and drs.LAUNCHES == 0  # CPU tensors


def test_single_round_plan():
    """The launch planner (pure Python): 32-person tiles, object slices
    of 8 to 512 objects as narrow as gives 128 items, the scratch
    arrays' offsets (16-byte aligned, in order, none overlapping)."""
    p = drs.plan(256, 256)
    assert (p.tiles, p.width, p.slices, p.items) == (8, 16, 16, 128)
    p = drs.plan(512, 256)       # 512 objects x 256 persons
    assert (p.tiles, p.width, p.slices, p.items) == (8, 32, 16, 128)
    p = drs.plan(4096, 4096)
    assert (p.tiles, p.width, p.slices, p.items) == (128, 512, 8, 1024)
    assert p.walk_steps == 8     # 512 rows / (8 warps x 8 in flight)
    p = drs.plan(40, 24)
    assert (p.tiles, p.width, p.slices, p.items) == (1, 8, 5, 5)
    p = drs.plan(40_000, 100)    # the last slice is shorter
    assert p.width == drs.MAX_SLICE and p.slices == 79
    for m, n in ((256, 256), (512, 256), (4096, 4096), (40, 24), (1, 1),
                 (257, 33), (100_000, 100_000)):
        p = drs.plan(m, n)
        assert p.width % drs.WARPS == 0 and p.width <= drs.MAX_SLICE
        assert p.slices * p.width >= m > (p.slices - 1) * p.width
        assert 32 * p.tiles >= n > 32 * (p.tiles - 1)
        sizes = (16 * n * p.slices, 8 * m, 4 * n)
        ends = [o + size for o, size in zip(p.offsets, sizes)]
        assert all(o % 16 == 0 for o in p.offsets)
        assert all(e <= o for e, o in zip(ends, p.offsets[1:]))
        assert ends[-1] <= p.scratch_bytes < ends[-1] + 16
    with pytest.raises(ValueError, match="empty instance"):
        drs.plan(0, 4)


def test_single_round_wrapper_checks():
    """Off the CPU the wrapper launches or raises; it checks the
    device and the shapes first.  The plain version takes any float
    dtype."""
    vals, st = make_state(33, 1, 8, 16, 0)
    args = (vals[0], st.prices[0], st.p2o[0], st.o2p[0], 0.5, False)
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in args]
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        drs.fused_dense_round(*meta)
    got = drs.fused_dense_round(vals[0].double(), st.prices[0].double(),
                                *args[2:])
    want = drs.fused_dense_round(*args)
    assert got[0].dtype == torch.float64
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert drs.LAUNCHES == 0


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
    assert dr.smem_bytes(256, 512) == 12 * 512 + 12 * 256
    assert dr.kernel_fits(128, 8192) and dr.kernel_fits(1024, 1024)
    assert not dr.kernel_fits(128, 20_000)
    assert dr.LAUNCHES == 0  # CPU tensors never launch


# ----------------------------------------------------------------------
# the forward chunk: dense_chunk_reference against _batch_chunk_pallas
# ----------------------------------------------------------------------
CHUNK_CASES = {
    "rect-128x256": dict(b=3, n=128, m=256),
    "square-128-eps-ladder": dict(b=3, n=128, m=128),
    "square-forced-done-and-per-instance-eps": dict(b=3, n=128, m=128,
                                                    forced=True),
    "rect-max-iterations-inside-a-chunk": dict(b=2, n=128, m=256,
                                               max_iterations=3),
    "square-max-iterations-inside-a-chunk": dict(b=2, n=128, m=128,
                                                 max_iterations=37),
}


def _chunk_start(case):
    """``vals_nm [B, N, M]`` from a NumPy seed and the initial forward
    state of ``case`` (start eps ``49/16`` on square planes, the target
    on rectangular ones)."""
    kw = CHUNK_CASES[case]
    b, n, m = kw["b"], kw["n"], kw["m"]
    rng = np.random.default_rng(sorted(CHUNK_CASES).index(case) + 40)
    vals_nm = torch.from_numpy(
        -rng.integers(1, 50, size=(b, n, m)).astype(np.float32))
    target = np.float32(1.0 / (n + 1))
    start = np.full(b, 49 / 16.0 if n == m else target, np.float32)
    st = forward_init(vals_nm.transpose(1, 2), torch.from_numpy(start))
    if kw.get("forced"):
        st = st._replace(done=torch.tensor([False, True, False]),
                         eps=st.eps * torch.tensor([1.0, 0.5, 1.75]))
    return vals_nm, st, target, kw.get("max_iterations", 100_000)


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_chunk_reference_matches_pallas_chunk(case):
    vals_nm, st, target, max_it = _chunk_start(case)
    b, n, m = vals_nm.shape
    tol = np.float32(2.0**-47)
    sfoe = n != m
    js = JState(**{k: jnp.asarray(v)
                   for k, v in forward_state_to_numpy(st).items()})
    jv = jnp.asarray(vals_nm.transpose(1, 2).contiguous().numpy())
    total = 0
    for chunk in (1, 1, 3, 59) + (64,) * 20:
        js, jdone = jbatch._batch_chunk_pallas(
            jv, js, target, tol, max_it, chunk, sfoe, interpret=True)
        st, done = dr.dense_chunk_reference(vals_nm, st, target, tol, max_it,
                                            chunk, sfoe)
        total += chunk
        got = forward_state_to_numpy(st)
        for name in JState._fields:
            want = np.asarray(getattr(js, name))
            assert got[name].dtype == want.dtype, name
            np.testing.assert_array_equal(
                got[name], want, err_msg=f"{case}: {name} after {total}")
        assert bool(done) == bool(jdone)
        if bool(done):
            break
    assert bool(done), (case, total)
    if max_it < 100:
        assert st.nits.max() == max_it
    elif n == m:
        assert st.nreductions.max() > 0, "the eps ladder never ran"
    if CHUNK_CASES[case].get("forced"):
        assert int(st.nits[1]) == 0  # done at entry: frozen


def test_chunk_rows_count_bidders_and_margin_passes():
    """``rows``: every round, the bidders of each live instance; in a
    round that ends fully assigned on a square plane (an eps reduction
    or the stop), its N rows once more for the margins.  An instance
    done at entry reads nothing."""
    vals_nm, st, target, _ = _chunk_start(
        "square-forced-done-and-per-instance-eps")
    n = vals_nm.shape[1]
    rows = torch.zeros(3, dtype=torch.int64)
    dr.fused_dense_chunk(vals_nm, st, target, 2.0**-47, 10_000, 1, False,
                         rows=rows)
    assert rows.tolist() == [n, 0, n]
    want = torch.zeros(3, dtype=torch.int64)
    s = st
    while not bool(s.done.all()):
        live = ~s.done
        want += ((s.p2o == UNASSIGNED) & live[:, None]).sum(dim=1)
        new, _ = dr.dense_chunk_reference(vals_nm, s, target, 2.0**-47,
                                          10_000, 1, False)
        margin = (new.nreductions > s.nreductions) | (new.done & live)
        want += n * margin
        s = new
    rows = torch.zeros(3, dtype=torch.int64)
    got, _ = dr.fused_dense_chunk(vals_nm, st, target, 2.0**-47, 10_000,
                                  10_000, False, rows=rows)
    assert torch.equal(got.p2o, s.p2o) and torch.equal(got.nits, s.nits)
    assert torch.equal(rows, want) and int(rows[1]) == 0


def test_chunk_wrapper_checks_shapes_dtypes_and_devices():
    vals_nm, st, target, _ = _chunk_start("rect-128x256")
    args = (target, 2.0**-47, 100, 4, True)
    with pytest.raises(ValueError, match=r"\[B, N, M\]"):
        dr.fused_dense_chunk(vals_nm[0], st, *args)
    with pytest.raises(ValueError, match="float values"):
        dr.fused_dense_chunk(vals_nm.to(torch.int32), st, *args)
    with pytest.raises(ValueError, match="states.prices has shape"):
        dr.fused_dense_chunk(vals_nm, st._replace(prices=st.prices[:, :3]),
                             *args)
    with pytest.raises(ValueError, match="states.done has shape"):
        dr.fused_dense_chunk(vals_nm, st._replace(done=st.done[:2]), *args)
    with pytest.raises(ValueError, match="rows must be"):
        dr.fused_dense_chunk(vals_nm, st, *args,
                             rows=torch.zeros(3, dtype=torch.int32))
    meta = vals_nm.to("meta")
    with pytest.raises(ValueError, match="states.prices is on cpu"):
        dr.fused_dense_chunk(meta, st, *args)
    on_meta = type(st)(*(x.to("meta") for x in st))
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        dr.fused_dense_chunk(meta, on_meta, *args)
    # float64 on the CPU runs the plain version; the kernel is float32
    got, _ = dr.fused_dense_chunk(
        vals_nm.double(), type(st)(*(x.double() if x.is_floating_point()
                                     else x for x in st)), *args)
    assert got.prices.dtype == torch.float64
    assert dr.LAUNCHES == 0  # CPU tensors never launch
