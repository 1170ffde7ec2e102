"""The port's big-single path against the JAX package's.

- ``fr_big_chunk`` (plain version, CPU tensors) against the JAX
  ``fr_big_chunk(interpret=True)``: every ``FRState`` field bit-equal
  (tolerance 0) at every chunk boundary, then on to done.  ``since_inc``
  is compared only while undone (the JAX kernel stops counting at done).
- ``solve_batch`` on the big-single route (``_BIG_MIN_ELEMS = 0`` in
  both packages): matchings, ``nits``, ``num_unassigned`` and ``eps``
  equal to JAX; the objective within 1e-6 of JAX and equal to scipy's.

The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu import batch as jbatch
from sparse_linear_assignment_tpu.ops.fr_dense import fr_init as jfr_init
from sparse_linear_assignment_tpu.ops.pallas_fr_big import (
    fr_big_chunk as jfr_big_chunk,
)
from sparse_linear_assignment_tpu_torch import batch
from sparse_linear_assignment_tpu_torch.ops import fr_big
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (
    FRState,
    state_to_numpy,
    weights_from_jax_state,
)

# the tensors here are small and the suite runs several test workers
# at once: one intra-op thread per worker avoids oversubscribing the
# host's cores
torch.set_num_threads(1)


def _batch1(jstate):
    """A JAX unbatched FRState as the port's batch-1 state."""
    return weights_from_jax_state(
        {k: np.asarray(getattr(jstate, k))[None] for k in jstate._fields},
        device="cpu",
    )


def _assert_state_equal(got, want, what):
    got_np = state_to_numpy(got)
    fields = [k for k in FRState._fields if k != "since_inc"]
    if not bool(np.asarray(want.done)):
        fields.append("since_inc")
    for k in fields:
        np.testing.assert_array_equal(
            got_np[k][0], np.asarray(getattr(want, k)),
            err_msg=f"{what}: {k}",
        )


@pytest.mark.parametrize(
    "seed,lo,hi,n,bm",
    [
        (5, 1, 200, 256, 128),
        (5, 1, 200, 384, 64),
        (201, 5, 6, 256, 128),   # all costs equal: maximal tie stress
    ],
)
def test_fr_big_chunk_matches_pallas_interpret(seed, lo, hi, n, bm):
    rng = np.random.default_rng(seed)
    costs = rng.integers(lo, hi, size=(n, n)).astype(np.float32)
    values_t = np.ascontiguousarray(-costs.T)  # [M objects, N persons]
    eps = np.float32(1.0 / (n + 1))
    jv = jnp.asarray(values_t)
    want = jfr_init(jv, eps)
    tv = torch.from_numpy(values_t)[None]
    got = _batch1(want)
    total = 0
    for chunk in (7, 9, 48):
        want, _ = jfr_big_chunk(jv, want, chunk, bm=bm, interpret=True)
        got, _ = fr_big.fr_big_chunk(tv, got, chunk)
        total += chunk
        _assert_state_equal(got, want, f"after {total} rounds")
    while not bool(np.asarray(want.done)) and total < 8000:
        want, _ = jfr_big_chunk(jv, want, 400, bm=bm, interpret=True)
        got, done = fr_big.fr_big_chunk(tv, got, 400)
        total += 400
        _assert_state_equal(got, want, f"after {total} rounds")
    assert bool(done) and bool(np.asarray(want.done))
    assert int((got.p2o == port.UNASSIGNED).sum()) == 0


def test_fr_big_chunk_counts_bidder_rows_and_rejects_batches():
    n = 128
    rng = np.random.default_rng(3)
    tv = torch.from_numpy(
        -rng.integers(1, 100, size=(1, n, n)).astype(np.float32))
    s0 = batch.fr_init(tv, 1.0 / n)
    rows = torch.zeros(1, dtype=torch.int64)
    fr_big.fr_big_chunk(tv, s0, 1, bid_rows=rows)
    assert rows.tolist() == [n]  # round 1: every person bids
    with pytest.raises(ValueError, match="one instance"):
        fr_big.fr_big_chunk(tv.expand(2, n, n), batch.fr_init(
            tv.expand(2, n, n), 1.0 / n), 1)
    with pytest.raises(ValueError, match="float32"):
        fr_big.fr_big_chunk(tv.to(torch.int32), batch.fr_init(
            tv.to(torch.int32), 1), 1)


N = 256


@pytest.fixture(scope="module")
def big_costs():
    rng = np.random.default_rng(71)
    return rng.integers(1, 1000, size=(2, N, N)).astype(np.float64)


@pytest.fixture(scope="module")
def jax_big(big_costs):
    """The JAX big-single route's answers (interpret mode), for both
    objective senses and both cost residencies."""
    saved = (jbatch._BIG_INTERPRET_ON_CPU, jbatch._BIG_MIN_ELEMS)
    jbatch._BIG_INTERPRET_ON_CPU = True
    jbatch._BIG_MIN_ELEMS = 0
    try:
        out = {}
        for maximize in (False, True):
            kw = dict(solver="fr", dtype=np.float32, integer=False,
                      maximize=maximize, eps=1.0 / (N + 1))
            out[maximize, "host"] = jbatch.solve_batch(big_costs, **kw)
            out[maximize, "device"] = jbatch.solve_batch(
                None, costs_device=jnp.asarray(big_costs.astype(
                    np.float32)), **kw)
        return out
    finally:
        jbatch._BIG_INTERPRET_ON_CPU, jbatch._BIG_MIN_ELEMS = saved


@pytest.mark.parametrize("residency", ["host", "device"])
@pytest.mark.parametrize("maximize", [False, True])
def test_big_single_route_matches_jax(big_costs, jax_big, monkeypatch,
                                      maximize, residency):
    monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 0)
    launches = []
    real = batch.fr_big_chunk
    monkeypatch.setattr(batch, "fr_big_chunk",
                        lambda *a, **k: launches.append(1) or real(*a, **k))
    # the route stages one instance at a time, never the whole batch
    staged = []
    real_stage = batch._stage
    monkeypatch.setattr(batch, "_stage", lambda c, *a: staged.append(
        c.shape[0]) or real_stage(c, *a))
    kw = dict(maximize=maximize, eps=1.0 / (N + 1), integer=False)
    if residency == "host":
        got = port.solve_batch(big_costs, device="cpu", **kw)
    else:
        got = port.solve_batch(
            None, costs_device=torch.from_numpy(
                big_costs.astype(np.float32)), **kw)
    want = jax_big[maximize, residency]
    assert launches, "the big-single route was not taken"
    assert staged == [1, 1]
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.object_to_person,
                                  want.object_to_person)
    np.testing.assert_array_equal(got.nits, want.nits)
    np.testing.assert_array_equal(got.num_unassigned, want.num_unassigned)
    np.testing.assert_array_equal(got.eps, want.eps)
    np.testing.assert_allclose(got.objective, want.objective, rtol=0,
                               atol=1e-6)
    for bi in range(2):
        r, c = scipy_lsa(big_costs[bi], maximize=maximize)
        assert got.objective[bi] == big_costs[bi][r, c].sum()


@pytest.mark.parametrize("residency", ["host", "device"])
def test_big_single_round_limit_matches_jax(big_costs, monkeypatch,
                                            residency):
    """At ``max_iterations`` an undone instance with host costs goes to
    the native engine (its nits stay the device rounds); device-resident
    costs keep the device's partial matching.  Both as in JAX."""
    monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 0)
    monkeypatch.setattr(jbatch, "_BIG_MIN_ELEMS", 0)
    monkeypatch.setattr(jbatch, "_BIG_INTERPRET_ON_CPU", True)
    kw = dict(eps=1.0 / (N + 1), integer=False, max_iterations=20)
    dev32 = big_costs.astype(np.float32)
    if residency == "host":
        got = port.solve_batch(big_costs, device="cpu", **kw)
        want = jbatch.solve_batch(big_costs, solver="fr", **kw)
    else:
        got = port.solve_batch(None, costs_device=torch.from_numpy(dev32),
                               **kw)
        want = jbatch.solve_batch(None, solver="fr",
                                  costs_device=jnp.asarray(dev32), **kw)
    assert got.nits.tolist() == [20, 20]
    assert int(got.num_unassigned.sum()) > 0  # 20 rounds do not suffice
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.nits, want.nits)
    np.testing.assert_allclose(got.objective, want.objective, rtol=0,
                               atol=1e-6)


# The cluster kernel's launch shape, as the planner gives it to the
# kernel: (cluster, slice width, bidders a warp step, partials a pass,
# dynamic shared-memory bytes = 56 * width + 16 * pass_rows, whether the
# lone tail's 8 * S bytes fit one block's shared memory).
@pytest.mark.parametrize("max_cluster,n,want", [
    (16, 1152, (16, 72, 8, 1152, 22464, True)),
    (16, 2048, (16, 128, 8, 2048, 39936, True)),
    (16, 4096, (16, 256, 4, 4096, 79872, True)),
    (16, 8192, (16, 512, 2, 8192, 159744, True)),
    (16, 16384, (16, 1024, 1, 10880, 231424, True)),
    (8, 1152, (8, 144, 4, 1152, 26496, True)),
    (8, 2048, (8, 256, 4, 2048, 47104, True)),
    (8, 4096, (8, 512, 2, 4096, 94208, True)),
    (8, 8192, (8, 1024, 1, 8192, 188416, True)),
    (8, 16384, (8, 2048, 1, 7296, 231424, True)),
])
def test_plan_pins_the_launch_shape(max_cluster, n, want):
    got = fr_big.plan(n, max_cluster=max_cluster)
    assert tuple(got) == want
    assert got.cluster * got.width == n
    assert got.smem_bytes + fr_big.STATIC_SMEM_BYTES <= fr_big.MAX_SMEM_BYTES
    # a warp step keeps at most LOADS_IN_FLIGHT float4 loads a lane
    loads = -(-got.width // 128)
    assert got.rows_per_step == 1 or (
        got.rows_per_step * loads <= fr_big.LOADS_IN_FLIGHT)


# The largest side whose lone tail still fits: above it every round runs
# on the whole cluster (the kernels test the same bytes).
@pytest.mark.parametrize("max_cluster,largest", [(16, 28928), (8, 28928)])
def test_plan_lone_tail_fits_up_to_its_largest_side(max_cluster, largest):
    step = 4 * max_cluster
    for n in (largest - step, largest, largest + step, largest + 2 * step):
        got = fr_big.plan(n, max_cluster=max_cluster)
        fits = (fr_big.LONE_BYTES_PER_INDEX * n
                <= fr_big.MAX_SMEM_BYTES - fr_big.STATIC_SMEM_BYTES)
        assert got.lone_tail == fits == (n <= largest), n
    # every side up to it has the tail
    assert all(fr_big.plan(n, max_cluster=max_cluster).lone_tail
               for n in range(step, largest + 1, step))


def test_phases_name_the_lone_tail_counters():
    assert fr_big.PHASES == (
        "rows", "merge_bid", "apply", "control", "barrier_wait", "total",
        "wide_rounds", "wide_cycles", "lone_rounds", "lone_cycles",
        "barriers")
    # the wrapper's shape check takes len(PHASES) words, no fewer
    n = 128
    tv = torch.zeros((1, n, n), dtype=torch.float32)
    s0 = batch.fr_init(tv, 1.0 / n)
    with pytest.raises(ValueError, match=r"int64 \[11\] tensor"):
        fr_big._fr_big_chunk_cuda(
            tv, s0, 1, None, None,
            torch.zeros(9, dtype=torch.int64), None)


@pytest.mark.parametrize("seed,n", [(7, 256), (12, 256), (8, 384),
                                    (11, 1152)])
def test_plain_rounds_keep_one_bidder_once_one_person_is_unmatched(seed, n):
    """What the kernel's lone tail rests on, on the plain rounds: once a
    round starts with one person unmatched, every later round does too,
    until the round that fills the matching ends the solve; and a
    round's bidders are the S - card unmatched of the mode's side, in
    either mode (so one, in the tail)."""
    rng = np.random.default_rng(seed)
    tv = torch.from_numpy(
        -rng.integers(1, 1000, size=(1, n, n)).astype(np.float32))
    s0 = batch.fr_init(tv, 1.0 / (n + 1))
    rows = torch.zeros((1, 2000, 4), dtype=torch.int32)
    bid_rows = torch.zeros(1, dtype=torch.int64)
    got, done = fr_big.fr_big_chunk_reference(
        tv, s0, 2000, bid_rows=bid_rows, trace_rows=rows)
    assert bool(done)
    nits = int(got.nits[0])
    card = rows[0, :nits, 2].tolist()
    before = [0] + card[:-1]  # the cardinality each round starts at
    first = before.index(n - 1)
    assert before[first:] == [n - 1] * (nits - first)
    assert card[-1] == n
    assert rows[0, :nits, 3].tolist() == [0] * (nits - 1) + [1]
    assert int(bid_rows[0]) == sum(n - c for c in before)


@pytest.mark.parametrize("max_cluster", [8, 16])
def test_plan_raises_beyond_the_shared_memory_limit(max_cluster):
    with pytest.raises(ValueError, match="largest side is") as info:
        fr_big.plan(131072, max_cluster=max_cluster)
    largest = int(str(info.value).rsplit(" ", 1)[1])
    assert largest >= 16384  # the JAX bench's largest big single fits
    assert fr_big.plan(largest, max_cluster=max_cluster).pass_rows >= (
        fr_big.MIN_PASS_ROWS)
    with pytest.raises(ValueError, match="shared-memory limit"):
        fr_big.plan(largest + 4 * max_cluster, max_cluster=max_cluster)
    with pytest.raises(ValueError, match="multiple of"):
        fr_big.plan(1000, max_cluster=max_cluster)
    with pytest.raises(ValueError, match="at least 8"):
        fr_big.plan(4096, max_cluster=4)


def test_fr_big_chunk_phase_cycles_are_cuda_only():
    n = 128
    tv = torch.zeros((1, n, n), dtype=torch.float32)
    with pytest.raises(ValueError, match="phase_cycles"):
        fr_big.fr_big_chunk(tv, batch.fr_init(tv, 1.0 / n), 1,
                            phase_cycles=torch.zeros(
                                len(fr_big.PHASES), dtype=torch.int64))


def test_big_single_limit_raises_before_staging(monkeypatch):
    """A big single beyond the kernel's shared memory raises the
    planner's ``ValueError`` from the route, before anything is staged;
    nothing falls back.  The limit is shrunk so that 2048² trips it."""
    monkeypatch.setattr(fr_big, "MAX_SMEM_BYTES", 20_000)
    staged = []
    real_stage = batch._stage
    monkeypatch.setattr(batch, "_stage", lambda *a: staged.append(1)
                        or real_stage(*a))
    costs = torch.zeros((1, 2048, 2048), dtype=torch.float32)
    with pytest.raises(ValueError, match="shared-memory limit"):
        port.solve_batch(None, costs_device=costs, eps=1.0 / 2049)
    with pytest.raises(ValueError, match="largest side is"):
        port.solve_batch_stream([costs], eps=1.0 / 2049)
    assert staged == []
    monkeypatch.setattr(fr_big, "MAX_SMEM_BYTES", 232_448)
    assert batch._route(1, 2048, 2048, np.float32, None) == "big"
