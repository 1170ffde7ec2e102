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
