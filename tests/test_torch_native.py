"""The port's native C++ engine and the host straggler tail against the
JAX package's.

The port keeps a byte-identical copy of ``native/engine.cpp`` and builds
it into its own ``_build/``; on the same inputs the two packages'
bindings must give the same answers, and the fused route's host-costs
tail must hand the same instances to the engine with the same ``nits``.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu import batch as jbatch
from sparse_linear_assignment_tpu import cpu_reference as jcpu
from sparse_linear_assignment_tpu.ops.fr_dense import fr_init, fr_round
from sparse_linear_assignment_tpu_torch import batch, cpu_reference

# the tensors here are small and the suite runs several test workers
# at once: one intra-op thread per worker avoids oversubscribing the
# host's cores
torch.set_num_threads(1)


def test_engine_source_is_the_jax_copy():
    mine = cpu_reference._SRC
    theirs = jcpu._SRC
    assert mine != theirs
    assert (hashlib.sha256(mine.read_bytes()).hexdigest()
            == hashlib.sha256(theirs.read_bytes()).hexdigest())


def test_engine_builds_into_the_ports_build_dir():
    cpu_reference.get_lib()
    so = cpu_reference._so_path()
    assert so.exists() and so.parent == cpu_reference.BUILD_DIR
    assert so.parent.parent.name == "sparse_linear_assignment_tpu_torch"


@pytest.mark.parametrize("maximize", [False, True])
def test_cpu_tail_forward_matches_jax(maximize):
    rng = np.random.default_rng(13)
    costs = rng.random((96, 96)) * 50.0
    row = costs if maximize else -costs
    eps = float(np.float32(1.0 / 96))
    got = batch._cpu_tail_forward(row, eps, 100_000)
    want = jbatch._cpu_tail_forward(row, eps, 100_000)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0
    assert (got[0] != port.UNASSIGNED).all()


def _finish_both(a, at, eps, prices, profits, p2o, o2p, **kw):
    out = []
    for fn in (cpu_reference.fr_dense_finish_cpu, jcpu.fr_dense_finish_cpu):
        arrays = [x.copy() for x in (prices, profits, p2o, o2p)]
        rc, pops = fn(a, at, eps, *arrays, **kw)
        out.append((rc, pops, arrays))
    (rc1, pops1, got), (rc2, pops2, want) = out
    assert rc1 == rc2 == 0 and pops1 == pops2 > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


@pytest.mark.parametrize("seed", [0, 3])
def test_fr_dense_finish_scratch_matches_jax(seed):
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(seed)
    n = 160
    costs = rng.integers(1, 1000, size=(n, n)).astype(np.float64)
    eps = 1.0 / (n + 1)
    prices = np.zeros(n)
    profits = (-costs).max(axis=1) - eps
    empty = np.full(n, -1, np.int32)
    _, _, p2o, _ = _finish_both(costs, None, eps, prices, profits, empty,
                                empty, sign=-1.0)
    r, c = linear_sum_assignment(costs)
    assert costs[np.arange(n), p2o].sum() == costs[r, c].sum()


def test_fr_dense_finish_warm_handoff_matches_jax():
    """A mid-solve state of 12 device rounds, converted to the engine's
    f64 warm form as in ``tests/test_fr_big.py``, finished by both."""
    n = 128
    rng = np.random.default_rng(7)
    costs = rng.integers(1, 1000, size=(n, n)).astype(np.float64)
    a = -costs
    vals_t = jnp.asarray(a.T.astype(np.float32))
    eps32 = np.float32(1.0 / (n + 1))
    round1 = jax.jit(lambda s: fr_round(
        vals_t, s, eps32, jnp.float32(0.0), jnp.int32(10**9),
        skip_certificate=True,
    ))
    st = fr_init(vals_t, eps32)
    for _ in range(12):
        st = round1(st)
    p2o_dev = np.asarray(st.p2o)
    assert 0 < int((p2o_dev == port.UNASSIGNED).sum()) < n

    eps = float(eps32)
    prices = np.asarray(st.prices).astype(np.float64)
    p2o = np.where(p2o_dev == port.UNASSIGNED, -1, p2o_dev).astype(np.int32)
    o2p = np.full(n, -1, np.int32)
    idx = np.arange(n, dtype=np.int32)
    assigned = p2o >= 0
    o2p[p2o[assigned]] = idx[assigned]
    profits = np.empty(n)
    profits[assigned] = a[idx[assigned], p2o[assigned]] - prices[
        p2o[assigned]]
    for i in idx[~assigned]:
        profits[i] = (a[i] - prices).max() - eps
    at = np.ascontiguousarray(a.T, dtype=np.float32)
    _finish_both(a, at, eps, prices, profits, p2o, o2p)


@pytest.mark.parametrize("integral", [False, True])
def test_straggler_tail_matches_jax(monkeypatch, integral):
    """A 10-round first chunk leaves all 3 instances undone; with host
    costs they are at most 128, so both packages stop the device rounds
    and finish them on the native engine with ``nits = 10``."""
    rng = np.random.default_rng(29)
    costs = (rng.integers(1, 100, size=(3, 128, 128)).astype(np.float64)
             if integral else rng.random((3, 128, 128)) * 100.0)
    monkeypatch.setattr(jbatch, "_FR_FUSED_INTERPRET_ON_CPU", True)
    monkeypatch.setattr(jbatch, "_fr_fused_schedule", lambda b, n, m: 10)
    monkeypatch.setattr(batch, "_fr_fused_schedule", lambda b, n, m: 10)
    want = jbatch.solve_batch(costs, solver="fr")
    want_tail = jbatch.LAST_TAIL_COUNT
    got = port.solve_batch(costs, device="cpu")
    assert batch.LAST_TAIL_COUNT == want_tail == 3
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.object_to_person,
                                  want.object_to_person)
    np.testing.assert_array_equal(got.nits, want.nits)
    assert got.nits.tolist() == [10, 10, 10]
    np.testing.assert_array_equal(got.eps, want.eps)
    np.testing.assert_allclose(got.objective, want.objective, rtol=0,
                               atol=1e-6)
    assert int(got.num_unassigned.sum()) == 0
