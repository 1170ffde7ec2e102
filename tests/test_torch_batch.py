"""The port's batched FR path against the JAX package's fused path.

The JAX side runs its fused FR path in interpret mode on the CPU (the
``_FR_FUSED_INTERPRET_ON_CPU`` hook, as ``tests/test_batch.py`` does);
the port runs with ``device="cpu"``, i.e. the kernel's plain version.
Matchings, ``nits``, ``num_unassigned`` and ``eps`` must be equal; the
objective agrees to 1e-6 (the JAX device objective travels as a
double-double pair of f32 words, the port's is summed in f64).
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu import batch as jbatch

# the tensors here are small and the suite runs several test workers
# at once: one intra-op thread per worker avoids oversubscribing the
# host's cores
torch.set_num_threads(1)


B, N = 3, 128


def _costs(seed, integral):
    rng = np.random.default_rng(seed)
    if integral:
        return rng.integers(1, 100, size=(B, N, N)).astype(np.float64)
    return rng.random((B, N, N)) * 100.0


@pytest.fixture(scope="module")
def jax_results():
    """The JAX fused path's answers, computed once for the module."""
    import jax.numpy as jnp

    saved = (jbatch._FR_FUSED_INTERPRET_ON_CPU, jbatch._FR_B_BUCKET_FLOOR)
    jbatch._FR_FUSED_INTERPRET_ON_CPU = True
    jbatch._FR_B_BUCKET_FLOOR = 4
    try:
        host = _costs(41, integral=False)
        dev = _costs(43, integral=True)
        return {
            "host": (host, jbatch.solve_batch(host, solver="fr")),
            "device": (dev, jbatch.solve_batch(
                None, solver="fr", costs_device=jnp.asarray(
                    dev.astype(np.float32)),
                integer=True, max_cost=100,
            )),
        }
    finally:
        (jbatch._FR_FUSED_INTERPRET_ON_CPU,
         jbatch._FR_B_BUCKET_FLOOR) = saved


def _assert_same(got, want):
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.object_to_person,
                                  want.object_to_person)
    np.testing.assert_array_equal(got.nits, want.nits)
    np.testing.assert_array_equal(got.num_unassigned, want.num_unassigned)
    np.testing.assert_array_equal(got.eps, want.eps)
    np.testing.assert_allclose(got.objective, want.objective, rtol=0,
                               atol=1e-6)


def test_host_f32_costs_match_jax(jax_results):
    costs, want = jax_results["host"]
    got = port.solve_batch(costs, device="cpu")
    _assert_same(got, want)
    assert int(got.num_unassigned.sum()) == 0


def test_straggler_continuation_matches_jax(jax_results, monkeypatch):
    """Device-resident costs: a first chunk of 10 rounds leaves every
    instance undone, so the 128-round whole-batch chunks and then (with
    the bucket shrunk to 2) the gathered bucket stage both run on the
    device; a finished instance is frozen, so the answer must equal the
    JAX deep-budget result.  (Host costs go to the native tail instead:
    ``tests/test_torch_native.py``.)"""
    from sparse_linear_assignment_tpu_torch import batch

    monkeypatch.setattr(batch, "_fr_fused_schedule", lambda b, n, m: 10)
    monkeypatch.setattr(batch, "_BUCKET", 2)
    calls = []
    real_bucket = batch._fr_continue_bucket
    monkeypatch.setattr(
        batch, "_fr_continue_bucket",
        lambda *a: calls.append(a[3]) or real_bucket(*a),
    )
    costs, want = jax_results["device"]
    got = port.solve_batch(
        None, costs_device=torch.from_numpy(costs.astype(np.float32)),
        integer=True, max_cost=100,
    )
    _assert_same(got, want)
    assert calls and calls[0] == 2
    assert batch.LAST_TAIL_COUNT == 0


def test_trace_and_profile(tmp_path, capsys):
    from sparse_linear_assignment_tpu_torch.utils import trace

    trace.set_debug(True)
    try:
        assert trace.is_enabled()
        port.solve_batch(_costs(51, True)[:1], device="cpu")
    finally:
        trace.set_debug(False)
    err = capsys.readouterr().err
    assert "integer-auction mode, scale=129" in err
    assert "fr fused: rounds=" in err
    out = tmp_path / "trace"
    with trace.profile_solve(str(out)):
        port.solve_batch(_costs(51, True)[:1], device="cpu")
    assert (out / trace.TRACE_FILE).stat().st_size > 0


def test_profile_solve_takes_jaxs_keyword(tmp_path):
    """``profile_solve(log_dir=...)`` as in the JAX package: the
    directory is made and holds a non-empty Chrome trace."""
    import inspect

    from sparse_linear_assignment_tpu.utils import trace as jtrace
    from sparse_linear_assignment_tpu_torch.utils import trace

    want = inspect.signature(jtrace.profile_solve).parameters["log_dir"]
    got = inspect.signature(trace.profile_solve).parameters["log_dir"]
    assert got.default == want.default
    prof_dir = tmp_path / "prof"
    with trace.profile_solve(log_dir=str(prof_dir)) as prof:
        port.solve_batch(_costs(52, True)[:1], device="cpu")
    assert prof is not None
    traces = sorted(prof_dir.glob("*.json"))
    assert traces and all(p.stat().st_size > 0 for p in traces)


def test_device_resident_int_lattice_matches_jax(jax_results):
    costs, want = jax_results["device"]
    got = port.solve_batch(
        None, costs_device=torch.from_numpy(costs.astype(np.float32)),
        integer=True, max_cost=100,
    )
    _assert_same(got, want)
    for bi in range(B):
        r, c = scipy_lsa(costs[bi])
        assert got.objective[bi] == costs[bi][r, c].sum()


def test_stream_matches_solve_batch(jax_results):
    costs, want = jax_results["device"]
    other = _costs(44, integral=True)
    batches = [torch.from_numpy(x.astype(np.float32))
               for x in (costs, other, costs)]
    got = port.solve_batch_stream(batches, integer=True, max_cost=100,
                                  window=2)
    assert len(got) == 3
    _assert_same(got[0], want)
    _assert_same(got[2], want)
    single = port.solve_batch(None, costs_device=batches[1],
                              integer=True, max_cost=100)
    _assert_same(got[1], single)
    assert port.solve_batch_stream([]) == []


def test_maximize_and_float_eps():
    costs = _costs(45, integral=True)[:2]
    sol = port.solve_batch(costs, maximize=True, eps=1.0 / (N + 1),
                           integer=False, device="cpu")
    assert sol.eps.tolist() == [float(np.float32(1.0 / (N + 1)))] * 2
    for bi in range(2):
        r, c = scipy_lsa(costs[bi], maximize=True)
        assert abs(sol.objective[bi] - costs[bi][r, c].sum()) < 1e-6


@pytest.mark.parametrize("integral", [True, False])
def test_linear_sum_assignment_matches_scipy(integral):
    cost = _costs(46, integral)[0]
    rows, cols = port.linear_sum_assignment(cost, device="cpu")
    r, c = scipy_lsa(cost)
    np.testing.assert_array_equal(rows, np.arange(N))
    assert sorted(cols.tolist()) == list(range(N))
    got, want = cost[rows, cols].sum(), cost[r, c].sum()
    if integral:
        assert got == want
    else:
        assert abs(got - want) <= N * (1.0 / (N + 1))
    empty = port.linear_sum_assignment(np.zeros((0, 0)), device="cpu")
    assert all(x.size == 0 for x in empty)


def test_astype_index():
    sol = port.solve_batch(_costs(47, True)[:1], device="cpu")
    sol.person_to_object[0, 0] = port.UNASSIGNED
    u16 = sol.astype_index(np.uint16)
    assert u16.person_to_object.dtype == np.uint16
    assert u16.person_to_object[0, 0] == 65535
    np.testing.assert_array_equal(u16.person_to_object[0, 1:],
                                  sol.person_to_object[0, 1:])
    np.testing.assert_array_equal(u16.nits, sol.nits)
    with pytest.raises(ValueError, match="does not fit"):
        port.convert_indices(np.array([300], np.int32), np.uint8)


def test_value_error_probes():
    costs = _costs(48, True)
    with pytest.raises(ValueError, match="batch, num_rows"):
        port.solve_batch(costs[0], device="cpu")
    with pytest.raises(ValueError, match="num_rows must be"):
        port.solve_batch(np.zeros((1, 256, 128)), device="cpu")
    with pytest.raises(ValueError, match="pass costs"):
        port.solve_batch(None, device="cpu")
    with pytest.raises(ValueError, match="max_cost"):
        port.solve_batch(None, costs_device=torch.zeros((1, N, N)),
                         integer=True)
    with pytest.raises(ValueError, match="unknown solver"):
        port.solve_batch(costs, solver="hungarian", device="cpu")
    with pytest.raises(ValueError, match="match costs"):
        port.solve_batch(costs, costs_device=torch.zeros((1, N, N)),
                         device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        port.linear_sum_assignment(costs, device="cpu")
    with pytest.raises(ValueError, match="non-finite"):
        port.linear_sum_assignment(np.full((N, N), np.inf), device="cpu")
    with pytest.raises(ValueError, match="one shape"):
        port.solve_batch_stream([torch.zeros((1, N, N)),
                                 torch.zeros((2, N, N))])


def _rect(c):
    """[B, 128, 256] integer costs made from the square ones."""
    return np.concatenate([c, c[:, ::-1, ::-1] + 7.0], axis=2)


def _beyond_fused(c):
    """One float64 [1, 256, 256] instance: beyond the fused kernel's
    size limit as the test shrinks it."""
    top = np.concatenate([c[0], c[1] + 3.0], axis=1)
    return np.concatenate([top, top[::-1, ::-1] + 11.0], axis=0)[None]


@pytest.mark.parametrize(
    "call, matrices",
    [
        (lambda c: port.solve_batch(c, solver="forward", device="cpu"),
         lambda c: c),
        (lambda c: port.solve_batch(c, solver="khosla", device="cpu"),
         lambda c: c),
        (lambda c: port.solve_batch(_rect(c), device="cpu"), _rect),
        (lambda c: port.linear_sum_assignment(_rect(c)[0], device="cpu"),
         lambda c: _rect(c)[:1]),
        (lambda c: port.solve_batch(_beyond_fused(c), dtype=np.float64,
                                    device="cpu"), _beyond_fused),
        (lambda c: port.solve_batch(c + 0.5, dtype=np.float64,
                                    device="cpu"), lambda c: c + 0.5),
        (lambda c: port.solve_batch(c[:, :5, :5], device="cpu"),
         lambda c: c[:, :5, :5]),
        (lambda c: port.BatchedLAP(3, N, N, device="cpu").solve(c),
         lambda c: c),
    ],
    ids=["forward", "khosla", "rect-128x256", "lsa-128x256",
         "f64-beyond-fused-size", "f64", "off-tile-5x5", "BatchedLAP"],
)
def test_out_of_slice_requests_raise(call, matrices, monkeypatch):
    """The requests that the port's first versions refused with
    ``NotImplementedError`` (the forward and Khosla engines,
    rectangular instances, float64 values, shapes off the fused kernel's
    tiling, sizes beyond it, ``BatchedLAP``): each one is solved now,
    with nobody unassigned and an objective within ``n * eps`` above
    scipy's optimum (equal to it where eps < 1/n)."""
    from sparse_linear_assignment_tpu_torch import batch

    # a 256 x 256 instance then lies beyond the fused kernel's size
    monkeypatch.setattr(batch, "_FUSED_MAX_ELEMS", 128 * 128)
    monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 128 * 128)
    costs = _costs(49, True)
    out = call(costs)
    mats = matrices(costs)
    want = np.array([mat[scipy_lsa(mat)].sum() for mat in mats])
    if isinstance(out, tuple):  # linear_sum_assignment: eps = 1/(n+1)
        assert mats[0][out].sum() == want[0]
        return
    assert int(out.num_unassigned.sum()) == 0
    n = mats.shape[1]
    assert np.all(out.objective >= want)
    assert np.all(out.objective <= want + n * out.eps + 1e-6)
    if np.all(n * out.eps < 1):  # the integer lattice: exact
        np.testing.assert_array_equal(out.objective, want)


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.solve_batch(_costs(50, True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.linear_sum_assignment(_costs(50, True)[0])
