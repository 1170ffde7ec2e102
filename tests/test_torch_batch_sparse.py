"""The port's batched sparse mode against the JAX package's, on the CPU.

Inputs come from NumPy seeds and go through both packages; the port runs
with ``device="cpu"`` (the kernel's plain version), the JAX package with
its Khosla kernel in interpret mode (``_SPARSE_KERNEL_INTERPRET_ON_CPU``,
set and reset around the call) or on its XLA rounds.  Tolerance: 0 on
``person_to_object``, ``object_to_person``, ``nits`` and
``num_unassigned``; 1e-9 on objectives; scipy is the oracle of feasible
instances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import sparse_linear_assignment_tpu.batch as jbatch
import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch import batch as tbatch
from sparse_linear_assignment_tpu_torch.ops.ksparse_kernel import PLANE_ALIGN

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1


def make_arcs(seed, b, n, m, k, hi=40):
    rng = np.random.default_rng(seed)
    columns = np.stack([
        np.stack([rng.choice(m, size=k, replace=False) for _ in range(n)])
        for _ in range(b)
    ]).astype(np.int32)
    values = rng.integers(1, hi, size=(b, n, k)).astype(np.float64)
    return columns, values


def jax_kernel_route(fn, *args, **kwargs):
    """Run a JAX batch function with the Khosla kernel in interpret
    mode, as the JAX package's own tests do."""
    jbatch._SPARSE_KERNEL_INTERPRET_ON_CPU = True
    try:
        return fn(*args, **kwargs)
    finally:
        jbatch._SPARSE_KERNEL_INTERPRET_ON_CPU = False


def assert_same_solution(got, want):
    np.testing.assert_array_equal(got.person_to_object,
                                  want.person_to_object)
    np.testing.assert_array_equal(got.object_to_person,
                                  want.object_to_person)
    np.testing.assert_array_equal(got.nits, want.nits)
    np.testing.assert_array_equal(got.num_unassigned, want.num_unassigned)
    np.testing.assert_allclose(got.objective, want.objective, rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(got.eps, want.eps)


def scipy_objective(columns, values, m, maximize=False):
    n = columns.shape[0]
    full = np.full((n, m), -1e9 if maximize else 1e9)
    for i in range(n):
        real = columns[i] >= 0
        full[i, columns[i][real]] = values[i][real]
    r, c = linear_sum_assignment(full, maximize=maximize)
    return full[r, c].sum()


# ----------------------------------------------------------------------
# staging
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed,b,n,m,k", [(1, 4, 16, 96, 4),
                                          (2, 3, 10, 300, 6)])
def test_densify_matches_jax_on_the_used_columns(seed, b, n, m, k):
    columns, values = make_arcs(seed, b, n, m, k)
    columns[1, 0, 1:] = -1  # a person with one arc
    arc_mask = columns >= 0
    work = -values
    plane, used, counts = tbatch._sparse_densify(
        columns, arc_mask, work, m, np.float32)
    jplane, jused, jcounts = jbatch._sparse_densify(
        columns, arc_mask, work, m, np.float32, person_major=True)
    np.testing.assert_array_equal(counts, jcounts)
    width = plane.shape[2]
    assert width % PLANE_ALIGN == 0
    assert counts.max() <= width < counts.max() + PLANE_ALIGN
    assert width <= jplane.shape[2]
    np.testing.assert_array_equal(plane, jplane[:, :, :width])
    assert np.isneginf(jplane[:, :, width:]).all()
    np.testing.assert_array_equal(used, jused[:, :width])
    for bi in range(b):
        want = np.unique(columns[bi][arc_mask[bi]])
        np.testing.assert_array_equal(used[bi, :counts[bi]], want)


def test_remap_host_matches_jax():
    columns, _ = make_arcs(3, 3, 16, 512, 4)
    columns[0, 2, 2:] = -1
    cols_local, used, mp = tbatch._sparse_remap_host(columns, 512)
    jlocal, jused, jmp = jbatch._sparse_remap_host(columns, 512)
    np.testing.assert_array_equal(cols_local, jlocal)
    assert mp % PLANE_ALIGN == 0 and mp <= jmp
    np.testing.assert_array_equal(used, jused[:, :mp])
    real = columns >= 0
    back = np.take_along_axis(
        used, np.where(real, cols_local, 0).reshape(3, -1).astype(np.int64),
        axis=1).reshape(columns.shape)
    np.testing.assert_array_equal(back[real], columns[real])
    assert (cols_local[~real] == -1).all()


def test_duplicated_column_keeps_the_last_slot_on_both_paths():
    columns = np.array([[[3, 1, 3], [2, 0, -1]]], dtype=np.int32)
    values = np.array([[[5.0, 7.0, 9.0], [4.0, 6.0, 0.0]]])
    arc_mask = columns >= 0
    plane, used, _ = tbatch._sparse_densify(
        columns, arc_mask, values, 8, np.float32)
    local3 = int(np.nonzero(used[0] == 3)[0][0])
    assert plane[0, 0, local3] == 9.0
    jplane, _, _ = jbatch._sparse_densify(
        columns, arc_mask, values, 8, np.float32, person_major=True)
    assert jplane[0, 0, local3] == 9.0

    dplane, w_lo, w_hi = tbatch._sparse_stage_scatter(
        torch.from_numpy(columns), torch.from_numpy(values).float(), 8,
        False)
    assert float(dplane[0, 0, 3]) == 9.0
    assert float(dplane[0, 0, 1]) == 7.0
    assert float(dplane[0, 1, 0]) == 6.0  # the pad did not overwrite it
    assert int(torch.isfinite(dplane).sum()) == 4
    assert (float(w_lo[0]), float(w_hi[0])) == (4.0, 9.0)
    jd, _, _ = jbatch._sparse_stage_scatter(
        jnp.asarray(columns), jnp.asarray(values, jnp.float32), 8, False)
    np.testing.assert_array_equal(dplane.numpy(), np.asarray(jd))


# ----------------------------------------------------------------------
# solve_batch_sparse against JAX and scipy
# ----------------------------------------------------------------------
@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("hook", [True, False])
def test_solve_batch_sparse_matches_jax_and_scipy(hook, maximize):
    b, n, m, k = 5, 16, 96, 4
    columns, values = make_arcs(31, b, n, m, k)
    columns[3, 5, 2:] = -1  # variable arc counts
    kwargs = dict(maximize=maximize, eps=0.5 / n, engine="dense")
    if hook:
        want = jax_kernel_route(jbatch.solve_batch_sparse, columns, values,
                                m, **kwargs)
    else:
        want = jbatch.solve_batch_sparse(columns, values, m, **kwargs)
    got = port.solve_batch_sparse(columns, values, m, device="cpu",
                                  **kwargs)
    assert_same_solution(got, want)
    assert got.num_unassigned.sum() == 0
    for bi in range(b):
        assert got.objective[bi] == scipy_objective(
            columns[bi], values[bi], m, maximize)
        for i, j in enumerate(got.person_to_object[bi]):
            assert j in columns[bi, i]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_drop_rule_on_a_batch_with_an_infeasible_instance(dtype):
    """Instance 2: every person's only arc is object 0.  The drop rule
    ends it with one owner; the port matches JAX's XLA rounds (both
    dtypes) bit for bit."""
    b, n, m, k = 4, 16, 96, 4
    columns, values = make_arcs(32, b, n, m, k, hi=5)
    columns[2] = 0
    columns[2, :, 1:] = -1
    want = jbatch.solve_batch_sparse(columns, values, m, eps=0.5,
                                     dtype=dtype, engine="dense")
    got = port.solve_batch_sparse(columns, values, m, eps=0.5, dtype=dtype,
                                  engine="dense", device="cpu")
    assert_same_solution(got, want)
    assert got.num_unassigned[2] == n - 1
    assert got.nits[2] > 64  # it needed continuation chunks
    if dtype == np.float32:
        hooked = jax_kernel_route(jbatch.solve_batch_sparse, columns,
                                  values, m, eps=0.5, engine="dense")
        assert_same_solution(got, hooked)


@pytest.mark.parametrize(
    "columns,values,m,eps,unassigned,objective0",
    [
        # two persons share one object; -1 pads
        ([[[0, 1], [1, -1]], [[0, -1], [0, -1]]],
         [[[1.0, 2.0], [3.0, 0.0]], [[1.0, 0.0], [2.0, 0.0]]],
         2, 0.25, [0, 1], 4.0),
        # odd N
        ([[[0, 1], [1, 2], [2, -1]], [[0, -1], [0, -1], [1, 2]]],
         [[[1.0, 2.0], [3.0, 1.0], [2.0, 0.0]],
          [[1.0, 0.0], [2.0, 0.0], [1.0, 5.0]]],
         3, 0.2, [0, 1], 6.0),
    ],
)
def test_small_infeasible_cases(columns, values, m, eps, unassigned,
                                objective0):
    columns = np.array(columns, dtype=np.int32)
    values = np.array(values)
    want = jbatch.solve_batch_sparse(columns, values, m, eps=eps,
                                     engine="dense")
    for engine in ("dense", "auto"):
        got = port.solve_batch_sparse(columns, values, m, eps=eps,
                                      engine=engine, device="cpu")
        assert_same_solution(got, want)
        assert got.num_unassigned.tolist() == unassigned
        assert abs(got.objective[0] - objective0) < 1e-9


# ----------------------------------------------------------------------
# device staging, stream
# ----------------------------------------------------------------------
@pytest.mark.parametrize("maximize", [False, True])
@pytest.mark.parametrize("compact", [None, True])
def test_device_staging_matches_jax(compact, maximize):
    b, n, m, k = 3, 16, 128, 4
    columns, values = make_arcs(44, b, n, m, k, hi=60)
    columns[1, 3, 1:] = -1

    def jax_solve():
        cols = columns if compact else jnp.asarray(columns)
        st = jbatch.stage_batch_sparse_device(
            cols, jnp.asarray(values, jnp.float32), m, maximize=maximize,
            eps=0.5 / n, compact=compact)
        return st, jbatch._sparse_finish(
            st, jbatch._sparse_dispatch(st, 16), 10_000_000)

    jst, want = jax_kernel_route(jax_solve)
    st = port.stage_batch_sparse_device(
        columns, values.astype(np.float32), m, maximize=maximize,
        eps=0.5 / n, compact=compact, device="cpu")
    assert st.device_mode and st.values_nm.dtype == torch.float32
    np.testing.assert_array_equal(st.thresholds.numpy(),
                                  np.asarray(jst.thresholds))
    width = st.values_nm.shape[2]
    np.testing.assert_array_equal(st.values_nm.numpy(),
                                  np.asarray(jst.values_t)[:, :, :width])
    if compact:
        assert width < m and width % PLANE_ALIGN == 0
    else:
        assert width == m and st.used_cols is None
    got = tbatch._sparse_solve_staged(st, 10_000_000, 16)
    assert_same_solution(got, want)
    for bi in range(b):
        assert got.objective[bi] == scipy_objective(
            columns[bi], values[bi], m, maximize)
    # the host-staged path gives the same matching
    host = port.solve_batch_sparse(columns, values, m, maximize=maximize,
                                   eps=0.5 / n, engine="dense",
                                   device="cpu")
    np.testing.assert_array_equal(got.person_to_object,
                                  host.person_to_object)
    np.testing.assert_array_equal(got.nits, host.nits)


def test_device_staging_takes_tensors_and_any_shape():
    """Tensors keep their device; N % 8 and num_cols % 128 are not
    required by the port (they were tile facts of the TPU kernel)."""
    b, n, m, k = 2, 6, 20, 3
    columns, values = make_arcs(45, b, n, m, k)
    st = port.stage_batch_sparse_device(
        torch.from_numpy(columns), torch.from_numpy(values).float(), m,
        eps=0.5 / n)
    assert st.values_nm.device.type == "cpu"
    assert tuple(st.values_nm.shape) == (b, n, m)
    got = tbatch._sparse_solve_staged(st, 10_000_000, 16)
    for bi in range(b):
        assert got.objective[bi] == scipy_objective(columns[bi], values[bi],
                                                    m)
    with pytest.raises(ValueError, match="host column arrays"):
        port.stage_batch_sparse_device(
            torch.from_numpy(columns), torch.from_numpy(values).float(), m,
            compact=True)


def test_device_staging_rejects_arcless_persons():
    """The JAX package's ``stage_batch_sparse_device`` accepts a person
    with no arc (a known defect: the row turns NaN, is never dropped and
    runs to ``max_rounds``); the port rejects it with the host path's
    error."""
    columns, values = make_arcs(46, 2, 8, 128, 3)
    columns[1, 4] = -1
    with pytest.raises(ValueError, match="at least one arc"):
        port.stage_batch_sparse_device(columns, values.astype(np.float32),
                                       128, device="cpu")
    with pytest.raises(ValueError, match="at least one arc"):
        port.stage_batch_sparse(columns, values, 128, device="cpu")
    with pytest.raises(ValueError, match="at least one arc"):
        jbatch.stage_batch_sparse(columns, values, 128)
    jst = jbatch.stage_batch_sparse_device(
        jnp.asarray(columns), jnp.asarray(values, jnp.float32), 128)
    assert jst.device_mode  # the reference does not reject it
    columns[1, 4] = 128
    with pytest.raises(ValueError, match="below num_cols"):
        port.stage_batch_sparse_device(columns, values.astype(np.float32),
                                       128, device="cpu")


def test_stream_equals_per_call_solves():
    n, m, k = 16, 64, 4
    batches = [make_arcs(9 + b, b, n, m, k, hi=30) for b in (3, 5, 2)]
    staged = [port.stage_batch_sparse(c, v, m, eps=0.5 / n, device="cpu")
              for c, v in batches]
    stream = port.solve_batch_sparse_stream(staged, window=2)
    per_call = [port.solve_batch_sparse(c, v, m, eps=0.5 / n,
                                        engine="dense", device="cpu")
                for c, v in batches]
    jstream = jax_kernel_route(
        lambda: jbatch.solve_batch_sparse_stream(
            [jbatch.stage_batch_sparse(c, v, m, eps=0.5 / n)
             for c, v in batches], window=2))
    assert len(stream) == 3
    for s, p, j in zip(stream, per_call, jstream):
        assert_same_solution(s, p)
        assert_same_solution(s, j)
    assert port.solve_batch_sparse_stream([]) == []
    one = port.solve_batch_sparse_stream(staged[:1], window=0)
    assert_same_solution(one[0], per_call[0])


# ----------------------------------------------------------------------
# routes and errors
# ----------------------------------------------------------------------
def test_padded_engine_raises_naming_its_roadmap_item():
    """``engine="padded"`` no longer raises: the padded dual-layout
    gather rounds solve, equal to the JAX package's padded engine; an
    unknown engine still raises."""
    columns, values = make_arcs(50, 2, 8, 32, 3)
    got = port.solve_batch_sparse(columns, values, 32, engine="padded",
                                  device="cpu")
    want = jbatch.solve_batch_sparse(columns, values, 32, engine="padded")
    assert_same_solution(got, want)
    assert got.num_unassigned.sum() == 0
    with pytest.raises(ValueError, match="unknown engine"):
        port.solve_batch_sparse(columns, values, 32, engine="csr",
                                device="cpu")


def test_auto_route_estimates_the_ports_plane_width(monkeypatch):
    """``engine="auto"`` sizes the plane as the port stages it (a warp
    multiple of min(m, n*k) columns) and takes the dense route when it
    fits, also on the CPU; over the limit it takes the padded engine,
    which gives the same matching here."""
    assert tbatch._plane_width(1) == PLANE_ALIGN
    assert tbatch._plane_width(32) == 32
    assert tbatch._plane_width(33) == 64
    assert tbatch._plane_width(1295) == 1312
    b, n, m, k = 2, 8, 1000, 3
    columns, values = make_arcs(51, b, n, m, k)
    est = b * tbatch._plane_width(n * k) * n * 4
    monkeypatch.setattr(tbatch, "_SPARSE_DENSE_MAX_BYTES_CPU", est)
    dense = port.solve_batch_sparse(columns, values, m, device="cpu")
    assert dense.num_unassigned.sum() == 0
    monkeypatch.setattr(tbatch, "_SPARSE_DENSE_MAX_BYTES_CPU", est - 1)
    taken = []
    real = tbatch._solve_batch_sparse_padded
    monkeypatch.setattr(tbatch, "_solve_batch_sparse_padded",
                        lambda *a: taken.append(1) or real(*a))
    padded = port.solve_batch_sparse(columns, values, m, device="cpu")
    assert taken == [1]
    assert padded.num_unassigned.sum() == 0
    np.testing.assert_array_equal(padded.objective, dense.objective)
    want = jbatch.solve_batch_sparse(columns, values, m, engine="padded")
    assert_same_solution(padded, want)


def test_entry_points_validate_their_arguments():
    columns, values = make_arcs(52, 2, 8, 32, 3)
    with pytest.raises(ValueError, match=r"\[B, N, K\]"):
        port.solve_batch_sparse(columns[0], values[0], 32, device="cpu")
    with pytest.raises(ValueError, match="num_rows"):
        port.solve_batch_sparse(columns % 4, values, 4, device="cpu")
    with pytest.raises(ValueError, match="num_rows"):
        port.stage_batch_sparse_device(columns % 4,
                                       values.astype(np.float32), 4,
                                       device="cpu")
    with pytest.raises(ValueError, match="below num_cols"):
        port.solve_batch_sparse(columns, values, 16, device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    columns, values = make_arcs(53, 2, 8, 32, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.solve_batch_sparse(columns, values, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.stage_batch_sparse(columns, values, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.stage_batch_sparse_device(columns, values.astype(np.float32),
                                       32)
