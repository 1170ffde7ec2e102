"""The port's ``ksp_chunk`` (plain version, CPU tensors) against the JAX
package's ``ksp_chunk_pallas`` run in interpret mode.

Inputs come from NumPy seeds; ``prices``, ``p2o``, ``o2p``, ``dropped``
and ``nits`` must be bit-identical (tolerance 0).  The CUDA kernel is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu.ops.auction import KhoslaState as JState
from sparse_linear_assignment_tpu.ops.pallas_ksparse import ksp_chunk_pallas
from sparse_linear_assignment_tpu_torch.ops import ksparse_kernel
from sparse_linear_assignment_tpu_torch.ops.auction import (
    khosla_state_from_jax,
    khosla_state_to_numpy,
)

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1
B, N, K = 4, 16, 4


def make_plane(seed, m_used, width, hi=40, n=N):
    """Person-major ``[B, n, width]`` float32 plane whose arcs lie in the
    first ``m_used`` columns.  Instance 1 is tie-heavy, instance 2
    infeasible (every person's only arc is object 0), and person 0 of
    instance 0 has a single arc."""
    rng = np.random.default_rng(seed)
    plane = np.full((B, n, width), -np.inf, dtype=np.float32)
    for bi in range(B):
        top = 3 if bi == 1 else hi
        for i in range(n):
            cols = rng.choice(m_used, size=K, replace=False)
            if bi == 2:
                cols = np.array([0])
            elif bi == 0 and i == 0:
                cols = cols[:1]
            plane[bi, i, cols] = -rng.integers(1, top, size=cols.size)
    thresholds = np.full(B, (m_used / 2.0) * (hi + 0.5 / n), np.float32)
    thresholds[2] = 0.1  # the drop rule fires within a few rounds
    return plane, np.float32(0.5 / n), thresholds


def jax_init(b, n, m):
    return JState(
        prices=jnp.zeros((b, m), jnp.float32),
        p2o=jnp.full((b, n), jnp.int32(UNASSIGNED)),
        o2p=jnp.full((b, m), jnp.int32(UNASSIGNED)),
        dropped=jnp.zeros((b, n), bool),
        nits=jnp.zeros((b,), jnp.int32),
    )


def np_fields(state):
    return {k: np.asarray(getattr(state, k)) for k in state._fields}


def assert_equal_states(got, want, width=None):
    """Bit-equality of every field; ``width`` cuts the object axis of
    the wider state to the narrower plane."""
    for name in JState._fields:
        g, w = got[name], want[name]
        if width is not None and name in ("prices", "o2p"):
            assert not w[:, width:].any() or name == "o2p"
            w = w[:, :width]
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("rounds", [1, 3, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_ksp_chunk_matches_pallas_interpret(seed, rounds):
    plane, eps, thresholds = make_plane(seed, 128, 128)
    js0 = jax_init(B, N, 128)
    want = ksp_chunk_pallas(jnp.asarray(plane), js0, eps,
                            jnp.asarray(thresholds), rounds, interpret=True)
    ts0 = khosla_state_from_jax(np_fields(js0), device="cpu")
    rows = torch.zeros(B, dtype=torch.int64)
    got = ksparse_kernel.ksp_chunk(
        torch.from_numpy(plane), ts0, eps, torch.from_numpy(thresholds),
        rounds, act_rows=rows,
    )
    assert_equal_states(khosla_state_to_numpy(got), np_fields(want))
    assert int(rows.min()) >= N  # the first round reads every row
    if rounds == 64:
        p2o = np.asarray(want.p2o)
        assert (p2o[[0, 1, 3]] != UNASSIGNED).all()
        assert int(np.asarray(want.dropped)[2].sum()) == N - 1
        assert int(np.asarray(want.nits).max()) < 64


def test_continuation_and_done_at_entry():
    """Two chunks equal one; a state that enters done comes out
    unchanged, ``nits`` included."""
    plane, eps, thresholds = make_plane(2, 128, 128)
    tv, tt = torch.from_numpy(plane), torch.from_numpy(thresholds)
    s0 = ksparse_kernel.khosla_init(tv)
    whole = ksparse_kernel.ksp_chunk(tv, s0, eps, tt, 64)
    part = ksparse_kernel.ksp_chunk(tv, s0, eps, tt, 2)
    part = ksparse_kernel.ksp_chunk(tv, part, eps, tt, 62)
    assert_equal_states(khosla_state_to_numpy(part),
                        khosla_state_to_numpy(whole))

    jdone = JState(**{k: jnp.asarray(v) for k, v in
                      khosla_state_to_numpy(whole).items()})
    want = ksp_chunk_pallas(jnp.asarray(plane), jdone, eps,
                            jnp.asarray(thresholds), 64, interpret=True)
    again = ksparse_kernel.ksp_chunk(tv, whole, eps, tt, 64)
    assert_equal_states(khosla_state_to_numpy(again), np_fields(want))
    assert_equal_states(khosla_state_to_numpy(again),
                        khosla_state_to_numpy(whole))


@pytest.mark.parametrize("rounds", [2, 64])
def test_narrow_plane_matches_power_of_two_plane(rounds):
    """The port's plane is a warp multiple wide (160 here), JAX's a power
    of two (256): padding columns are never bid, so the states agree on
    the shared columns and JAX's extra columns keep price 0."""
    wide, eps, thresholds = make_plane(5, 150, 256)
    narrow = np.ascontiguousarray(wide[:, :, :160])
    want = ksp_chunk_pallas(jnp.asarray(wide), jax_init(B, N, 256), eps,
                            jnp.asarray(thresholds), rounds, interpret=True)
    tv = torch.from_numpy(narrow)
    got = ksparse_kernel.ksp_chunk(
        tv, ksparse_kernel.khosla_init(tv), eps,
        torch.from_numpy(thresholds), rounds,
    )
    assert_equal_states(khosla_state_to_numpy(got), np_fields(want),
                        width=160)


@pytest.mark.parametrize("rounds", [1, 3, 64])
def test_square_plane_matches_pallas_interpret(rounds):
    """N == M' (128 persons, 128 objects): most bids displace an owner,
    the case the kernel's resting keys serve."""
    n = 128
    plane, eps, thresholds = make_plane(9, n, n, n=n)
    want = ksp_chunk_pallas(jnp.asarray(plane), jax_init(B, n, n), eps,
                            jnp.asarray(thresholds), rounds, interpret=True)
    tv = torch.from_numpy(plane)
    rows = torch.zeros(B, dtype=torch.int64)
    got = ksparse_kernel.ksp_chunk(
        tv, ksparse_kernel.khosla_init(tv), eps,
        torch.from_numpy(thresholds), rounds, act_rows=rows,
    )
    assert_equal_states(khosla_state_to_numpy(got), np_fields(want))
    assert int(rows.min()) >= n


@pytest.mark.parametrize("rounds", [2, 64])
def test_narrowest_plane_matches_pallas_interpret(rounds):
    """The narrowest staged plane, one warp wide (32 values), against
    JAX's 128-wide plane with the same arcs: the extra columns are never
    bid and keep price 0."""
    wide, eps, thresholds = make_plane(10, 32, 128)
    narrow = np.ascontiguousarray(wide[:, :, :32])
    want = ksp_chunk_pallas(jnp.asarray(wide), jax_init(B, N, 128), eps,
                            jnp.asarray(thresholds), rounds, interpret=True)
    tv = torch.from_numpy(narrow)
    got = ksparse_kernel.ksp_chunk(
        tv, ksparse_kernel.khosla_init(tv), eps,
        torch.from_numpy(thresholds), rounds,
    )
    assert_equal_states(khosla_state_to_numpy(got), np_fields(want),
                        width=32)


@pytest.mark.parametrize("seed", [11, 12])
def test_mid_solve_continuation_matches_pallas_interpret(seed):
    """A chunk that enters mid-solve, with assigned persons and an o2p
    that is noise (the kernel rebuilds its owners from p2o and passes
    o2p through): chunks of 1, 1, 3 and 64 rounds, every checkpoint
    bit-equal to JAX's."""
    plane, eps, thresholds = make_plane(seed, 128, 128)
    jv, jt = jnp.asarray(plane), jnp.asarray(thresholds)
    start = np_fields(ksp_chunk_pallas(jv, jax_init(B, N, 128), eps, jt, 2,
                                       interpret=True))
    start["o2p"] = np.random.default_rng(seed).integers(
        -1, N, start["o2p"].shape).astype(np.int32)
    assert (start["p2o"] != UNASSIGNED).any()
    assert ((start["p2o"] == UNASSIGNED) & ~start["dropped"]).any()
    want = JState(**{k: jnp.asarray(v) for k, v in start.items()})
    got = khosla_state_from_jax(start, device="cpu")
    tv, tt = torch.from_numpy(plane), torch.from_numpy(thresholds)
    for chunk in (1, 1, 3, 64):
        want = ksp_chunk_pallas(jv, want, eps, jt, chunk, interpret=True)
        got = ksparse_kernel.ksp_chunk(tv, got, eps, tt, chunk)
        assert_equal_states(khosla_state_to_numpy(got), np_fields(want))
    np.testing.assert_array_equal(got.o2p.numpy(), start["o2p"])


def test_ksp_chunk_checks_its_counter_arguments():
    """``phase_cycles`` and ``stamps`` read the CUDA kernel's clocks: on
    CPU tensors they raise; elsewhere each must be a contiguous int64
    tensor of its shape on the values' device (checked on the meta
    device, which runs nothing)."""
    plane, eps, thresholds = make_plane(13, 128, 128)
    tv, tt = torch.from_numpy(plane), torch.from_numpy(thresholds)
    s0 = ksparse_kernel.khosla_init(tv)
    n_phases = len(ksparse_kernel.PHASES)
    assert ksparse_kernel.PHASES[-2:] == ("total", "rounds")
    for kw in ({"phase_cycles": torch.zeros(n_phases, dtype=torch.int64)},
               {"stamps": torch.zeros((B, 2), dtype=torch.int64)}):
        with pytest.raises(ValueError, match="plain version has none"):
            ksparse_kernel.ksp_chunk(tv, s0, eps, tt, 1, **kw)
    mv, mt = tv.to("meta"), tt.to("meta")
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
            ksparse_kernel.ksp_chunk(mv, ms0, eps, mt, 1, **kw)
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        ksparse_kernel.ksp_chunk(mv, ms0, eps, mt, 1,
                                 phase_cycles=meta(n_phases),
                                 stamps=meta((B, 2)))
    assert ksparse_kernel.LAUNCHES == 0  # CPU tensors never launch


def test_float64_plane_runs_the_plain_rounds():
    plane, eps, thresholds = make_plane(6, 128, 128)
    tv = torch.from_numpy(plane.astype(np.float64))
    tt = torch.from_numpy(thresholds.astype(np.float64))
    got = ksparse_kernel.ksp_chunk_reference(
        tv, ksparse_kernel.khosla_init(tv), float(eps), tt, 64)
    assert got.prices.dtype == torch.float64
    assert bool((got.p2o[[0, 1, 3]] != UNASSIGNED).all())


def test_state_carrier_round_trip():
    plane, eps, thresholds = make_plane(7, 128, 128)
    want = np_fields(ksp_chunk_pallas(
        jnp.asarray(plane), jax_init(B, N, 128), eps,
        jnp.asarray(thresholds), 3, interpret=True))
    back = khosla_state_to_numpy(khosla_state_from_jax(want, device="cpu"))
    assert_equal_states(back, want)


def test_wrapper_rejects_bad_shapes():
    plane, eps, thresholds = make_plane(8, 128, 128)
    tv = torch.from_numpy(plane)
    s0 = ksparse_kernel.khosla_init(tv)
    with pytest.raises(ValueError, match="thresholds"):
        ksparse_kernel.ksp_chunk(tv, s0, eps,
                                 torch.from_numpy(thresholds[:2]), 1)
    with pytest.raises(ValueError, match="act_rows"):
        ksparse_kernel.ksp_chunk(tv, s0, eps, torch.from_numpy(thresholds),
                                 1, act_rows=torch.zeros(B))
    assert ksparse_kernel.smem_bytes(128, 512) == 12 * 512 + 17 * 128
    assert ksparse_kernel.smem_bytes(128, 19_000) < \
        ksparse_kernel.MAX_SMEM_BYTES
