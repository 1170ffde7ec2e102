"""The port's arc Khosla kernel's plain version (``ops/ksparse_arcs.py``,
CPU tensors) against the rounds it must equal, bit for bit.

- ``ksp_arcs_chunk`` on arcs against ``ksp_chunk_reference`` on the
  densified plane of the same arcs (the plane keeps a repeated column's
  later slot): ``prices``, ``p2o``, ``dropped``, ``nits``, the rows read
  and the round trace, on seeded cases with unsorted slots, repeated
  columns (within 32 slots and across), single-arc persons, integer
  ties and an infeasible instance that drops;
- against ``khosla_round`` on the ``PaddedProblem`` of the same
  instance.  The padded form breaks ties by slot and reads the stored
  price where the plane reconstructs it as ``best_val - best``, so it
  is given each row's distinct columns in column order, and ε is a power
  of two, where every price is exact in float32 and the two prices
  agree.

The CUDA kernel is held against the same plain version on the card by
``chip_smoke.py``'s ``ksp_arcs`` phase.
"""

import numpy as np
import pytest
import torch

from sparse_linear_assignment_tpu_torch import batch
from sparse_linear_assignment_tpu_torch.ops import ksparse_arcs as ka
from sparse_linear_assignment_tpu_torch.ops import ksparse_kernel as kk
from sparse_linear_assignment_tpu_torch.ops.auction import khosla_round
from sparse_linear_assignment_tpu_torch.ops.padded import (
    PaddedProblem,
    build_padded_arrays,
)

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1
FIELDS = ("prices", "p2o", "dropped", "nits")


def make_arcs(seed, b=4, n=32, m=32, k=6, hi=40):
    """``[b, n, k]`` arcs over ``m`` objects in draw order (unsorted),
    values ``-[1, hi)`` (a minimisation, sign-adjusted): person 1 of
    instance 0 lists one column twice, person 2 has one arc; instance 2
    is infeasible (every person's only arc is object 0); in instance 3
    every person repeats its last slot's column at slot 2 (across 32
    slots when ``k > 32``).  Thresholds as the staging sets them, 0.5
    for instance 2 so that it drops within a few rounds."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.stack([rng.choice(m, size=k, replace=False)
                               for _ in range(n)])
                     for _ in range(b)]).astype(np.int32)
    vals = -rng.integers(1, hi, size=(b, n, k)).astype(np.float32)
    cols[0, 1, 1] = cols[0, 1, 0]
    cols[0, 2, 1:] = -1
    cols[2] = 0
    cols[2, :, 1:] = -1
    cols[3, :, 2] = cols[3, :, k - 1]
    thr = np.full(b, (m / 2.0) * (hi + 1.0 / m), np.float32)
    thr[2] = 0.5
    return torch.from_numpy(cols), torch.from_numpy(vals), \
        torch.from_numpy(thr)


def densify(cols, vals, m):
    """The person-major plane of the arcs, ``-inf`` at non-arcs, the
    later slot kept for a repeated column (as the staging scatters)."""
    b, n, k = cols.shape
    plane = torch.full((b, n, m), -np.inf, dtype=vals.dtype)
    for j in range(k):
        c = cols[:, :, j:j + 1]
        cj = c.clamp(min=0).long()
        plane.scatter_(2, cj, torch.where(c >= 0, vals[:, :, j:j + 1],
                                          plane.gather(2, cj)))
    return plane


def assert_same(got, want):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f


CASES = {
    "feasible": dict(m=32, k=6, hi=40),
    "integer-ties": dict(m=32, k=6, hi=3),
    "wide-rows": dict(n=48, m=96, k=40, hi=3),
    "m-much-larger": dict(n=64, m=4096, k=8, hi=3),
}


@pytest.mark.parametrize("rounds", [1, 3, 5000])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_arcs_match_the_plane_reference(case, seed, rounds):
    kw = CASES[case]
    cols, vals, thr = make_arcs(seed, **kw)
    m = kw["m"]
    eps = np.float32(1.0 / 32)
    plane = densify(cols, vals, m)
    b = cols.shape[0]
    rows_p = torch.zeros(b, dtype=torch.int64)
    rows_a = torch.zeros(b, dtype=torch.int64)
    want = kk.ksp_chunk_reference(plane, kk.khosla_init(plane), eps, thr,
                                  rounds, act_rows=rows_p)
    got = ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, m), eps, thr,
                            rounds, act_rows=rows_a)
    assert_same(got, want)
    assert torch.equal(rows_a, rows_p)
    assert int(rows_a.min()) >= cols.shape[1]  # the first round reads all
    if rounds == 5000:
        assert int(got.dropped[2].sum()) == cols.shape[1] - 1
        assert bool((got.p2o[[0, 1, 3]] != UNASSIGNED).all())


def test_trace_rows_match_the_plane_reference():
    cols, vals, thr = make_arcs(5, hi=3)
    eps = np.float32(1.0 / 32)
    plane = densify(cols, vals, 32)
    rounds = 40
    want = torch.zeros((4, rounds, 3), dtype=torch.int32)
    got = torch.full((4, rounds, 3), 7, dtype=torch.int32)
    kk.ksp_chunk_reference(plane, kk.khosla_init(plane), eps, thr, rounds,
                           trace_rows=want)
    ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, 32), eps, thr, rounds,
                      trace_rows=got)
    assert torch.equal(got, want)
    assert int(got[:, 0, 0].min()) == 1  # every instance ran round 1


def padded_batch(cols, vals, m):
    """The batched ``PaddedProblem`` of the arcs: each row's distinct
    columns in column order (a repeated column keeps its later slot's
    value), stacked as ``solve_batch_sparse(engine="padded")`` stacks."""
    b, n, _ = cols.shape
    probs = []
    for bi in range(b):
        counts, cs, vs = [], [], []
        for i in range(n):
            row = {}
            for c, v in zip(cols[bi, i].tolist(), vals[bi, i].tolist()):
                if c >= 0:
                    row[c] = v
            counts.append(len(row))
            for c in sorted(row):
                cs.append(c)
                vs.append(row[c])
        probs.append(build_padded_arrays(n, m, np.array(counts),
                                         np.array(cs), np.array(vs,
                                                                np.float32)))

    def stack(name, fill=0):
        kdim = max(p[name].shape[0] for p in probs)
        out = np.full((b, kdim) + probs[0][name].shape[1:], fill,
                      dtype=probs[0][name].dtype)
        for bi, p in enumerate(probs):
            out[bi, :p[name].shape[0]] = p[name]
        return torch.from_numpy(out)

    return PaddedProblem(stack("row_cols"), stack("row_vals"),
                         stack("row_mask", False), stack("col_persons"),
                         stack("col_mask", False))


@pytest.mark.parametrize("case", ["feasible", "integer-ties", "wide-rows"])
def test_arcs_match_padded_khosla_rounds(case):
    kw = CASES[case]
    cols, vals, thr = make_arcs(7, **kw)
    m = kw["m"]
    eps = np.float32(1.0 / 64)  # a power of two: every price exact
    problem = padded_batch(cols, vals, m)
    want = ka.arcs_init(vals, m)
    got = want
    for chunk in (1, 2, 5, 200):
        for _ in range(chunk):
            want = khosla_round(problem, want, eps, thr)
        got = ka.ksp_arcs_chunk(cols, vals, got, eps, thr, chunk)
        assert_same(got, want)
    assert int(got.dropped[2].sum()) == cols.shape[1] - 1


def test_continuation_and_mid_solve_entry():
    """Two chunks equal one; a chunk that enters mid-solve with an o2p
    that is noise passes it through; a state that enters done comes out
    unchanged."""
    cols, vals, thr = make_arcs(9, hi=3)
    eps = np.float32(1.0 / 32)
    s0 = ka.arcs_init(vals, 32)
    whole = ka.ksp_arcs_chunk(cols, vals, s0, eps, thr, 5000)
    part = ka.ksp_arcs_chunk(cols, vals, s0, eps, thr, 2)
    assert bool((part.p2o != UNASSIGNED).any())
    noise = torch.from_numpy(np.random.default_rng(9).integers(
        -1, 32, part.o2p.shape).astype(np.int32))
    part = ka.ksp_arcs_chunk(cols, vals, part._replace(o2p=noise), eps,
                             thr, 5000)
    assert_same(part, whole)
    assert torch.equal(part.o2p, noise)
    again = ka.ksp_arcs_chunk(cols, vals, whole, eps, thr, 64)
    assert_same(again, whole)


def test_later_repeat_marks_all_but_the_last_slot():
    cols = torch.tensor([[[3, 1, 3, -1, 3], [2, 0, 5, 0, -1]]],
                        dtype=torch.int32)
    got = ka.later_repeat(cols)
    assert got.tolist() == [[[True, False, True, False, False],
                             [False, True, False, False, False]]]


def test_float64_arcs_run_the_plain_rounds():
    cols, vals, thr = make_arcs(11)
    v64, t64 = vals.double(), thr.double()
    plane = densify(cols, v64, 32)
    want = kk.ksp_chunk_reference(plane, kk.khosla_init(plane), 1.0 / 32,
                                  t64, 5000)
    got = ka.ksp_arcs_chunk_reference(cols, v64, ka.arcs_init(v64, 32),
                                      1.0 / 32, t64, 5000)
    assert got.prices.dtype == torch.float64
    assert_same(got, want)


def test_wrapper_checks_its_arguments():
    cols, vals, thr = make_arcs(12)
    s0 = ka.arcs_init(vals, 32)
    eps = np.float32(1.0 / 32)
    with pytest.raises(ValueError, match="thresholds"):
        ka.ksp_arcs_chunk(cols, vals, s0, eps, thr[:2], 1)
    with pytest.raises(ValueError, match="int32"):
        ka.ksp_arcs_chunk(cols.long(), vals, s0, eps, thr, 1)
    with pytest.raises(ValueError, match=r"\[B, N, K\]"):
        ka.ksp_arcs_chunk(cols[:, :, :2], vals, s0, eps, thr, 1)
    with pytest.raises(ValueError, match="states.p2o"):
        ka.ksp_arcs_chunk(cols, vals, s0._replace(p2o=s0.p2o[:, :3]), eps,
                          thr, 1)
    with pytest.raises(ValueError, match="act_rows"):
        ka.ksp_arcs_chunk(cols, vals, s0, eps, thr, 1,
                          act_rows=torch.zeros(4))
    with pytest.raises(ValueError, match="trace_rows"):
        ka.ksp_arcs_chunk(cols, vals, s0, eps, thr, 2,
                          trace_rows=torch.zeros((4, 3, 3),
                                                 dtype=torch.int32))
    n_phases = len(ka.PHASES)
    for kw in ({"phase_cycles": torch.zeros(n_phases, dtype=torch.int64)},
               {"stamps": torch.zeros((4, 2), dtype=torch.int64)}):
        with pytest.raises(ValueError, match="plain version has none"):
            ka.ksp_arcs_chunk(cols, vals, s0, eps, thr, 1, **kw)
    meta = [x.to("meta") for x in (cols, vals, thr)]
    ms0 = type(s0)(*(x.to("meta") for x in s0))
    with pytest.raises(ValueError, match="runs on cpu or cuda, not meta"):
        ka.ksp_arcs_chunk(meta[0], meta[1], ms0, eps, meta[2], 1)
    assert ka.LAUNCHES == 0  # CPU tensors never launch


def test_shared_memory_sizes_and_the_route_limit():
    """The plane kernel takes 128 persons up to 19,189 objects; at
    19,200 (232,576 bytes) the arcs take the batch."""
    assert kk.smem_bytes(128, 19_200) == 232_576 > kk.MAX_SMEM_BYTES
    assert batch._plane_fits(128, 19_168)
    assert not batch._plane_fits(128, 19_200)
    assert not batch._plane_fits(2_000, 39_424)  # the crate's bench


def livelock_case(dtype):
    """Two persons, three objects, the crate's value range and ε: both
    want object 0, each with a gap of 39 to its own second object (1 and
    2).  In float32, ``-369 - (39 + 1/60,000)`` rounds to ``-408``: the
    price's ε is lost, object 0 ties with the second object, wins on
    the smaller column, and the two take it from each other at the same
    price every round."""
    cols = torch.tensor([[[0, 1], [0, 2]]], dtype=torch.int32)
    vals = torch.tensor([[[-369.0, -408.0], [-336.0, -375.0]]], dtype=dtype)
    thr = torch.tensor([1.5 * (72.0 + 1 / 60_000)], dtype=dtype)
    eps = (np.float32 if dtype == torch.float32 else np.float64)(1 / 60_000)
    return cols, vals, thr, eps


def test_float32_livelock_that_float64_resolves():
    cols, vals, thr, eps = livelock_case(torch.float32)
    plane = densify(cols, vals, 3)
    stuck = ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, 3), eps, thr,
                              500)
    assert_same(stuck, kk.ksp_chunk_reference(plane, kk.khosla_init(plane),
                                              eps, thr, 500))
    assert int(stuck.nits) == 500 and int((stuck.p2o == UNASSIGNED).sum()) == 1
    assert float(stuck.prices[0, 0]) == np.float32(39 + 1 / 60_000)
    assert not ka.resolves(eps, 408.0)

    cols, vals, thr, eps = livelock_case(torch.float64)
    done = ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, 3), eps, thr,
                             500)
    assert done.p2o.tolist() == [[0, 2]] and int(done.nits) == 2
    plane = densify(cols, vals, 3)
    assert_same(done, kk.ksp_chunk_reference(plane, kk.khosla_init(plane),
                                             eps, thr, 500))


def test_float32_resolution_rule():
    """float32 keeps ε where ε is at least its spacing at twice the
    largest |value|: the small tests' ε = 1/32 over values below 40 does;
    the crate's 1/60,000 over values to 999 does not."""
    assert ka.resolves(1 / 32, 39.0) and ka.resolves(1 / 256, 59.0)
    assert not ka.resolves(1 / 60_000, 999.0)
    assert ka.resolves(2.0 ** -13, 1023.0)  # the spacing at 2046
    assert not ka.resolves(2.0 ** -14, 1023.0)
    assert ka.resolves(1e-9, 0.0)
