"""The eps-scaling ladder of the batched sparse entry points
(``scale_eps``; ``ops/ksparse_arcs.py``'s ``ksp_arcs_ladder``).

- CPU: seeded square batches (4 instances of 64 to 256 persons, density
  0.04, values U[500, 1000) in float32 from the benchmark's config A
  generator, ε = 2^-15 / (n + 1)) through ``solve_batch_sparse`` and
  through ``stage_batch_sparse_device`` with
  ``solve_batch_sparse_stream``: matchings and objectives equal, exactly,
  the plain reference (``benchmark/reference/sparse_ladder.py``) and
  scipy's ``linear_sum_assignment`` on the dense costs; rounds by phase
  sum to ``nits``; the fixed-ε route unchanged without ``scale_eps``; a
  rectangular batch runs one phase; a stopped ladder continues where it
  stopped; the counters in a profiler's trace; the burst rounds (a round
  of at most ``PERSONS`` active persons over rows of at most ``SLOTS``
  slots, ``ksparse_arcs.burst_rule``) counted round by round, none past
  that width.
- Card (``card`` marker, skipped without a CUDA device): the ladder
  kernel bit-equal to its plain version (prices, ``p2o``, ``nits``, the
  ladder's state, rounds by phase, burst rounds), whole and continued,
  on rows of one chunk to one past the widest burst.  No JAX here:
  on the card run ``python -m pytest --noconftest
  tests/test_torch_sparse_ladder.py -m card``.
"""

import json

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import sparse_linear_assignment_tpu_torch as port
from benchmark import plugins
from benchmark.reference import sparse_ladder as reference
from sparse_linear_assignment_tpu_torch import batch
from sparse_linear_assignment_tpu_torch.ops import ksparse_arcs as ka
from sparse_linear_assignment_tpu_torch.utils import trace

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1
CONFIG = {"density": 0.04, "value_low": 500, "value_high": 1000}
STATE = ("prices", "p2o", "dropped", "nits")
#: the kernel's burst rule: active persons and slots a row at most
PERSONS, SLOTS = ka.burst_rule()


def square(seed, n, b=4, k=48, config=CONFIG, device="cpu"):
    """``b`` instances of the config A law at side ``n``, on ``device``."""
    gen = plugins.load_module("gen", "ksparse_symmetric")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return gen._batch(g, b, n, k, config, device)


def eps_of(n):
    return 2.0**-15 / (n + 1)


def dense(cols, vals, m):
    """The float64 costs of host arcs, 1e9 off the arcs."""
    b, n, _ = cols.shape
    out = np.full((b, n, m), 1e9)
    for i in range(b):
        for p in range(n):
            ok = cols[i, p] >= 0
            out[i, p, cols[i, p][ok]] = vals[i, p][ok]
    return out


def scipy_optimum(cols, vals, m):
    """Each instance's optimal ``p2o`` and objective."""
    costs = dense(np.asarray(cols), np.asarray(vals, np.float64), m)
    p2o, obj = [], []
    for c in costs:
        rows, picked = linear_sum_assignment(c)
        p2o.append(picked)
        obj.append(c[rows, picked].sum())
    return np.array(p2o), np.array(obj)


def scaled(entry, cols, vals, n, eps):
    if entry == "host":
        return port.solve_batch_sparse(cols.numpy(), vals.numpy(), n,
                                       eps=eps, device="cpu",
                                       scale_eps=True)
    st = port.stage_batch_sparse_device(cols, vals, n, eps=eps,
                                        device="cpu", scale_eps=True)
    assert st.ladder is not None and st.values_nm is None
    return port.solve_batch_sparse_stream([st, st], window=2)[1]


@pytest.mark.parametrize("entry", ["host", "staged"])
@pytest.mark.parametrize("n", [64, 128, 256])
def test_scaled_batch_equals_reference_and_scipy(n, entry):
    cols, vals = square(20261018 + n, n)
    eps = eps_of(n)
    sol = scaled(entry, cols, vals, n, eps)
    want = reference.solve(cols, vals, n, eps)
    p2o, obj = scipy_optimum(cols, vals, n)
    np.testing.assert_array_equal(sol.person_to_object, want["p2o"].numpy())
    np.testing.assert_array_equal(sol.person_to_object, p2o)
    np.testing.assert_array_equal(sol.objective, want["objective"].numpy())
    np.testing.assert_array_equal(sol.objective, obj)
    assert int(sol.num_unassigned.sum()) == 0
    np.testing.assert_array_equal(sol.rounds_by_phase.sum(axis=1),
                                  sol.nits)
    for i, rounds in enumerate(want["rounds_by_phase"]):
        np.testing.assert_array_equal(
            sol.rounds_by_phase[i, :len(rounds)], rounds)
    np.testing.assert_array_equal(sol.eps, np.full(4, eps))


def test_float32_ladder_on_integer_values():
    """Integer values with ε = 1/(n + 1): float32 keeps ε in a profit,
    so the ladder runs in float32, exact all the same."""
    cols, vals = square(7, 96)
    vals = torch.where(cols >= 0, vals.floor(), 0.0)
    st = port.stage_batch_sparse_device(cols, vals, 96, eps=1 / 97,
                                        device="cpu", scale_eps=True)
    assert st.work_device.dtype == torch.float32
    sol = port.solve_batch_sparse_stream([st])[0]
    p2o, obj = scipy_optimum(cols, vals, 96)
    np.testing.assert_array_equal(sol.objective, obj)
    assert int(sol.num_unassigned.sum()) == 0
    np.testing.assert_array_equal(sol.rounds_by_phase.sum(axis=1),
                                  sol.nits)


@pytest.mark.parametrize("entry", ["host", "staged"])
def test_rounds_by_phase_follow_the_ladder(entry):
    cols, vals = square(11, 64)
    eps = eps_of(64)
    sol = scaled(entry, cols, vals, 64, eps)
    w = vals[cols >= 0].double()
    spans = [float(vals[i][cols[i] >= 0].double().max()
                   - vals[i][cols[i] >= 0].double().min())
             for i in range(4)]
    phases = [len(ka.ladder_steps(s, eps)) for s in spans]
    assert sol.rounds_by_phase.shape == (4, max(phases))
    for i, p in enumerate(phases):
        assert (sol.rounds_by_phase[i, :p] > 0).all()
        assert (sol.rounds_by_phase[i, p:] == 0).all()
    assert float(w.min()) >= 500 and float(w.max()) < 1000


@pytest.mark.parametrize("entry", ["host", "staged"])
def test_without_scale_eps_the_route_is_unchanged(entry):
    """A small float32 square batch: the plane route as before, no
    rounds by phase; ``scale_eps=False`` is the default bit for bit (a
    coarse ε: at a fine one a fixed-ε square batch is a long price
    war)."""
    cols, vals = square(3, 32, k=24, config=dict(CONFIG, density=0.2))
    vals = torch.where(cols >= 0, vals.floor(), 0.0)
    if entry == "staged":
        runs = [port.solve_batch_sparse_stream([port.stage_batch_sparse_device(
            cols, vals, 32, eps=8.0, device="cpu", **kw)])[0]
            for kw in ({}, {"scale_eps": False})]
        st = port.stage_batch_sparse_device(cols, vals, 32, eps=8.0,
                                            device="cpu", scale_eps=False)
        assert st.values_nm is not None and st.ladder is None
    else:
        runs = [port.solve_batch_sparse(cols.numpy(), vals.numpy(), 32,
                                        eps=8.0, device="cpu", **kw)
                for kw in ({}, {"scale_eps": False})]
    for f in ("person_to_object", "object_to_person", "num_unassigned",
              "objective", "eps", "nits"):
        np.testing.assert_array_equal(getattr(runs[0], f),
                                      getattr(runs[1], f), err_msg=f)
    assert runs[0].rounds_by_phase is None and runs[1].rounds_by_phase is None


@pytest.mark.parametrize("entry", ["host", "staged"])
def test_rectangular_batch_runs_one_phase(entry):
    cols, vals = square(5, 64)
    cols, vals = cols[:, :40], vals[:, :40].floor()  # 40 persons, 64 objects
    eps = 4.0  # coarse: a fixed-ε batch with competition is a price war
    if entry == "host":
        runs = [port.solve_batch_sparse(cols.numpy(), vals.numpy(), 64,
                                        eps=eps, device="cpu", scale_eps=s)
                for s in (False, True)]
    else:
        runs = [port.solve_batch_sparse_stream([port.stage_batch_sparse_device(
            cols, vals, 64, eps=eps, device="cpu", scale_eps=s)])[0]
            for s in (False, True)]
    for f in ("person_to_object", "object_to_person", "num_unassigned",
              "objective", "eps", "nits"):
        np.testing.assert_array_equal(getattr(runs[0], f),
                                      getattr(runs[1], f), err_msg=f)
    np.testing.assert_array_equal(runs[1].rounds_by_phase,
                                  runs[1].nits[:, None])


def test_square_ladder_needs_the_auto_engine():
    cols, vals = square(2, 64)
    for engine in ("dense", "padded"):
        with pytest.raises(ValueError, match="engine must be 'auto'"):
            port.solve_batch_sparse(cols.numpy(), vals.numpy(), 64,
                                    device="cpu", engine=engine,
                                    scale_eps=True)


def test_a_stopped_ladder_continues():
    """Launches of 1, 5 and 40 rounds one after another equal one launch
    of the whole budget, mid-phase and across phase ends alike."""
    cols, vals = square(13, 64)
    st = port.stage_batch_sparse_device(cols, vals, 64, eps=eps_of(64),
                                        device="cpu", scale_eps=True)
    work, eps = st.work_device, st.eps_val
    s0 = ka.arcs_init(work, 64)
    s, lad = s0, st.ladder
    for r in (1, 5, 40, 40, 40, 5000):
        s, lad = ka.ksp_arcs_ladder(st.columns_device, work, s, lad, eps, 64,
                                    r)
    whole, wl = ka.ksp_arcs_ladder(st.columns_device, work, s0, st.ladder,
                                   eps, 64, 5131)
    for f in STATE:
        assert torch.equal(getattr(s, f), getattr(whole, f)), f
    for f in ka.Ladder._fields:
        assert torch.equal(getattr(lad, f), getattr(wl, f)), f
    assert not bool(((s.p2o == UNASSIGNED) & ~s.dropped).any())


@pytest.mark.parametrize("entry", ["host", "staged"])
@pytest.mark.parametrize("max_rounds", [1, 37])
def test_a_scaled_solve_stops_at_max_rounds(entry, max_rounds):
    """The ladder's launch runs no more rounds than the caller allows:
    every instance stops at ``max_rounds``, undone."""
    cols, vals = square(29, 64)
    eps = eps_of(64)
    if entry == "host":
        sol = port.solve_batch_sparse(cols.numpy(), vals.numpy(), 64,
                                      eps=eps, device="cpu", scale_eps=True,
                                      max_rounds=max_rounds)
    else:
        st = port.stage_batch_sparse_device(cols, vals, 64, eps=eps,
                                            device="cpu", scale_eps=True)
        sol = port.solve_batch_sparse_stream([st],
                                             max_rounds=max_rounds)[0]
    np.testing.assert_array_equal(sol.nits, np.full(4, max_rounds))
    np.testing.assert_array_equal(sol.rounds_by_phase.sum(axis=1),
                                  sol.nits)
    assert int(sol.num_unassigned.min()) > 0


def test_repeated_columns_keep_their_later_slot():
    """A person that lists a column twice: the ladder on the raw arcs
    (the plain version reads the later slot) equals the ladder on the
    arcs the staging clears (``distinct_columns``)."""
    cols, vals = square(17, 64)
    assert int((cols[:, :, 40:] >= 0).sum()) == 0
    cols[:, :, 40] = cols[:, :, 0]  # slot 0 repeated in a pad slot
    vals[:, :, 40] = vals[:, :, 0].flip(dims=(1,))
    work = -vals.double()
    clear = ka.distinct_columns(cols)
    assert int((clear[:, :, 0] >= 0).sum()) == 0
    mask = clear >= 0
    spans = (torch.where(mask, vals, -np.inf).amax(dim=(1, 2)).double()
             - torch.where(mask, vals, np.inf).amin(dim=(1, 2)).double())
    lad = ka.ladder_init(spans.numpy(), eps_of(64), 64, torch.float64, "cpu")
    raw = ka.ksp_arcs_ladder(cols, work, ka.arcs_init(work, 64), lad,
                             eps_of(64), 64, 100_000)
    cleared = ka.ksp_arcs_ladder(clear, work, ka.arcs_init(work, 64), lad,
                                 eps_of(64), 64, 100_000)
    for a, b in zip(raw, cleared):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def recorded(tmp_path, run):
    """``run()``'s result and the names of the profiler's events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sol = run()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return sol, [e["name"] for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("ph") == "X"]


def marked(names, name):
    """Each mark of the counter ``name``, as a list of its numbers."""
    return [[int(v) for v in x.split("=")[1].split(",")] for x in names
            if x.startswith(name + "=")]


def test_counters_mark_a_recorded_solve(tmp_path):
    cols, vals = square(19, 32, b=2, k=24)
    sol, names = recorded(
        tmp_path, lambda: scaled("staged", cols, vals, 32, eps_of(32)))
    last = [int(x.split("=")[1]) for x in names
            if x.startswith(trace.LAST_PHASE_ROUNDS + "=")]
    rbp = sol.rounds_by_phase
    final = [r[np.nonzero(r)[0][-1]] for r in rbp]
    assert last[-1] == max(final) and len(last) == 2  # one a batch
    by_phase = [x for x in names if x.startswith(trace.ROUNDS_BY_PHASE)]
    assert by_phase[-1].split("=")[1] == ",".join(
        str(v) for v in rbp.max(axis=0))
    bursts = marked(names, trace.BURST_ROUNDS)
    assert len(bursts) == 2  # one a batch
    assert bursts[-1] == [int(sol.burst_rounds.sum()), int(rbp.sum())]
    assert 0 < bursts[-1][0] < bursts[-1][1]


def pad_slots(cols, vals, k):
    """The arcs in rows of ``k`` slots, ``-1`` pads after them."""
    b, n, k0 = cols.shape
    return (torch.cat([cols, torch.full((b, n, k - k0), -1, dtype=cols.dtype)],
                      dim=2),
            torch.cat([vals, torch.zeros((b, n, k - k0), dtype=vals.dtype)],
                      dim=2))


@pytest.mark.parametrize("k", [24, SLOTS, SLOTS + 1])
def test_burst_rounds_are_the_few_bidder_rounds(k):
    """The plain ladder, one round a call: an instance's burst count
    gains one in each round that starts with at most ``PERSONS`` active
    persons, where the rows hold at most ``SLOTS`` slots,
    and the whole run counts the same."""
    cols, vals = pad_slots(*square(31, 32, b=3, k=24), k)
    st = port.stage_batch_sparse_device(cols, vals, 32, eps=eps_of(32),
                                        device="cpu", scale_eps=True)
    work, eps = st.work_device, st.eps_val
    s0 = ka.arcs_init(work, 32)
    s, lad = s0, st.ladder
    want = torch.zeros(3, dtype=torch.int32)
    while True:
        live = ((s.p2o == UNASSIGNED) & ~s.dropped).sum(dim=1)
        if not bool(live.any()):
            break
        want += ((live > 0) & (live <= PERSONS)
                 & (k <= SLOTS)).to(torch.int32)
        s, lad = ka.ksp_arcs_ladder(st.columns_device, work, s, lad, eps,
                                    32, 1)
    assert torch.equal(lad.bursts, want)
    assert (int(want.sum()) > 0) == (k <= SLOTS)
    whole = ka.ksp_arcs_ladder(st.columns_device, work, s0, st.ladder, eps,
                               32, 100_000)[1]
    assert torch.equal(whole.bursts, want)


@pytest.mark.parametrize("entry", ["host", "staged"])
def test_burst_counter_reads_zero_past_the_burst_width(entry, tmp_path):
    """Rows of one slot more than the burst holds: a scaled solve marks
    ``slap.burst_rounds=0,<rounds>``, its answer that of the narrow
    rows."""
    cols, vals = square(37, 32, b=2, k=24)
    wide = pad_slots(cols, vals, SLOTS + 1)
    sol, names = recorded(
        tmp_path, lambda: scaled(entry, *wide, 32, eps_of(32)))
    narrow = scaled(entry, cols, vals, 32, eps_of(32))
    np.testing.assert_array_equal(sol.person_to_object,
                                  narrow.person_to_object)
    np.testing.assert_array_equal(sol.burst_rounds, [0, 0])
    assert int(narrow.burst_rounds.sum()) > 0
    assert marked(names, trace.BURST_ROUNDS)[-1] == [
        0, int(sol.rounds_by_phase.sum())]


def test_a_ladder_without_its_burst_counts_is_refused():
    cols, vals = square(41, 32, b=2, k=24)
    st = port.stage_batch_sparse_device(cols, vals, 32, eps=eps_of(32),
                                        device="cpu", scale_eps=True)
    work = st.work_device
    bad = st.ladder._replace(bursts=st.ladder.bursts.double())
    with pytest.raises(ValueError, match="ladder.bursts"):
        ka.ksp_arcs_ladder(st.columns_device, work, ka.arcs_init(work, 32),
                           bad, st.eps_val, 32, 10)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def card():
    """The first CUDA device; skips the test where there is none (the
    look happens here, never at import).  Defined here, not in
    ``conftest.py``, which imports JAX: on the card run this file with
    ``--noconftest``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


#: the card cases: side, slots a row, value type and, where the rows
#: are to fill their slots, a density.  Rows of 8 and 48 slots, then
#: two chunks (33), the config A cell's 176, the widest burst and the
#: first width past it, in both value types.
CARD_CASES = [
    (64, 8, torch.float32, None), (200, 48, torch.float64, None),
    *((n, k, dtype, density)
      for n, k, density in ((200, 33, 0.15), (300, 176, None),
                            (256, SLOTS, 0.9),
                            (256, SLOTS + 1, 0.9))
      for dtype in (torch.float32, torch.float64))]


@pytest.mark.card
@pytest.mark.parametrize("n,k,dtype,density", CARD_CASES)
def test_ladder_kernel_equals_plain_on_card(card, n, k, dtype, density):
    """Whole, stopped and continued; the burst rounds counted as the
    plain version counts them, some where the rows fit the burst and
    none past it."""
    density = density or min(0.3, k / (2 * n))
    cols, vals = square(23 + n, n, k=k, config=dict(CONFIG, density=density),
                        device=card)
    if dtype == torch.float32:
        vals = torch.where(cols >= 0, vals.floor(), 0.0)
    eps = 1 / (n + 1) if dtype == torch.float32 else eps_of(n)
    st = port.stage_batch_sparse_device(cols, vals, n, eps=eps,
                                        scale_eps=True)
    assert st.work_device.dtype == dtype
    work, s0 = st.work_device, ka.arcs_init(st.work_device, n)
    before = ka.LADDER_LAUNCHES
    for rounds in (3, 100_000):
        got = ka.ksp_arcs_ladder(st.columns_device, work, s0, st.ladder,
                                 eps, n, rounds)
        want = ka.ksp_arcs_ladder_reference(st.columns_device, work, s0,
                                            st.ladder, eps, n, rounds)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                assert torch.equal(x, y)
    assert (int(got[1].bursts.sum()) > 0) == (k <= SLOTS)
    part = ka.ksp_arcs_ladder(st.columns_device, work, s0, st.ladder, eps,
                              n, 50)
    part = ka.ksp_arcs_ladder(st.columns_device, work, *part, eps, n,
                              100_000)
    for a, b in zip(part, got):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert ka.LADDER_LAUNCHES == before + 4
