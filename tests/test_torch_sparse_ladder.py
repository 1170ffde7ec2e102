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
  that width; the lone rounds (one active person over such rows) counted
  the same way, never more than the burst rounds, a person with no arc
  listed to the end of the budget, a ladder without its lone counts
  refused.
- Card (``card`` marker, skipped without a CUDA device): the ladder
  kernel bit-equal to its plain version (prices, ``p2o``, ``nits``, the
  ladder's state, rounds by phase, burst and lone rounds), whole and
  continued, on rows of one chunk to one past the widest burst; its
  lone chain bit-equal to the plain version and to the kernel's
  instance without the chain on a config A seed's quickest, median and
  slowest instances in both value types, stopped inside a chain and
  continued, and run out by a person with no arc.  No JAX here:
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


def one_round_at_a_time(columns, work, states, ladder, eps, m):
    """The plain ladder run one round a call to the end: ``(states,
    ladder, the rounds that started with one active person, by
    instance)``."""
    s, lad = states, ladder
    alone = torch.zeros(work.shape[0], dtype=torch.int32)
    while True:
        live = ((s.p2o == UNASSIGNED) & ~s.dropped).sum(dim=1)
        if not bool(live.any()):
            return s, lad, alone
        alone += (live == 1).to(torch.int32)
        s, lad = ka.ksp_arcs_ladder(columns, work, s, lad, eps, m, 1)


@pytest.mark.parametrize("k", [24, SLOTS, SLOTS + 1])
def test_lone_rounds_are_the_one_bidder_rounds(k):
    """The plain ladder, one round a call: an instance's lone count gains
    one in each round that starts with one active person, where the rows
    hold at most ``SLOTS`` slots, and the whole run counts the same; it
    never passes the burst count."""
    cols, vals = pad_slots(*square(43, 32, b=3, k=24), k)
    st = port.stage_batch_sparse_device(cols, vals, 32, eps=eps_of(32),
                                        device="cpu", scale_eps=True)
    work, eps = st.work_device, st.eps_val
    s0 = ka.arcs_init(work, 32)
    _, lad, alone = one_round_at_a_time(st.columns_device, work, s0,
                                        st.ladder, eps, 32)
    want = alone if k <= SLOTS else torch.zeros_like(alone)
    assert torch.equal(lad.lones, want)
    assert (int(want.sum()) > 0) == (k <= SLOTS)
    whole = ka.ksp_arcs_ladder(st.columns_device, work, s0, st.ladder, eps,
                               32, 100_000)[1]
    assert torch.equal(whole.lones, want)
    assert bool((whole.lones <= whole.bursts).all())


@pytest.mark.parametrize("n", [64, 128, 256])
def test_lone_rounds_never_pass_the_burst_rounds(n):
    """Every instance of the scaled batches: lone rounds at most its
    burst rounds, some of both, and the solve's ``lone_rounds`` those of
    the ladder."""
    cols, vals = square(20261018 + n, n)
    st = port.stage_batch_sparse_device(cols, vals, n, eps=eps_of(n),
                                        device="cpu", scale_eps=True)
    sol = port.solve_batch_sparse_stream([st])[0]
    assert sol.lone_rounds.shape == sol.burst_rounds.shape == (4,)
    assert (sol.lone_rounds <= sol.burst_rounds).all()
    assert (sol.lone_rounds > 0).all()
    assert (sol.burst_rounds < sol.nits).all()


def test_a_person_with_no_arc_runs_out_the_budget():
    """Person 0 lists no arc (the staging refuses such a person; the
    ladder takes it): once the others are matched it is the one active
    person of every round, listed to the end of the budget, each round a
    lone round, and the phase never ends."""
    cols, vals = square(47, 32, b=2, k=24)
    cols[:, 0], vals[:, 0] = -1, 0.0
    work = -vals.double()
    mask = cols >= 0
    spans = (torch.where(mask, vals, -np.inf).amax(dim=(1, 2)).double()
             - torch.where(mask, vals, np.inf).amin(dim=(1, 2)).double())
    lad = ka.ladder_init(spans.numpy(), eps_of(32), 32, torch.float64, "cpu")
    s0 = ka.arcs_init(work, 32)
    budget = 400
    s, got = ka.ksp_arcs_ladder(cols, work, s0, lad, eps_of(32), 32, budget)
    assert s.nits.tolist() == [budget, budget]
    assert got.phase.tolist() == [0, 0]
    assert got.rounds[:, 0].tolist() == [budget, budget]
    live = (s.p2o == UNASSIGNED) & ~s.dropped
    assert live[:, 0].all() and int(live.sum()) == 2
    # the rounds with the others still bidding, then the lone ones
    step, step_lad, alone = s0, lad, torch.zeros(2, dtype=torch.int32)
    for _ in range(budget):
        alone += (((step.p2o == UNASSIGNED) & ~step.dropped).sum(dim=1)
                  == 1).to(torch.int32)
        step, step_lad = ka.ksp_arcs_ladder(cols, work, step, step_lad,
                                            eps_of(32), 32, 1)
    assert torch.equal(got.lones, alone) and bool((alone > 0).all())
    for f in STATE:
        assert torch.equal(getattr(s, f), getattr(step, f)), f


def test_a_ladder_without_its_lone_counts_is_refused():
    cols, vals = square(53, 32, b=2, k=24)
    st = port.stage_batch_sparse_device(cols, vals, 32, eps=eps_of(32),
                                        device="cpu", scale_eps=True)
    work = st.work_device
    for bad in (st.ladder._replace(lones=st.ladder.lones.long()),
                st.ladder._replace(lones=st.ladder.lones[:1])):
        with pytest.raises(ValueError, match="ladder.lones"):
            ka.ksp_arcs_ladder(st.columns_device, work,
                               ka.arcs_init(work, 32), bad, st.eps_val, 32,
                               10)


def test_lone_counter_marks_a_recorded_solve(tmp_path):
    """``slap.lone_rounds=<lone>,<rounds>`` once a batch, the batch's lone
    rounds beside all its rounds."""
    cols, vals = square(59, 32, b=2, k=24)
    sol, names = recorded(
        tmp_path, lambda: scaled("staged", cols, vals, 32, eps_of(32)))
    lones = marked(names, trace.LONE_ROUNDS)
    assert len(lones) == 2  # one a batch
    assert lones[-1] == [int(sol.lone_rounds.sum()),
                         int(sol.rounds_by_phase.sum())]
    assert 0 < lones[-1][0] <= int(sol.burst_rounds.sum())


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


def card_config_a(card, seed, b, dtype):
    """``b`` instances of config A (the cell's side, slots and law) made
    on the card from ``seed`` and staged with ``scale_eps``: float64 at
    the cell's eps; float32 on the values cut to integers at eps =
    2^-12, which float32 keeps.  Returns ``(staged, n, eps)``."""
    cell = plugins.cell("ksparse-crate-a.b128x2-n10000")
    n, k = cell.spec["rows"], cell.spec["arcs"]
    cols, vals = square(seed, n, b=b, k=k, config=cell.config, device=card)
    eps = 1.0 / cell.spec["entry_args"]["eps_denominator"]
    if dtype == torch.float32:
        vals = torch.where(cols >= 0, vals.floor(), 0.0)
        eps = 2.0**-12
    st = port.stage_batch_sparse_device(cols, vals, n, eps=eps,
                                        scale_eps=True)
    assert st.work_device.dtype == dtype
    return st, n, eps


def ladders_equal(a, b, skip=()):
    """Two ``(states, ladder)`` results equal bit for bit, the ladder's
    fields ``skip`` left out."""
    for f in STATE:
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    for f in ka.Ladder._fields:
        if f not in skip:
            assert torch.equal(getattr(a[1], f), getattr(b[1], f)), f


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lone_chain_equals_plain_and_the_rounds_before_it(card, dtype):
    """A config A seed's quickest, median and slowest of 8 instances, as
    the batch launch left them and alone: the kernel equals its plain
    version and its instance without the lone chain (the rounds as they
    ran before it), but for the lone count that instance leaves as it
    was; each ran lone rounds, no more than its burst rounds."""
    st, n, eps = card_config_a(card, 2026102701, 8, dtype)
    c, w = st.columns_device, st.work_device
    budget = 1 << 20
    got = ka.ksp_arcs_ladder(c, w, ka.arcs_init(w, n), st.ladder, eps, n,
                             budget)
    assert not bool(((got[0].p2o == UNASSIGNED) & ~got[0].dropped).any())
    order = torch.argsort(got[0].nits.cpu(), stable=True)
    at = order[[0, len(order) // 2, -1]].to(card)
    c3, w3 = c[at].contiguous(), w[at].contiguous()
    lad3 = ka.Ladder(*(x[at].contiguous() for x in st.ladder))
    s3 = ka.arcs_init(w3, n)
    want = ka.ksp_arcs_ladder_reference(c3, w3, s3, lad3, eps, n, budget)
    rows = (got[0]._replace(**{f: getattr(got[0], f)[at] for f in STATE}),
            ka.Ladder(*(x[at] for x in got[1])))
    ladders_equal(rows, want)
    ladders_equal(ka.ksp_arcs_ladder(c3, w3, s3, lad3, eps, n, budget), want)
    old = ka._ksp_arcs_ladder_cuda(c3, w3, s3, lad3, eps, n, budget,
                                   chain=False)
    ladders_equal(old, want, skip=("lones",))
    assert torch.equal(old[1].lones, lad3.lones)
    lones, bursts = want[1].lones, want[1].bursts
    assert bool((lones > 0).all()) and bool((lones <= bursts).all())


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_launch_that_ends_inside_a_chain_continues(card, dtype):
    """Four config A instances stopped a few rounds before the first
    one's second phase ends, inside its lone chain, then continued one
    round a launch across that phase's end and on to the end: the state
    of one whole launch, with the chain and without it."""
    st, n, eps = card_config_a(card, 2026102702, 4, dtype)
    c, w = st.columns_device, st.work_device
    s0 = ka.arcs_init(w, n)
    whole = ka.ksp_arcs_ladder(c, w, s0, st.ladder, eps, n, 1 << 20)
    end = int(whole[1].rounds[0, :2].sum())
    for before in (3, 5, 10, 30, 100):  # the first stop inside the chain
        part = ka.ksp_arcs_ladder(c, w, s0, st.ladder, eps, n, end - before)
        live = (part[0].p2o == UNASSIGNED) & ~part[0].dropped
        if int(live[0].sum()) == 1:
            break
    assert int(live[0].sum()) == 1 and int(part[1].phase[0]) == 1
    assert int(part[1].lones[0]) > 0
    old = ka._ksp_arcs_ladder_cuda(c, w, *part, eps, n, 1 << 20,
                                   chain=False)
    for _ in range(5):
        part = ka.ksp_arcs_ladder(c, w, *part, eps, n, 1)
    part = ka.ksp_arcs_ladder(c, w, *part, eps, n, 1 << 20)
    ladders_equal(part, whole)
    ladders_equal(old, whole, skip=("lones",))


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_lone_bidder_with_no_arc_runs_out_the_budget_on_card(card, dtype):
    """Person 0 lists no arc: the kernel runs the launch's budget out on
    it, as its plain version and its instance without the chain do."""
    cols, vals = square(73, 300, b=2, k=48, device=card)
    cols[:, 0], vals[:, 0] = -1, 0.0
    if dtype == torch.float32:
        vals = vals.floor()
    work = -vals.to(dtype)
    mask = cols >= 0
    spans = (torch.where(mask, vals, -np.inf).amax(dim=(1, 2)).double()
             - torch.where(mask, vals, np.inf).amin(dim=(1, 2)).double())
    eps = eps_of(300) if dtype == torch.float64 else 2.0**-8
    lad = ka.ladder_init(spans.cpu().numpy(), eps, 300, dtype, card)
    s0 = ka.arcs_init(work, 300)
    budget = 3000
    got = ka.ksp_arcs_ladder(cols, work, s0, lad, eps, 300, budget)
    want = ka.ksp_arcs_ladder_reference(cols, work, s0, lad, eps, 300,
                                        budget)
    ladders_equal(got, want)
    old = ka._ksp_arcs_ladder_cuda(cols, work, s0, lad, eps, 300, budget,
                                   chain=False)
    ladders_equal(old, want, skip=("lones",))
    assert got[0].nits.tolist() == [budget, budget]
    assert bool((got[1].lones > 0).all())
    live = (got[0].p2o == UNASSIGNED) & ~got[0].dropped
    assert bool(live[:, 0].all()) and int(live.sum()) == 2
