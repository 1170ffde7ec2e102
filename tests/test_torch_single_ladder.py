"""``KhoslaSolver.solve``'s arc ladder route: a square instance solved
with ``scale_eps`` from a cold start runs the eps-scaling ladder on the
arc ladder kernel as a batch of one (``batch.solve_csr_scaled``).

- CPU: the route's function with the kernel's plain version
  (``route_solve``: what ``solve`` does on a card, with the device the
  CPU; ``solve`` itself keeps ``khosla_solve_scaled`` there).  Seeded
  square instances of the config A
  law (``benchmark/gen/ksparse_symmetric.py``) at sides 32 to 256,
  minimised and maximised: the matching, the prices and the rounds by
  phase equal the plain reference's (``benchmark/reference/
  sparse_ladder.py``) bit for bit, the objective equals scipy's optimum
  and ``khosla_solve_scaled``'s; float64 values off float32's grid stay
  float64; an instance with no perfect matching ends with the
  reference's persons unassigned; ``max_rounds`` stops it where the
  batched route stops; the slots are the longest row rounded up to 32;
  the spans and counters under a recording profiler; the lone rounds
  (one active person) counted round by round, never more than the burst
  rounds, and a ladder without its lone counts refused; every other
  request keeps its route.
- Card (``card`` marker, skipped without a CUDA device): the route on
  the card, one ladder launch a solve, bit-equal to the plain reference
  run there; its lone rounds those of the plain ladder; its spans inside
  ``slap.solve``; every other request keeps its route there too.  No JAX here: on the card run ``python -m pytest
  --noconftest tests/test_torch_single_ladder.py -m card``.
"""

import json

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from benchmark import plugins
from benchmark.reference import sparse_ladder as reference
from sparse_linear_assignment_tpu_torch import KhoslaSolver, ksparse
from sparse_linear_assignment_tpu_torch.ops import ksparse_arcs as ka
from sparse_linear_assignment_tpu_torch.utils import trace

torch.set_num_threads(1)

UNASSIGNED = 2**31 - 1
CONFIG = {"density": 0.06, "value_low": 500, "value_high": 1000}


def square(seed, n, k=32, config=CONFIG, device="cpu"):
    """One instance of the config A law at side ``n``: ``(columns [1, n,
    k], values [1, n, k])``, the arcs first in each row."""
    gen = plugins.load_module("gen", "ksparse_symmetric")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return gen._batch(g, 1, n, k, config, device)


def csr(cols, vals):
    """The host CSR rows of one instance's arcs, slot order kept."""
    c, v = cols[0].cpu().numpy(), vals[0].cpu().numpy()
    ok = c >= 0
    return ok.sum(axis=1), c[ok], v[ok].astype(np.float64)


def solver_of(cols, vals, dtype=np.float64):
    counts, c, v = csr(cols, vals)
    n = len(counts)
    solver, solution = KhoslaSolver.new(n, n, len(v), dtype=dtype)
    solver.init(n, n)
    solver.extend_from_csr(counts, c, v)
    return solver, solution


def eps_of(n):
    return 2.0**-15 / (n + 1)


def reference_run(cols, vals, eps, maximize=False,
                  max_rounds=10_000_000):
    """``sparse_ladder.solve``'s ladder on one instance, driven through
    its own functions so that the prices come out too: ``(p2o [n]
    int64, -1 unassigned), prices [n] float64, rounds by phase)``."""
    n = cols.shape[1]
    c, work, valid = reference._arcs(cols[0], vals[0], maximize)
    span = float(work[valid].max() - work[valid].min())
    prices = torch.zeros(n, dtype=torch.float64)
    rounds = []
    for i, e in enumerate(reference.eps_ladder(span, eps)):
        pad = 0.0 if i == 0 else max(0.0, float(prices.max()))
        threshold = (n / 2.0) * (span + e) + pad
        p2o, prices, r = reference._phase(c, work, valid, prices, e,
                                          threshold, max_rounds)
        rounds.append(r)
    return p2o.numpy(), prices.numpy(), rounds


@pytest.fixture
def route(monkeypatch):
    """The results of the route's function, ``batch.solve_csr_scaled``,
    in the order it ran."""
    seen = []
    real = ksparse.solve_csr_scaled

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(out)
        return out

    monkeypatch.setattr(ksparse, "solve_csr_scaled", spy)
    return seen


def route_solve(solver, solution, maximize, eps, max_rounds=10_000_000):
    """``solver.solve(solution, maximize, eps=eps, scale_eps=True,
    max_rounds=max_rounds)`` as a card runs it, on the CPU: the solve's
    own preparation, then its arc ladder route with the kernel's plain
    version."""
    solver.validate_input()
    solver.init_solve(solution, maximize)
    solution.eps = eps
    solver._solve_arc_ladder(solution, eps, max_rounds, torch.device("cpu"))


def as_reference(p2o):
    return np.where(p2o == UNASSIGNED, -1, p2o)


#: (seed, side, maximize): 24 instances at sides 32 to 256
CASES = [(20261018 + 7 * i, n, i % 2 == 1)
         for i, n in enumerate([32, 48, 64, 96, 128, 160, 192, 256] * 3)]


@pytest.mark.parametrize("seed,n,maximize", CASES)
def test_route_equals_reference_scipy_and_slot_list(route, seed, n,
                                                    maximize):
    cols, vals = square(seed, n)
    eps = eps_of(n)
    solver, solution = solver_of(cols, vals)
    route_solve(solver, solution, maximize, eps)
    assert len(route) == 1
    p2o, prices, rounds = reference_run(cols, vals, eps, maximize)
    np.testing.assert_array_equal(
        as_reference(solution.person_to_object), p2o)
    np.testing.assert_array_equal(solver.prices, prices)
    assert route[0].rounds_by_phase[0].tolist() == rounds
    assert solver.nits == sum(rounds)
    assert solution.num_unassigned == 0 and solution.eps == eps

    costs = np.full((n, n), 1e9 if not maximize else -1e9)
    counts, c, v = csr(cols, vals)
    costs[np.repeat(np.arange(n), counts), c] = v
    r, picked = linear_sum_assignment(costs, maximize=maximize)
    objective = solver.get_objective(solution)
    assert objective == costs[r, picked].sum()

    # the CPU's own route, the JAX package's slot-list ladder
    other, other_solution = solver_of(cols, vals)
    other.solve(other_solution, maximize, eps=eps, scale_eps=True,
                device="cpu")
    assert len(route) == 1
    assert other.get_objective(other_solution) == objective


def test_float64_values_stay_float64(route):
    """Values off float32's grid: the route stages and runs them in
    float64, so it matches the float64 reference bit for bit."""
    cols, vals = square(5, 64)
    rng = np.random.default_rng(5)
    counts, c, _ = csr(cols, vals)
    v = 500.0 + 500.0 * rng.random(len(c))
    assert not np.array_equal(v, v.astype(np.float32))
    solver, solution = KhoslaSolver.new(64, 64, len(v))
    solver.init(64, 64)
    solver.extend_from_csr(counts, c, v)
    wide = torch.zeros(cols.shape, dtype=torch.float64)
    wide[cols >= 0] = torch.from_numpy(v)
    eps = eps_of(64)
    route_solve(solver, solution, False, eps)
    p2o, prices, rounds = reference_run(cols, wide, eps)
    np.testing.assert_array_equal(
        as_reference(solution.person_to_object), p2o)
    np.testing.assert_array_equal(solver.prices, prices)
    assert route[0].rounds_by_phase[0].tolist() == rounds


def test_float32_solver_runs_float64_where_float32_cannot_keep_eps(route):
    cols, vals = square(8, 48)
    eps = eps_of(48)
    solver, solution = solver_of(cols, vals, dtype=np.float32)
    route_solve(solver, solution, False, eps)
    p2o, prices, _ = reference_run(cols, vals, eps)
    assert route[0].prices.dtype == np.float64
    np.testing.assert_array_equal(
        as_reference(solution.person_to_object), p2o)


def test_no_perfect_matching_leaves_the_references_persons(route):
    """Persons 0, 1 and 2 list only objects 0 and 1: one of them is left
    unassigned, as in the reference.  At ε = 1: a person is dropped once
    the prices of its objects pass the phase's threshold, about (n / 2)
    times the span above the carried prices, a price war of that over ε
    rounds in every phase."""
    n, k = 6, 3
    cols = torch.full((1, n, k), -1, dtype=torch.int32)
    vals = torch.zeros((1, n, k), dtype=torch.float32)
    rows = [[0, 1], [1, 0], [0], [2, 3, 4], [3, 5], [4, 5, 2]]
    for p, row in enumerate(rows):
        cols[0, p, :len(row)] = torch.tensor(row, dtype=torch.int32)
        vals[0, p, :len(row)] = torch.tensor(
            [600.0 + 37 * ((p * 7 + j * 3) % 11) for j in row])
    eps = 1.0
    solver, solution = solver_of(cols, vals)
    route_solve(solver, solution, False, eps)
    p2o, prices, rounds = reference_run(cols, vals, eps)
    assert solution.num_unassigned == 1 == int((p2o < 0).sum())
    np.testing.assert_array_equal(
        as_reference(solution.person_to_object), p2o)
    np.testing.assert_array_equal(solver.prices, prices)
    assert route[0].rounds_by_phase[0].tolist() == rounds
    o2p = solution.object_to_person
    owned = solution.person_to_object[solution.person_to_object
                                      != UNASSIGNED]
    np.testing.assert_array_equal(np.sort(owned), np.flatnonzero(
        o2p != UNASSIGNED))


@pytest.mark.parametrize("max_rounds", [1, 37, 200])
def test_max_rounds_stops_it_where_the_batched_route_stops(route,
                                                           max_rounds):
    import sparse_linear_assignment_tpu_torch as port

    cols, vals = square(13, 64)
    eps = eps_of(64)
    solver, solution = solver_of(cols, vals)
    route_solve(solver, solution, False, eps, max_rounds)
    st = port.stage_batch_sparse_device(cols, vals, 64, eps=eps,
                                        device="cpu", scale_eps=True)
    want = port.solve_batch_sparse_stream([st], max_rounds=max_rounds)[0]
    assert solver.nits == int(want.nits[0]) == max_rounds
    np.testing.assert_array_equal(solution.person_to_object,
                                  want.person_to_object[0])
    np.testing.assert_array_equal(route[0].rounds_by_phase,
                                  want.rounds_by_phase)
    assert solution.num_unassigned == int(want.num_unassigned[0]) > 0


@pytest.mark.parametrize("longest,k", [(1, 32), (31, 32), (32, 32),
                                       (33, 64), (101, 128)])
def test_slots_are_the_longest_row_rounded_up_to_32(longest, k):
    n = 128
    counts = np.array([longest] + [1] * (n - 1))
    rng = np.random.default_rng(longest)
    columns = np.concatenate([rng.permutation(n)[:longest],
                              np.arange(1, n)]).astype(np.int32)
    values = rng.random(len(columns))
    got_cols, got_vals = ka.csr_slots(counts, columns, values, "cpu")
    assert got_cols.shape == got_vals.shape == (1, n, k)
    assert got_cols.dtype == torch.int32
    assert got_vals.dtype == torch.float64
    np.testing.assert_array_equal(got_cols[0, 0, :longest],
                                  columns[:longest])
    np.testing.assert_array_equal(got_vals[0, 0, :longest],
                                  values[:longest])
    assert bool((got_cols[0, 0, longest:] == -1).all())
    assert bool((got_vals[0, 0, longest:] == 0).all())
    np.testing.assert_array_equal(got_cols[0, 1:, 0], np.arange(1, n))
    assert bool((got_cols[0, 1:, 1:] == -1).all())


def test_repeated_columns_keep_their_later_slot(route):
    """A row's first column listed again after its arcs, with another
    value: the later slot's value counts, as in the reference."""
    cols, vals = square(21, 48)
    count = (cols[0] >= 0).sum(dim=1)
    rows = torch.arange(48)[count < cols.shape[2]]
    cols[0, rows, count[rows]] = cols[0, rows, 0]
    vals[0, rows, count[rows]] = vals[0, rows, 1]
    eps = eps_of(48)
    solver, solution = solver_of(cols, vals)
    route_solve(solver, solution, False, eps)
    p2o, prices, rounds = reference_run(cols, vals, eps)
    np.testing.assert_array_equal(
        as_reference(solution.person_to_object), p2o)
    np.testing.assert_array_equal(solver.prices, prices)
    assert route[0].rounds_by_phase[0].tolist() == rounds


def _recorded(fn, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("slap.")),
                  key=lambda s: s[1])


def _route_spans(spans, sol, nits) -> None:
    """The route's spans in their order (the CSR to slots, the staging,
    the waits, the finish holding the inversion) and its counters, those
    of ``sol``, the route's ``BatchSolution``."""
    def one(name):
        got = [s for s in spans if s[0] == name]
        assert len(got) == 1, name
        return got[0]

    csr_arcs, stage, finish, invert = map(one, (
        trace.CSR_ARCS_SPAN, trace.STAGE_SPAN, trace.FINISH_SPAN,
        trace.INVERT_SPAN))
    waits = [s for s in spans if s[0] == trace.WAIT_SPAN]
    assert waits
    assert csr_arcs[2] <= stage[1] and stage[2] <= min(w[1] for w in waits)
    assert max(w[2] for w in waits) <= finish[1]
    assert finish[1] <= invert[1] and invert[2] <= finish[2]
    rbp = sol.rounds_by_phase[0]
    counters = {n.split("=")[0]: n.split("=")[1]
                for n, _, _ in spans if "=" in n}
    assert counters[trace.LAST_PHASE_ROUNDS] == str(rbp[-1])
    assert counters[trace.ROUNDS_BY_PHASE] == ",".join(map(str, rbp))
    assert counters[trace.BURST_ROUNDS] == f"{sol.burst_rounds[0]},{nits}"


def test_spans_and_counters_of_a_recorded_solve(route, tmp_path):
    cols, vals = square(3, 64)
    solver, solution = solver_of(cols, vals)
    spans = _recorded(lambda: route_solve(solver, solution, False,
                                          eps_of(64)), tmp_path)
    assert trace.SOLVE_SPAN not in [s[0] for s in spans]
    _route_spans(spans, route[0], solver.nits)


def test_lone_counter_of_a_recorded_solve(route, tmp_path):
    cols, vals = square(9, 64)
    solver, solution = solver_of(cols, vals)
    spans = _recorded(lambda: route_solve(solver, solution, False,
                                          eps_of(64)), tmp_path)
    sol = route[0]
    counters = {n.split("=")[0]: n.split("=")[1]
                for n, _, _ in spans if "=" in n}
    assert counters[trace.LONE_ROUNDS] == f"{sol.lone_rounds[0]},{solver.nits}"
    assert 0 < sol.lone_rounds[0] <= sol.burst_rounds[0]


def staged_one(cols, vals, n):
    """One instance's arcs, values and ladder as the route stages them,
    on the CPU."""
    counts, c, v = csr(cols, vals)
    arcs, values = ka.csr_slots(counts, c, -v, "cpu")
    span = float(v.max() - v.min())
    return arcs, values, ka.ladder_init(np.array([span]), eps_of(n), n,
                                        values.dtype, "cpu")


@pytest.mark.parametrize("seed,n", [(61, 48), (67, 96)])
def test_lone_rounds_of_the_route_are_its_one_bidder_rounds(route, seed, n):
    """The route's lone count equals the plain ladder's rounds that start
    with one active person, counted one round a call on the same staged
    arcs, and its answer is theirs."""
    cols, vals = square(seed, n)
    solver, solution = solver_of(cols, vals)
    route_solve(solver, solution, False, eps_of(n))
    arcs, values, lad = staged_one(cols, vals, n)
    s = ka.arcs_init(values, n)
    alone = 0
    while True:
        live = int(((s.p2o == UNASSIGNED) & ~s.dropped).sum())
        if live == 0:
            break
        alone += live == 1
        s, lad = ka.ksp_arcs_ladder(arcs, values, s, lad, eps_of(n), n, 1)
    assert route[0].lone_rounds.tolist() == [alone] == lad.lones.tolist()
    assert route[0].burst_rounds.tolist() == lad.bursts.tolist()
    assert 0 < alone <= int(lad.bursts[0]) < solver.nits
    np.testing.assert_array_equal(solution.person_to_object,
                                  s.p2o[0].numpy())


def test_a_single_ladder_without_its_lone_counts_is_refused():
    cols, vals = square(71, 32)
    arcs, values, lad = staged_one(cols, vals, 32)
    for bad in (lad._replace(lones=lad.lones.float()),
                lad._replace(lones=torch.zeros(2, dtype=torch.int32))):
        with pytest.raises(ValueError, match="ladder.lones"):
            ka.ksp_arcs_ladder(arcs, values, ka.arcs_init(values, 32), bad,
                               eps_of(32), 32, 10)


def test_slot_list_solve_marks_its_solve_span_alone(tmp_path):
    cols, vals = square(3, 32)
    solver, solution = solver_of(cols, vals)
    spans = _recorded(lambda: solver.solve(
        solution, False, eps=eps_of(32), scale_eps=True, device="cpu"),
        tmp_path)
    assert [s[0] for s in spans] == [trace.SOLVE_SPAN]


#: requests that keep their routes, each with the keyword arguments of
#: ``solve``; the rectangular one has one spare object
KEEP = {
    "start_prices": dict(scale_eps=True, start_prices=np.zeros(48)),
    "hybrid": dict(scale_eps=True, hybrid=True),
    "fixed eps": dict(scale_eps=False, compact=True),
    "native": dict(scale_eps=True, engine="native"),
    "auto": dict(),
}


def keeps_its_route(name, route, device) -> None:
    """The request ``name`` (``KEEP``'s, a rectangular instance, or the
    route's own on the CPU) solved on ``device`` runs no ladder."""
    cols, vals = square(17, 48)
    counts, c, v = csr(cols, vals)
    m = 49 if name == "rectangular" else 48
    solver, solution = KhoslaSolver.new(48, m, len(v))
    solver.init(48, m)
    solver.extend_from_csr(counts, c, v)
    kwargs = dict(KEEP.get(name, dict(scale_eps=True)))
    launches = ka.LADDER_LAUNCHES
    solver.solve(solution, False, eps=1 / 49, device=device, **kwargs)
    assert route == [] and ka.LADDER_LAUNCHES == launches
    assert solution.num_unassigned == 0


@pytest.mark.parametrize("name", sorted(KEEP) + ["rectangular", "cpu"])
def test_every_other_request_keeps_its_route(name, route):
    keeps_its_route(name, route, "cpu")


# ----------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    """A CUDA device, or a skip.  (``tests/conftest.py`` registers the
    ``card`` marker; on the card this file runs with ``--noconftest``,
    since that conftest imports JAX.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


#: the card cases: side, slots a row and density (config A's law)
CARD_CASES = [(1000, 64, 0.02), (10000, 176, 0.01)]


@pytest.mark.card
@pytest.mark.parametrize("n,k,density", CARD_CASES)
def test_route_on_the_card_equals_reference(card, n, k, density):
    cols, vals = square(2026 + n, n, k, dict(CONFIG, density=density),
                        device=card)
    eps = eps_of(n)
    solver, solution = solver_of(cols, vals)
    launches = ka.LADDER_LAUNCHES
    solver.solve(solution, False, eps=eps, scale_eps=True, device=card)
    assert ka.LADDER_LAUNCHES == launches + 1
    want = reference.solve(cols, vals, n, eps)
    np.testing.assert_array_equal(
        as_reference(solution.person_to_object),
        want["p2o"][0].cpu().numpy())
    assert solver.get_objective(solution) == float(want["objective"][0])
    assert solver.nits == int(want["nits"][0])
    assert solution.num_unassigned == 0


@pytest.mark.card
def test_route_on_the_card_counts_the_plain_ladders_lone_rounds(card,
                                                                route):
    """The route's burst and lone rounds, read back with its answer, are
    the plain ladder's on the same staged arcs, run on the card."""
    n = 1000
    cols, vals = square(2029, n, 64, dict(CONFIG, density=0.02),
                        device=card)
    solver, solution = solver_of(cols, vals)
    solver.solve(solution, False, eps=eps_of(n), scale_eps=True, device=card)
    arcs, values, lad = (x.to(card) if isinstance(x, torch.Tensor) else
                         ka.Ladder(*(t.to(card) for t in x))
                         for x in staged_one(cols.cpu(), vals.cpu(), n))
    s, lad = ka.ksp_arcs_ladder_reference(arcs, values,
                                          ka.arcs_init(values, n), lad,
                                          eps_of(n), n, 10_000_000)
    sol = route[0]
    assert sol.lone_rounds.tolist() == lad.lones.tolist()
    assert sol.burst_rounds.tolist() == lad.bursts.tolist()
    assert 0 < sol.lone_rounds[0] <= sol.burst_rounds[0] < solver.nits
    np.testing.assert_array_equal(solution.person_to_object,
                                  s.p2o[0].cpu().numpy())


@pytest.mark.card
def test_spans_of_a_card_solve_lie_inside_its_solve_span(card, route,
                                                         tmp_path):
    cols, vals = square(2027, 1000, 64, dict(CONFIG, density=0.02),
                        device=card)
    solver, solution = solver_of(cols, vals)
    spans = _recorded(lambda: solver.solve(
        solution, False, eps=eps_of(1000), scale_eps=True, device=card),
        tmp_path)
    solves = [s for s in spans if s[0] == trace.SOLVE_SPAN]
    assert len(solves) == 1 and len(route) == 1
    solve = solves[0]
    assert all(solve[1] <= s[1] and s[2] <= solve[2] for s in spans)
    _route_spans(spans, route[0], solver.nits)


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(KEEP) + ["rectangular"])
def test_every_other_request_keeps_its_route_on_the_card(card, route, name):
    keeps_its_route(name, route, card)
