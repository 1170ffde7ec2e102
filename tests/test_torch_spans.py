"""The port's profiler spans (``utils/trace.span``): off without a
recording, and under ``torch.profiler`` the nesting the benchmark's
readers rely on, on every dense route of ``solve_batch``.

- ``span`` with no recording is one shared null context;
- each ``solve_batch`` call holds one ``slap.solve_batch``, inside it
  one or more ``slap.wait`` (a driver's blocking readbacks), then one
  ``slap.finish`` holding one ``slap.invert``;
- ``o2p_from_p2o`` marks ``slap.invert`` for every caller, and so does
  ``o2p_from_p2o_device``;
- a solve under the profiler returns the same bits as one without.
"""

import contextlib
import json

import numpy as np
import pytest
import torch

import sparse_linear_assignment_tpu_torch as port
from sparse_linear_assignment_tpu_torch import batch, solution
from sparse_linear_assignment_tpu_torch.utils import span, trace

torch.set_num_threads(1)

SOLVE, WAIT, FINISH, INVERT = (trace.SOLVE_BATCH_SPAN, trace.WAIT_SPAN,
                               trace.FINISH_SPAN, trace.INVERT_SPAN)


def _costs(seed, b, n, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 100, size=(b, n, n)).astype(dtype)


#: route -> (keyword arguments of ``solve_batch``, whether it needs the
#: big-single route's size floor lowered)
CASES = {
    "plain": (lambda: dict(costs=_costs(1, 3, 12, np.float64),
                           dtype=np.float64), False),
    "fused": (lambda: dict(costs=_costs(2, 2, 128)), False),
    "fused-device": (lambda: dict(
        costs=None, costs_device=torch.from_numpy(_costs(3, 2, 128)),
        integer=True, max_cost=100), False),
    "big": (lambda: dict(costs=_costs(4, 1, 128), integer=False), True),
    "big-device": (lambda: dict(
        costs=None, costs_device=torch.from_numpy(_costs(5, 1, 128)),
        eps=1.0 / 129), True),
    "forward": (lambda: dict(costs=_costs(6, 3, 12), solver="forward"),
                False),
    "khosla": (lambda: dict(costs=_costs(7, 3, 12), solver="khosla"),
               False),
}


@pytest.fixture(params=sorted(CASES))
def case(request, monkeypatch):
    kwargs, big = CASES[request.param]
    if big:
        monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 0)
    return request.param, kwargs()


def _recorded(fn, tmp_path):
    """``fn()`` under a CPU profiler: its result and the program's spans
    in the exported Chrome trace (what the benchmark reads) as ``(name,
    start, end)`` in time order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("name") in trace.SPANS
             and e.get("cat") == "user_annotation"]
    return out, sorted(spans, key=lambda s: s[1])


def _inside(outer, inner):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_without_a_recording_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span(SOLVE), span("anything")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a as entered:
        assert entered is None


def test_span_under_a_recording_marks_the_timeline(tmp_path):
    def enter():
        with span(WAIT):
            pass

    _, spans = _recorded(enter, tmp_path)
    assert [s[0] for s in spans] == [WAIT]


@pytest.mark.parametrize("name", ["plain", "fused", "fused-device", "big",
                                  "big-device"])
def test_each_fr_case_takes_its_route(name, monkeypatch):
    kwargs, big = CASES[name]
    if big:
        monkeypatch.setattr(batch, "_BIG_MIN_ELEMS", 0)
    kw = kwargs()
    costs = kw["costs"] if kw["costs"] is not None else kw["costs_device"]
    b, n, m = costs.shape
    int_scale = batch._integer_scale(
        kw["costs"], kw.get("eps"), n, m, kw.get("integer"),
        kw.get("max_cost"))
    route = batch._route(b, n, m, kw.get("dtype", np.float32), int_scale)
    assert route == name.split("-")[0]


def test_solve_batch_spans_nest_per_call(case, tmp_path):
    _, kw = case
    calls = 2
    _, spans = _recorded(lambda: [port.solve_batch(device="cpu", **kw)
                                  for _ in range(calls)], tmp_path)
    solves = [s for s in spans if s[0] == SOLVE]
    assert len(solves) == calls
    assert all(any(_inside(o, s) for o in solves) for s in spans)
    for outer in solves:
        mine = [s for s in spans if s is not outer and _inside(outer, s)]
        waits = [s for s in mine if s[0] == WAIT]
        finishes = [s for s in mine if s[0] == FINISH]
        inverts = [s for s in mine if s[0] == INVERT]
        assert waits and len(finishes) == 1 and len(inverts) == 1
        finish = finishes[0]
        assert max(w[2] for w in waits) <= finish[1]
        assert _inside(finish, inverts[0])


def test_spans_leave_the_solution_unchanged(case, tmp_path):
    _, kw = case
    off = port.solve_batch(device="cpu", **kw)
    on, spans = _recorded(lambda: port.solve_batch(device="cpu", **kw),
                          tmp_path)
    assert spans
    for field in ("person_to_object", "object_to_person", "num_unassigned",
                  "objective", "eps", "nits"):
        a, b = getattr(off, field), getattr(on, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("batched", [False, True])
def test_o2p_from_p2o_marks_the_inversion(batched, tmp_path):
    p2o = np.array([[2, solution.UNASSIGNED, 0], [1, 0, 3]], np.int32)
    p2o = p2o if batched else p2o[0]
    want = solution.o2p_from_p2o(p2o, 4)
    got, spans = _recorded(lambda: solution.o2p_from_p2o(p2o, 4), tmp_path)
    np.testing.assert_array_equal(got, want)
    assert [s[0] for s in spans] == [INVERT]


def test_o2p_from_p2o_device_marks_the_inversion(tmp_path):
    p2o = np.array([[2, solution.UNASSIGNED, 0], [1, 0, 3]], np.int32)
    (got, free), spans = _recorded(
        lambda: solution.o2p_from_p2o_device(torch.from_numpy(p2o), 4),
        tmp_path)
    np.testing.assert_array_equal(got.numpy(), solution.o2p_from_p2o(p2o, 4))
    assert free.tolist() == [1, 0]
    assert [s[0] for s in spans] == [INVERT]
