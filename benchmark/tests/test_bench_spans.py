"""The readers of the program's spans (``entry.finish_ms``,
``entry.invert_ms``, ``solver.wait_ms``) on a synthetic profiler trace,
and the breakdown naming the idle time under a program span."""

import json

import pytest

from benchmark import peaks, plugins, timeline

READERS = {"entry.finish_ms": "slap.finish", "entry.invert_ms": "slap.invert",
           "solver.wait_ms": "slap.wait"}


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _span(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


def _trace(tmp_path, spans=True):
    """A window of 100 us holding two calls and one call cut by the
    window's end.  Call 1 [10, 40]: a kernel [12, 29], two waits [15, 20]
    and [22, 28], a finish [30, 38] holding an invert [32, 36] and a
    memcpy [37, 39].  Call 2 [50, 90]: a kernel [52, 78], a wait [60, 70]
    and a finish [79, 90], no invert.  Outside the calls: a wait [42, 48]
    between them, a finish [96, 99] in the cut call, and a wait at 150,
    after the window."""
    ev = [
        _x(timeline.WINDOW_SPAN, "user_annotation", 0, 100),
        _x(timeline.CALL_SPAN, "user_annotation", 10, 30),
        _x(timeline.CALL_SPAN, "user_annotation", 50, 40),
        _x(timeline.CALL_SPAN, "user_annotation", 95, 150),
        _x("fr_kernel", "kernel", 12, 17),
        _x("Memcpy DtoH", "gpu_memcpy", 37, 2),
        _x("fr_kernel", "kernel", 52, 26),
    ]
    if spans:
        ev += [
            _span("slap.solve_batch", 11, 28),
            _span("slap.wait", 15, 5),
            _span("slap.wait", 22, 6),
            _span("slap.finish", 30, 8),
            _span("slap.invert", 32, 4),
            _span("slap.wait", 42, 6),
            _span("slap.wait", 60, 10),
            _span("slap.finish", 79, 11),
            _span("slap.finish", 96, 3),
            _span("slap.wait", 150, 7),
        ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return timeline.load(path, [True, True, False], [700, 900],
                         (3.35e12 * 1e-6, 0), peaks.H100)


def _read(name, rec):
    return plugins.load_module("metrics", name).read(rec)


def test_spans_inside_calls_are_summed_and_averaged(tmp_path):
    rec = _trace(tmp_path)
    assert rec.calls == [(10, 40), (50, 90)]
    # waits: call 1 holds two (5 + 6 us), call 2 one (10 us); the wait
    # between the calls and the one after the window are not counted
    assert _read("solver.wait_ms", rec) == pytest.approx(10.5e-3)
    # finishes 8 and 11 us; the one in the cut call is not counted
    assert _read("entry.finish_ms", rec) == pytest.approx(9.5e-3)
    # an invert in call 1 only: the mean over both calls
    assert _read("entry.invert_ms", rec) == pytest.approx(2e-3)


def test_a_span_outside_every_call_is_not_read(tmp_path):
    rec = _trace(tmp_path)
    calls_only = timeline.Records(**dict(rec.__dict__, calls=[(41, 49)]))
    assert _read("solver.wait_ms", calls_only) == pytest.approx(6e-3)
    for name in ("entry.finish_ms", "entry.invert_ms"):
        assert _read(name, calls_only) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_without_the_span(tmp_path, name):
    assert _read(name, _trace(tmp_path, spans=False)) is None
    rec = _trace(tmp_path)
    others = [o for o in rec.host_ops if o.name != READERS[name]]
    assert _read(name, timeline.Records(
        **dict(rec.__dict__, host_ops=others))) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_manifest_reads_each_span_in_both_cells(name):
    entry = next(m for m in json.loads(plugins.MANIFEST.read_text())[
        "per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    for cell in ("dense-int1000.b4096-n256", "dense-int1000.b1-n4096"):
        assert entry in plugins.cell(cell).per_layer


def test_breakdown_names_idle_time_by_the_innermost_span(tmp_path):
    idle = dict(timeline.breakdown(_trace(tmp_path))["idle_gaps"])
    # the gap [29, 37] has its middle in the invert, inside the finish,
    # inside the call; the gap [78, 100] has its middle (89) in the
    # finish [79, 90]
    assert idle["slap.invert"] == pytest.approx(8e-6)
    assert idle["slap.finish"] == pytest.approx(22e-6)
    assert f"{timeline.CALL_SPAN}: host code, no torch op" not in idle
    without = dict(timeline.breakdown(
        _trace(tmp_path, spans=False))["idle_gaps"])
    assert without[f"{timeline.CALL_SPAN}: host code, no torch op"] == (
        pytest.approx(30e-6))
