"""``solver.lone_round_share`` (``metrics/solver.lone_round_share.py``):
read from the records of a tiny run of the config A cell on the CPU,
where the ladder's plain version marks the program's
``slap.lone_rounds`` counters; left out of the line of the same run of
a program that marks none (a checkout from before the counter); and on a
synthetic trace: the mean over calls of each call's lone rounds over its
rounds, nothing where no counter is marked."""

import json

import pytest

from benchmark import core, peaks, plugins, timeline
from benchmark.tests.test_bench_ksparse_crate_a import CELL, SECONDS, TINY
from sparse_linear_assignment_tpu_torch import batch

METRIC = "solver.lone_round_share"


def read(rec):
    return plugins.load_module("metrics", METRIC).read(rec)


def test_a_traced_tiny_run_reads_the_share(monkeypatch, tmp_path):
    """Rows of 8 slots fit the burst: a 64-person instance's rounds of
    one active person are many, never more than its burst rounds."""
    monkeypatch.setattr(core, "CACHE", tmp_path)
    r = core.run(CELL, 2**40 + 11, SECONDS, True, "cpu", overrides=TINY)
    assert r["correct"]
    share = r["metrics"][METRIC]
    burst = r["metrics"]["solver.burst_round_share"]["value"]
    assert share["unit"] == "%" and 0 < share["value"] <= burst < 100


def test_a_program_without_the_counter_reads_nothing(monkeypatch, tmp_path):
    """The program marks its lone rounds under another name, as a
    checkout from before the counter marks none: the line leaves the
    metric out and keeps the others."""
    monkeypatch.setattr(core, "CACHE", tmp_path)
    monkeypatch.setattr(batch, "LONE_ROUNDS", "slap.no_such_counter")
    r = core.run(CELL, 2**40 + 11, SECONDS, True, "cpu", overrides=TINY)
    assert r["correct"]
    assert METRIC not in r["metrics"]
    assert r["metrics"]["solver.burst_round_share"]["value"] > 0


def _x(name, ts):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts,
            "dur": 0}


def test_reader_on_a_synthetic_trace(tmp_path):
    """Call 1 [10, 40]: two batches, 6 of 10 and 12 of 30 lone rounds
    (45%).  Call 2 [50, 90]: 3 of 12 (25%).  Call 3 [92, 94] marks none,
    and a counter at 95 lies in the call the window cut."""
    ev = [
        {"ph": "X", "name": timeline.WINDOW_SPAN, "cat": "user_annotation",
         "ts": 0, "dur": 100},
        *({"ph": "X", "name": timeline.CALL_SPAN, "cat": "user_annotation",
           "ts": lo, "dur": hi - lo}
          for lo, hi in ((10, 40), (50, 90), (92, 94), (95, 150))),
        _x("slap.lone_rounds=6,10", 20),
        _x("slap.lone_rounds=12,30", 33),
        _x("slap.burst_rounds=9,30", 33),
        _x("slap.lone_rounds=3,12", 71),
        _x("slap.lone_rounds=1,1", 96),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rec = timeline.load(path, [True, True, True, False], [3, 2, 1],
                        (1.0, 0), peaks.H100)
    assert read(rec) == pytest.approx((45.0 + 25.0) / 2)
    bare = timeline.Records(**dict(rec.__dict__, host_ops=[
        o for o in rec.host_ops if "lone" not in o.name]))
    assert read(bare) is None
