"""``solver.burst_round_share`` (``metrics/solver.burst_round_share.py``):
read from the records of a tiny run of the config A cell on the CPU,
where the ladder's plain version marks the program's
``slap.burst_rounds`` counters, and on a synthetic trace: the mean over
calls of each call's burst rounds over its rounds, nothing where no
counter is marked."""

import json

import pytest

from benchmark import core, peaks, plugins, timeline
from benchmark.tests.test_bench_ksparse_crate_a import CELL, SECONDS, TINY

METRIC = "solver.burst_round_share"


def read(rec):
    return plugins.load_module("metrics", METRIC).read(rec)


def test_a_traced_tiny_run_reads_the_share(monkeypatch, tmp_path):
    """Rows of 8 slots fit the burst, and a 64-person instance's rounds
    with few active persons are many but not all."""
    monkeypatch.setattr(core, "CACHE", tmp_path)
    r = core.run(CELL, 2**40 + 7, SECONDS, True, "cpu", overrides=TINY)
    assert r["correct"]
    share = r["metrics"][METRIC]
    assert share["unit"] == "%" and 0 < share["value"] < 100


def _x(name, ts):
    return {"ph": "X", "name": name, "cat": "user_annotation", "ts": ts,
            "dur": 0}


def test_reader_on_a_synthetic_trace(tmp_path):
    """Call 1 [10, 40]: two batches, 3 of 10 and 5 of 30 burst rounds
    (20%).  Call 2 [50, 90]: 9 of 12 (75%).  Call 3 [92, 94] marks none,
    and a counter at 95 lies in the call the window cut."""
    ev = [
        {"ph": "X", "name": timeline.WINDOW_SPAN, "cat": "user_annotation",
         "ts": 0, "dur": 100},
        *({"ph": "X", "name": timeline.CALL_SPAN, "cat": "user_annotation",
           "ts": lo, "dur": hi - lo}
          for lo, hi in ((10, 40), (50, 90), (92, 94), (95, 150))),
        _x("slap.burst_rounds=3,10", 20),
        _x("slap.burst_rounds=5,30", 33),
        _x("slap.last_phase_rounds=9", 33),
        _x("slap.burst_rounds=9,12", 71),
        _x("slap.burst_rounds=1,1", 96),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rec = timeline.load(path, [True, True, True, False], [3, 2, 1],
                        (1.0, 0), peaks.H100)
    assert read(rec) == pytest.approx((20.0 + 75.0) / 2)
    bare = timeline.Records(**dict(rec.__dict__, host_ops=[
        o for o in rec.host_ops if "burst" not in o.name]))
    assert read(bare) is None
