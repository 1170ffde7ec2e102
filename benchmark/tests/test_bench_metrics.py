"""The per-layer metrics' arithmetic on a synthetic profiler trace."""

import json

import pytest

from benchmark import peaks, plugins, timeline


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace(tmp_path):
    """A window of 100 us holding two calls and one call cut by the
    window's end.  Call 1 [10, 40]: kernels [15, 25] and [20, 30] (they
    overlap), host code to 40.  Call 2 [50, 90]: a memcpy [52, 54] and a
    kernel [60, 70]; an nccl kernel [70, 72].  Outside the window: a
    kernel at 200."""
    ev = [
        _x(timeline.WINDOW_SPAN, "user_annotation", 0, 100),
        _x(timeline.CALL_SPAN, "user_annotation", 10, 30),
        _x(timeline.CALL_SPAN, "user_annotation", 50, 40),
        _x(timeline.CALL_SPAN, "user_annotation", 95, 150),
        _x("fr_kernel", "kernel", 15, 10),
        _x("other", "kernel", 20, 10),
        _x("Memcpy HtoD", "gpu_memcpy", 52, 2),
        _x("fr_kernel", "kernel", 60, 10),
        _x("ncclDevKernel_AllGather", "kernel", 70, 2),
        _x("late", "kernel", 200, 5),
        _x("aten::copy_", "cpu_op", 51, 4),
        _x("cudaStreamSynchronize", "cuda_runtime", 54, 6),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return timeline.load(path, [True, True, False], [700, 900],
                         (3.35e12 * 1e-6, 0), peaks.H100)


def _read(name, rec):
    return plugins.load_module("metrics", name).read(rec)


def test_records_keep_the_window(tmp_path):
    rec = _trace(tmp_path)
    assert rec.window == (0, 100)
    assert rec.calls == [(10, 40), (50, 90)]
    assert len(rec.device_ops) == 5
    assert [len(ops) for ops in rec.call_ops()] == [2, 3]


def test_head_and_tail(tmp_path):
    rec = _trace(tmp_path)
    # heads 15 - 10 and 52 - 50 us; tails 40 - 30 and 90 - 72 us
    assert _read("entry.host_head_ms", rec) == pytest.approx(3.5e-3)
    assert _read("entry.host_tail_ms", rec) == pytest.approx(14e-3)


def test_idle_share_and_busy(tmp_path):
    rec = _trace(tmp_path)
    # busy: [15, 30] + [52, 54] + [60, 72] = 29 us of 100
    assert timeline.busy_us(rec) == pytest.approx(29)
    assert _read("device.idle_share", rec) == pytest.approx(71)


def test_roofline(tmp_path):
    rec = _trace(tmp_path)
    # one call's problem needs 1 us at the bandwidth; two calls ran 29 us
    assert _read("kernels.roofline", rec) == pytest.approx(100 * 2 / 29)
    ops_bound = dict(rec.__dict__, work=(0, 67e12 * 2e-6))
    assert _read("kernels.roofline", timeline.Records(**ops_bound)) == (
        pytest.approx(100 * 4 / 29))


def test_nits_and_nccl(tmp_path):
    rec = _trace(tmp_path)
    assert _read("solver.nits_max", rec) == 800
    assert _read("sharded.nccl_ms", rec) == pytest.approx(1e-3)


def test_readers_return_nothing_without_device_ops(tmp_path):
    rec = _trace(tmp_path)
    empty = timeline.Records(**dict(rec.__dict__, device_ops=[]))
    for name in ("entry.host_head_ms", "entry.host_tail_ms",
                 "kernels.roofline", "device.idle_share", "sharded.nccl_ms"):
        assert _read(name, empty) is None


def test_breakdown_names_the_host_work(tmp_path):
    bd = timeline.breakdown(_trace(tmp_path))
    ops = dict(bd["device_ops"])
    assert ops["fr_kernel"] == pytest.approx(20e-6)
    idle = dict(bd["idle_gaps"])
    # gaps [0, 15] and [30, 52] have their middles outside any call;
    # [54, 60] is the sync's; [72, 100] has its middle in call 2's span
    # with no host event under it
    assert idle[f"{timeline.WINDOW_SPAN}: between calls (harness)"] == (
        pytest.approx((15 + 22) * 1e-6))
    assert idle["cudaStreamSynchronize"] == pytest.approx(6e-6)
    assert idle[f"{timeline.CALL_SPAN}: host code, no torch op"] == (
        pytest.approx(28e-6))
    assert sum(idle.values()) == pytest.approx(71e-6)
