"""The reference crate's asymmetric bench as a cell
(``ksparse-crate-b.b256x2-n2000-m60000``): its generator, a whole run at
a tiny size on the CPU (the arc route: 32 persons over 19,400 objects is
past the plane kernel's shared memory), the same run with broken
answers, and its two metric readers on a synthetic trace."""

import json

import pytest
import torch

from benchmark import core, peaks, plugins, timeline
from benchmark.tests.test_bench_faults import FAULTS

CELL = "ksparse-crate-b.b256x2-n2000-m60000"
TINY = dict(batch=4, rows=32, cols=19_400, pool=3, warm_calls=1,
            sample={"per_call": 4, "max_checked": 64})


def _gen():
    c = plugins.cell(CELL)
    return plugins.load_module("gen", c.spec["generator"]), c


@pytest.mark.parametrize("seed", [3, 2**40 + 11])
def test_generator_draws_the_crates_instances(seed):
    gen, c = _gen()
    spec = dict(c.spec, batch=3, rows=500, pool=2)
    pool = gen.make(spec, c.config, seed, "cpu")
    again = gen.make(spec, c.config, seed, "cpu")
    other = gen.make(spec, c.config, seed + 1, "cpu")
    assert len(pool) == 2
    for (cols, vals), (c2, v2) in zip(pool, again):
        assert cols.shape == vals.shape == (3, 500, 32)
        assert cols.dtype == torch.int32 and vals.dtype == torch.float32
        assert torch.equal(cols, c2) and torch.equal(vals, v2)
        ordered = cols.sort(dim=2).values
        assert bool((ordered[:, :, 1:] != ordered[:, :, :-1]).all())
        assert int(cols.min()) >= 0 and int(cols.max()) < 60_000
        assert not bool((cols.diff(dim=2) > 0).all())  # draw order kept
        assert torch.equal(vals, vals.floor())
        assert int(vals.min()) >= 300 and int(vals.max()) <= 999
        # Beta(3, 3) on [300, 1000): mean 650, sd 700 / sqrt(28) = 132
        assert abs(float(vals.mean()) - 650) < 5
        assert abs(float(vals.std()) - 132.3) < 5
    assert not torch.equal(pool[0][0], other[0][0])
    assert not torch.equal(pool[0][0], pool[1][0])
    costs = gen.reference_costs(pool[0], torch.tensor([2]), spec)
    assert costs.shape == (1, 500, 60_000)
    assert int(torch.isfinite(costs).sum()) == 500 * 32


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(trace, monkeypatch, tmp_path):
    from sparse_linear_assignment_tpu_torch import batch

    # the trace in this test's own folder, clear of other workers' runs
    monkeypatch.setattr(core, "CACHE", tmp_path)
    before = batch.SPARSE_ROUTES["arcs"]
    r = core.run(CELL, 2**40 + 5, 1.0, trace, "cpu", overrides=TINY)
    assert r["correct"] and r["checked"] > 0 and r["attempted"] > 0
    assert all(v["value"] == 0 for v in r["compared"].values())
    assert batch.SPARSE_ROUTES["arcs"] > before
    if trace:
        for name in ("sparse.stage_ms", "entry.finish_ms",
                     "entry.invert_ms", "solver.wait_ms",
                     "solver.nits_max"):
            assert r["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_answers_are_not_correct(fault):
    r = core.run(CELL, 97, 1.0, False, "cpu", overrides=TINY, fault=fault)
    assert not r["correct"]


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_readers_on_a_synthetic_trace(tmp_path):
    """Call 1 [10, 40]: stages [11, 14] and [15, 17], the arc kernel
    [20, 26] and [24, 30] (two streams, overlapping), another kernel
    [31, 33].  Call 2 [50, 90]: a stage [51, 55], the kernel [60, 70].
    A stage at 95 in the call the window cut."""
    sym = "void (anonymous namespace)::ksp_arcs_rounds_kernel<false>(int)"
    ev = [
        _x(timeline.WINDOW_SPAN, "user_annotation", 0, 100),
        _x(timeline.CALL_SPAN, "user_annotation", 10, 30),
        _x(timeline.CALL_SPAN, "user_annotation", 50, 40),
        _x(timeline.CALL_SPAN, "user_annotation", 95, 150),
        _x("slap.stage", "user_annotation", 11, 3),
        _x("slap.stage", "user_annotation", 15, 2),
        _x("slap.stage", "user_annotation", 51, 4),
        _x("slap.stage", "user_annotation", 96, 3),
        _x(sym, "kernel", 20, 6),
        _x(sym, "kernel", 24, 6),
        _x("elementwise_kernel", "kernel", 31, 2),
        _x(sym, "kernel", 60, 10),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rec = timeline.load(path, [True, True, False], [3, 2],
                        (3.35e12 * 2e-6, 0), peaks.H100)

    def read(name, r):
        return plugins.load_module("metrics", name).read(r)

    # stages: 5 us in call 1, 4 in call 2
    assert read("sparse.stage_ms", rec) == pytest.approx(4.5e-3)
    # two calls of 2 us least time over 10 + 10 us of the kernel
    assert read("kernels.ksp_arcs_roofline", rec) == pytest.approx(20.0)
    bare = timeline.Records(**dict(rec.__dict__, host_ops=[], device_ops=[
        o for o in rec.device_ops if "ksp_arcs" not in o.name]))
    assert read("sparse.stage_ms", bare) is None
    assert read("kernels.ksp_arcs_roofline", bare) is None
