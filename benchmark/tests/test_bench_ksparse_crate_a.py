"""The reference crate's symmetric bench as a cell
(``ksparse-crate-a.b128x2-n10000``): its generator, a whole run at a
tiny size on the CPU (the eps-scaling ladder's plain version), the same
run with broken answers and under the ``eps1`` control, and its two new
metric readers on a synthetic trace."""

import json

import numpy as np
import pytest
import torch

from benchmark import core, peaks, plugins, timeline
from benchmark.tests.test_bench_faults import FAULTS
from benchmark.tests.tiny import manifest_with

CELL = "ksparse-crate-a.b128x2-n10000"
TINY = dict(batch=4, rows=64, cols=64, arcs=8, pool=3, warm_calls=1,
            sample={"per_call": 2, "max_checked": 32})

#: the window of a tiny run: a call takes about 0.6 s on the CPU
SECONDS = 2.0

#: config A's law at side 64 with 10% arcs, where ε = 1 leaves optima
#: unfound: name, chips, configuration, workload file
DENSER = ("ksparse-crate-a-denser.b16-n64", 1, dict(
    json.loads((plugins.ROOT / "configs" / "ksparse-crate-a.json")
               .read_text()),
    name="ksparse-crate-a-denser", rows=64, cols=64, density=0.1), dict(
    json.loads((plugins.ROOT / "workloads" / f"{CELL}.json").read_text()),
    config="ksparse-crate-a-denser", batch=16, rows=64, cols=64, arcs=24,
    pool=2, warm_calls=1, sample={"per_call": 16, "max_checked": 64}))


def _gen():
    c = plugins.cell(CELL)
    return plugins.load_module("gen", c.spec["generator"]), c


@pytest.mark.parametrize("seed", [3, 2**40 + 11])
def test_generator_draws_the_crates_instances(seed):
    gen, c = _gen()
    spec = dict(c.spec, batch=3, rows=2000, cols=2000, arcs=64, pool=2)
    config = dict(c.config, density=0.02)
    pool = gen.make(spec, config, seed, "cpu")
    again = gen.make(spec, config, seed, "cpu")
    other = gen.make(spec, config, seed + 1, "cpu")
    assert len(pool) == 2
    for (cols, vals), (c2, v2) in zip(pool, again):
        assert cols.shape == vals.shape == (3, 2000, 64)
        assert cols.dtype == torch.int32 and vals.dtype == torch.float32
        assert torch.equal(cols, c2) and torch.equal(vals, v2)
        arcs = cols >= 0
        count = arcs.sum(dim=2)
        # the arcs first in a row, then -1 pads
        assert torch.equal(arcs, torch.arange(64) < count[:, :, None])
        ordered = torch.where(arcs, cols, -1 - torch.arange(64)).sort(
            dim=2).values
        assert bool((ordered[:, :, 1:] != ordered[:, :, :-1]).all())
        assert int(cols.max()) < 2000
        # Binomial(2000, 0.02) arcs and the ensured one: mean 41 or so
        assert abs(float(count.float().mean()) - 41.0) < 0.5
        # the ensured perfect matching: a column of every row, a
        # permutation of the columns in every instance
        w = vals[arcs]
        assert float(w.min()) >= 500 and float(w.max()) < 1000
        assert abs(float(w.double().mean()) - 750) < 1
        assert torch.equal(w, w * 2**15 // 1 / 2**15)  # on the 2^-15 lattice
        assert bool((vals[~arcs] == 0).all())
    assert not torch.equal(pool[0][0], other[0][0])
    assert not torch.equal(pool[0][0], pool[1][0])
    costs = gen.reference_costs(pool[0], torch.tensor([2]), spec)
    assert costs.shape == (1, 2000, 2000)
    assert int(torch.isfinite(costs).sum()) == int((pool[0][0][2] >= 0).sum())


def test_every_instance_has_a_perfect_matching():
    from scipy.optimize import linear_sum_assignment

    gen, c = _gen()
    spec = dict(c.spec, batch=4, rows=300, cols=300, arcs=16, pool=1)
    costs = gen.reference_costs(gen.make(spec, c.config, 5, "cpu")[0],
                                torch.arange(4), spec)
    for x in costs.numpy():
        rows, cols = linear_sum_assignment(np.where(np.isinf(x), 1e9, x))
        assert x[rows, cols].max() < 1000


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(trace, monkeypatch, tmp_path):
    from sparse_linear_assignment_tpu_torch import batch

    monkeypatch.setattr(core, "CACHE", tmp_path)
    before = batch.SPARSE_ROUTES["arcs"]
    r = core.run(CELL, 2**40 + 5, SECONDS, trace, "cpu", overrides=TINY)
    assert r["correct"] and r["checked"] > 0 and r["attempted"] > 0
    assert all(v["value"] == 0 for v in r["compared"].values())
    assert batch.SPARSE_ROUTES["arcs"] > before
    if trace:
        for name in ("sparse.stage_ms", "entry.finish_ms",
                     "entry.invert_ms", "solver.wait_ms",
                     "solver.nits_max", "solver.last_phase_rounds"):
            assert r["metrics"][name]["value"] > 0, name


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_answers_are_not_correct(fault):
    r = core.run(CELL, 97, SECONDS, False, "cpu", overrides=TINY, fault=fault)
    assert not r["correct"]


def test_eps1_control_is_not_correct(tmp_path):
    """ε = 1 cost unit, n·ε far above the values' 2^-15 lattice: the
    ladder ends a phase short of the optimum in some instances."""
    r = core.run(DENSER[0], 99, SECONDS, False, "cpu", control={"eps": 1.0},
                 manifest=manifest_with(DENSER, tmp_path))
    assert not r["correct"]
    assert r["compared"]["not_optimal"]["value"] > 0


def test_denser_cell_is_correct(tmp_path):
    r = core.run(DENSER[0], 99, SECONDS, False, "cpu",
                 manifest=manifest_with(DENSER, tmp_path))
    assert r["correct"] and r["checked"] > 0


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_readers_on_a_synthetic_trace(tmp_path):
    """Call 1 [10, 40]: counters of 7 and 9 rounds, the ladder kernel
    [20, 26] and [24, 30] (two streams, overlapping), another kernel
    [31, 33].  Call 2 [50, 90]: a counter of 4, the kernel [60, 70].  A
    counter at 95 in the call the window cut."""
    sym = "void (anonymous namespace)::ksp_arcs_ladder_kernel<double>(int)"
    ev = [
        _x(timeline.WINDOW_SPAN, "user_annotation", 0, 100),
        _x(timeline.CALL_SPAN, "user_annotation", 10, 30),
        _x(timeline.CALL_SPAN, "user_annotation", 50, 40),
        _x(timeline.CALL_SPAN, "user_annotation", 95, 150),
        _x("slap.last_phase_rounds=7", "user_annotation", 27, 0),
        _x("slap.last_phase_rounds=9", "user_annotation", 32, 0),
        _x("slap.rounds_by_phase=3,9", "user_annotation", 32, 0),
        _x("slap.last_phase_rounds=4", "user_annotation", 71, 0),
        _x("slap.last_phase_rounds=50", "user_annotation", 96, 0),
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

    assert read("solver.last_phase_rounds", rec) == pytest.approx(6.5)
    # two calls of 2 us least time over 10 + 10 us of the kernel
    assert read("kernels.ksp_ladder_roofline", rec) == pytest.approx(20.0)
    bare = timeline.Records(**dict(rec.__dict__, host_ops=[], device_ops=[
        o for o in rec.device_ops if "ladder" not in o.name]))
    assert read("solver.last_phase_rounds", bare) is None
    assert read("kernels.ksp_ladder_roofline", bare) is None
