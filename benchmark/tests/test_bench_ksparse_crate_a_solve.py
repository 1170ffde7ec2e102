"""The crate's own mode for config A as a cell
(``ksparse-crate-a-solve.b1-n10000``): one instance a call through
``KhoslaSolver.solve(scale_eps=True)`` (``entries/crate_solve.py``).  A
whole run at a tiny size on the CPU, on the CPU's own route and on the
arc ladder route (``arc_route``: the card's route, run on the CPU),
traced and not; broken answers and the ``eps1`` control; the
``entry.csr_arcs_ms`` reader on a synthetic trace; a fresh solver each
call; a program without the route refused before the first call."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark import core, peaks, plugins, timeline
from benchmark.reference.certificate import UNASSIGNED
from benchmark.tests.test_bench_faults import answer_altered
from benchmark.tests.tiny import manifest_with
from sparse_linear_assignment_tpu_torch import KhoslaSolver, batch
from sparse_linear_assignment_tpu_torch.ops import ksparse_arcs as ka

CELL = "ksparse-crate-a-solve.b1-n10000"
TINY = dict(rows=64, cols=64, arcs=16, pool=3, warm_calls=1)

#: the window of a tiny run: a call takes about 0.1 to 0.4 s on the CPU
SECONDS = 2.0

#: config A's law at side 128 with 10% arcs, where ε = 1 leaves about
#: half the optima unfound: name, chips, configuration, workload file
DENSER = ("ksparse-crate-a-solve-denser.b1-n128", 1, dict(
    json.loads((plugins.ROOT / "configs" / "ksparse-crate-a-solve.json")
               .read_text()),
    name="ksparse-crate-a-solve-denser", rows=128, cols=128, density=0.1),
    dict(json.loads((plugins.ROOT / "workloads" / f"{CELL}.json")
                    .read_text()),
         config="ksparse-crate-a-solve-denser", rows=128, cols=128,
         arcs=32, pool=16, warm_calls=1,
         sample={"per_call": 1, "max_checked": 64}))


def take_arc_route(monkeypatch) -> None:
    """``KhoslaSolver.solve`` inside its ``slap.solve`` span as a card
    runs the cell's request: its preparation, then the arc ladder route,
    here with the kernel's plain version."""
    def _solve(self, solution, maximize, eps, max_rounds, *_):
        self.validate_input()
        self.init_solve(solution, maximize)
        solution.eps = eps
        self._solve_arc_ladder(solution, eps, max_rounds,
                               torch.device("cpu"))

    monkeypatch.setattr(KhoslaSolver, "_solve", _solve)


@pytest.fixture
def arc_route(monkeypatch):
    take_arc_route(monkeypatch)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("route", ["slot-list", "arcs"])
def test_cell_runs_correct_on_the_cpu(route, trace, monkeypatch, tmp_path):
    if route == "arcs":
        take_arc_route(monkeypatch)
    monkeypatch.setattr(core, "CACHE", tmp_path)
    launches = ka.LADDER_LAUNCHES
    r = core.run(CELL, 2**40 + 5, SECONDS, trace, "cpu", overrides=TINY)
    assert r["correct"] and r["checked"] > 0 and r["attempted"] > 0
    assert all(v["value"] == 0 for v in r["compared"].values())
    assert ka.LADDER_LAUNCHES == launches  # the plain version on the CPU
    if trace:
        names = ["solver.nits_max"]
        if route == "arcs":
            names += ["entry.csr_arcs_ms", "sparse.stage_ms",
                      "entry.finish_ms", "entry.invert_ms",
                      "solver.wait_ms", "solver.last_phase_rounds",
                      "solver.burst_round_share"]
        else:
            assert "entry.csr_arcs_ms" not in r["metrics"]
        for name in names:
            assert r["metrics"][name]["value"] > 0, name


def half_left_unassigned(keys, sols):
    """Every other person of each instance reported unassigned."""
    out = []
    for s in sols:
        p2o = s.person_to_object.copy()
        p2o[:, ::2] = UNASSIGNED
        o2p = s.object_to_person.copy()
        o2p[np.isin(o2p, np.arange(0, p2o.shape[1], 2))] = UNASSIGNED
        out.append(dataclasses.replace(
            s, person_to_object=p2o, object_to_person=o2p,
            num_unassigned=(p2o == UNASSIGNED).sum(axis=1).astype(
                np.int32)))
    return out


@pytest.mark.parametrize("fault", [answer_altered, half_left_unassigned],
                         ids=lambda f: f.__name__)
def test_broken_answers_are_not_correct(fault, arc_route):
    r = core.run(CELL, 97, SECONDS, False, "cpu", overrides=TINY, fault=fault)
    assert not r["correct"]


def test_eps1_control_is_not_correct(arc_route, tmp_path):
    """ε = 1 cost unit, n·ε far above the values' 2^-15 lattice: the
    ladder ends a phase short of the optimum in some instances."""
    r = core.run(DENSER[0], 99, SECONDS, False, "cpu", control={"eps": 1.0},
                 manifest=manifest_with(DENSER, tmp_path))
    assert not r["correct"]
    assert r["compared"]["not_optimal"]["value"] > 0


def test_denser_cell_is_correct(arc_route, tmp_path):
    r = core.run(DENSER[0], 99, SECONDS, False, "cpu",
                 manifest=manifest_with(DENSER, tmp_path))
    assert r["correct"] and r["checked"] > 0


def test_each_call_builds_a_fresh_solver(arc_route, monkeypatch):
    built = []
    real = KhoslaSolver.new.__func__

    def new(cls, *args, **kwargs):
        out = real(cls, *args, **kwargs)
        built.append(out[0])
        return out

    monkeypatch.setattr(KhoslaSolver, "new", classmethod(new))
    r = core.run(CELL, 7, 1.0, False, "cpu", overrides=TINY)
    # every call of the window, the warm-up's and a last one the window
    # cut
    assert len(built) >= r["calls"] + TINY["warm_calls"]
    assert len({id(s) for s in built}) == len(built)


def test_a_program_without_the_route_is_refused(monkeypatch):
    monkeypatch.delattr(batch, "solve_csr_scaled")
    with pytest.raises(RuntimeError, match="no arc ladder route"):
        core.run(CELL, 7, 1.0, False, "cpu", overrides=TINY)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_csr_arcs_reader_on_a_synthetic_trace(tmp_path):
    """Call 1 [10, 40]: spans of 3 and 2 us.  Call 2 [50, 90]: one of 5
    us.  One at 95, in the call the window cut."""
    ev = [
        _x(timeline.WINDOW_SPAN, "user_annotation", 0, 100),
        _x(timeline.CALL_SPAN, "user_annotation", 10, 30),
        _x(timeline.CALL_SPAN, "user_annotation", 50, 40),
        _x(timeline.CALL_SPAN, "user_annotation", 95, 150),
        _x("slap.csr_arcs", "user_annotation", 12, 3),
        _x("slap.csr_arcs", "user_annotation", 20, 2),
        _x("slap.csr_arcs", "user_annotation", 55, 5),
        _x("slap.csr_arcs", "user_annotation", 96, 50),
        _x("slap.stage", "user_annotation", 16, 4),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    rec = timeline.load(path, [True, True, False], [3, 2], (0, 0),
                        peaks.H100)
    reader = plugins.load_module("metrics", "entry.csr_arcs_ms")
    assert reader.read(rec) == pytest.approx(5e-3)
    bare = timeline.Records(**dict(rec.__dict__, host_ops=[
        o for o in rec.host_ops if o.name != "slap.csr_arcs"]))
    assert reader.read(bare) is None
