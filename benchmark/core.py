"""One run of one cell: inputs, warm-up, the measured window, the check
against the plain reference and the result line.

``run`` is the whole run below the command line: ``run.py`` looks for
the cards and starts the ranks of a four-card cell; the CPU tests call
``run`` with ``device="cpu"`` at tiny sizes.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import sys
import time
from contextlib import nullcontext

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import guard, peaks, plugins, seeds, timeline
from benchmark.reference import certificate

#: where a traced run writes its Chrome trace (one file a rank, replaced
#: by every traced run)
CACHE = plugins.ROOT / ".cache"

#: the numbers ``correct`` compares, each with its limit (see PERF.md):
#: persons left unassigned over every answer of the window, and, over
#: the checked sample, answers whose maps disagree, the largest gap
#: between a reported objective and its matching's cost, and answers
#: that an exchange of objects makes cheaper
LIMITS = {"unassigned": 0, "invalid": 0, "objective_gap": 0.0,
          "not_optimal": 0}


class RunFailed(RuntimeError):
    """A run that must print no result."""


@dataclasses.dataclass
class Context:
    """What an entry adapter sees: the cell's workload file, the device,
    the input pool, the entry's keyword arguments and its own state."""

    spec: dict
    device: torch.device
    pool: list
    args: dict
    state: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Sample:
    """The answers of some instances of one pool batch, kept for the
    check after the window."""

    key: int
    idx: np.ndarray
    p2o: np.ndarray
    o2p: np.ndarray
    num_unassigned: np.ndarray
    objective: np.ndarray
    nits: np.ndarray


def entry_args(spec: dict, eps=None) -> dict:
    """The entry's keyword arguments: the workload's ``entry_args``, with
    ``eps_denominator`` turned into ``eps`` (or ``eps`` overridden)."""
    args = dict(spec.get("entry_args", {}))
    den = args.pop("eps_denominator", None)
    if den is not None:
        args["eps"] = 1.0 / den
    if eps is not None:
        args["eps"] = eps
    return args


def call_keys(spec: dict, c: int) -> list:
    """The pool batches of call ``c``: the next ``batches_per_call`` in
    order, so no call repeats the batches of the one before it."""
    per = spec["batches_per_call"]
    return [(c * per + j) % spec["pool"] for j in range(per)]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sample(spec, seed, c, keys, sols) -> list:
    """Instances of call ``c`` drawn from the seed, with each batch's
    slowest instance."""
    out = []
    for j, (key, sol) in enumerate(zip(keys, sols)):
        b = sol.person_to_object.shape[0]
        take = min(b, spec["sample"]["per_call"])
        idx = seeds.rng(seed, seeds.SAMPLE, c, j).choice(b, size=take,
                                                       replace=False)
        idx = np.unique(np.append(idx, int(np.argmax(sol.nits))))
        out.append(Sample(
            key=key, idx=idx,
            p2o=sol.person_to_object[idx].copy(),
            o2p=sol.object_to_person[idx].copy(),
            num_unassigned=np.asarray(sol.num_unassigned)[idx].copy(),
            objective=np.asarray(sol.objective)[idx].copy(),
            nits=np.asarray(sol.nits)[idx].copy(),
        ))
    return out


def _thin(samples: list, cap: int, seed: int) -> list:
    """At most ``cap`` sampled instances: a quarter the slowest, the rest
    drawn from the seed."""
    rows = [(i, j) for i, s in enumerate(samples) for j in range(len(s.idx))]
    if len(rows) <= cap:
        return samples
    nits = np.array([samples[i].nits[j] for i, j in rows])
    slow = set(np.argsort(-nits, kind="stable")[:cap // 4].tolist())
    rest = [r for r in range(len(rows)) if r not in slow]
    pick = seeds.rng(seed, seeds.THIN).choice(len(rest), cap - len(slow),
                                              replace=False)
    keep = sorted(slow | {rest[p] for p in pick})
    by_sample: dict = {}
    for r in keep:
        i, j = rows[r]
        by_sample.setdefault(i, []).append(j)
    return [dataclasses.replace(
        samples[i], idx=samples[i].idx[js], p2o=samples[i].p2o[js],
        o2p=samples[i].o2p[js], num_unassigned=samples[i].num_unassigned[js],
        objective=samples[i].objective[js], nits=samples[i].nits[js])
        for i, js in sorted(by_sample.items())]


def check(gen, spec, truth: list, samples: list, unassigned: int,
          expected_shape: tuple) -> dict:
    """The compared numbers of a run, from the plain reference over the
    sampled answers and the true inputs ``truth``."""
    nums = dict(unassigned=int(unassigned), invalid=0, objective_gap=0.0,
                not_optimal=0, checked=0)
    for s in samples:
        if s.p2o.shape[1:] != expected_shape[1:2] or (
                s.o2p.shape[1:] != expected_shape[2:3]):
            nums["invalid"] += len(s.idx)
            continue
        costs = gen.reference_costs(truth[s.key], torch.from_numpy(s.idx),
                                    spec)
        v = certificate.judge(costs, s.p2o, s.o2p, s.num_unassigned,
                              s.objective)
        nums["invalid"] += int(v["invalid"].sum())
        nums["objective_gap"] = max(nums["objective_gap"],
                                    float(v["objective_gap"].max()))
        nums["not_optimal"] += int(v["improvable"].sum())
        nums["checked"] += len(s.idx)
        del costs, v
    return nums


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", *, t_start: float | None = None, rank: int = 0,
        world: int = 1, group=None, overrides: dict | None = None,
        control: dict | None = None, fault=None,
        manifest=plugins.MANIFEST) -> dict | None:
    """Run ``cell_name`` once; the result line's object on rank 0, None
    on the other ranks.

    ``overrides`` replace workload keys (the CPU tests' tiny sizes).
    ``control`` runs a control instead of the program as configured:
    ``{"eps": e}`` solves at another ε, ``{"dtype": d}`` hands the entry
    inputs rounded through ``d``; the check still reads the true inputs.
    ``fault(keys, sols) -> sols`` breaks the answers (the CPU tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    cell = plugins.cell(cell_name, manifest)
    spec = dict(cell.spec, **(overrides or {}))
    gen = plugins.load_module("gen", spec["generator"])
    entry = plugins.load_module("entries", spec["entry"])
    control = control or {}

    truth = gen.make(spec, cell.config, seed, device)
    pool = ([gen.coarsen(x, control["dtype"]) for x in truth]
            if "dtype" in control else truth)
    ctx = Context(spec=spec, device=device, pool=pool,
                  args=entry_args(spec, control.get("eps")))
    if hasattr(entry, "prepare"):
        entry.prepare(ctx)

    def one_call(c):
        keys = call_keys(spec, c)
        sols = entry.call(ctx, keys)
        return keys, (fault(keys, sols) if fault else sols)

    for w in range(spec["warm_calls"]):
        one_call(-1 - w)
    _sync(device)
    loaded = guard.forbidden_modules()
    if device.type == "cuda":
        base_bytes = torch.cuda.memory_allocated(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    def agree(go: bool) -> bool:
        """Rank 0's decision, on every rank (each call is collective)."""
        if group is None:
            return go
        flag = torch.tensor([int(go)])
        torch.distributed.broadcast(flag, src=0, group=group)
        return bool(flag.item())

    calls_ms, done_in_window, samples, nits_max = [], [], [], []
    instances = unassigned = 0
    profiler = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if trace else nullcontext())
    with profiler as prof:
        with record_function(timeline.WINDOW_SPAN):
            t0 = time.perf_counter()
            c = 0
            while agree(time.perf_counter() - t0 < seconds):
                a = time.perf_counter()
                with record_function(timeline.CALL_SPAN):
                    keys, sols = one_call(c)
                b = time.perf_counter()
                inside = agree(b - t0 <= seconds)
                done_in_window.append(inside)
                if not inside:
                    break
                calls_ms.append((b - a) * 1e3)
                instances += sum(s.person_to_object.shape[0] for s in sols)
                unassigned += sum(int(np.sum(s.num_unassigned))
                                  for s in sols)
                nits_max.append(max(int(np.max(s.nits)) for s in sols))
                if rank == 0:
                    samples += _sample(spec, seed, c, keys, sols)
                del sols
                c += 1
            window_s = time.perf_counter() - t0
    loaded += guard.forbidden_modules()

    stats = dict(peak_extra=0, memory_peak=0, busy_s=0.0, window_s=0.0,
                 loaded=loaded)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
        stats.update(peak_extra=peak - base_bytes,
                     memory_peak=max(setup_peak, peak))
    ctx.state.clear()
    del ctx, pool
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    layer = {}
    breakdown = None
    if trace:
        CACHE.mkdir(parents=True, exist_ok=True)
        path = CACHE / f"trace-rank{rank}.json"
        prof.export_chrome_trace(str(path))
        del prof
        rec = timeline.load(path, done_in_window, nits_max,
                            entry.work(spec, world), peaks.H100)
        path.unlink()
        stats.update(busy_s=timeline.busy_us(rec) * 1e-6,
                     window_s=(rec.window[1] - rec.window[0]) * 1e-6)
        if rank == 0:
            for m in cell.per_layer:
                value = plugins.load_module("metrics", m["name"]).read(rec)
                if value is not None:
                    layer[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = timeline.breakdown(rec)

    if group is not None:
        every = [None] * world
        torch.distributed.all_gather_object(every, stats, group=group)
    else:
        every = [stats]
    if rank != 0:
        return None

    shape = (spec["batch"], spec["rows"], spec["cols"])
    nums = check(gen, spec, truth,
                 _thin(samples, spec["sample"]["max_checked"], seed),
                 unassigned, shape)
    del truth
    loaded = sorted({m for s in every for m in s["loaded"]}
                    | set(guard.forbidden_modules()))
    if loaded:
        raise RunFailed("forbidden modules loaded: " + ", ".join(loaded))
    if not calls_ms:
        raise RunFailed("no call completed inside the window")

    compared = {k: {"value": nums[k], "limit": lim}
                for k, lim in LIMITS.items()}
    correct = nums["checked"] > 0 and all(
        nums[k] <= lim for k, lim in LIMITS.items())
    failed = nums["invalid"] + nums["not_optimal"] + (
        1 if nums["objective_gap"] > LIMITS["objective_gap"] else 0)
    if trace:
        metrics = layer
    else:
        values = {
            "instances_per_s": instances / seconds,
            "call_ms_p95": float(np.percentile(calls_ms, 95)),
            "peak_extra_gib": max(s["peak_extra"] for s in every) / 2**30,
            "setup_s": setup_s,
        }
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                 else "cpu"),
        "count": world,
        "memory_peak_bytes": max(s["memory_peak"] for s in every),
    }
    if trace:
        dev["busy_s"] = statistics.fmean(s["busy_s"] for s in every)
        dev["window_s"] = statistics.fmean(s["window_s"] for s in every)
    result = {
        "correct": bool(correct),
        "attempted": instances,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result.update(checked=nums["checked"], calls=len(calls_ms),
                  window_s=window_s, compared=compared)  # compared last
    return result


def report(result: dict) -> None:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output."""
    for k, v in result["compared"].items():
        print(f"compared {k} = {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
