#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the CUDA kernels from
``sparse_linear_assignment_tpu_torch/csrc`` with ``nvcc`` (first use),
holds every kernel against its plain PyTorch version on the card, and
drives the port's paths through ``solve_batch``:

- the batched dense forward-reverse auction at the north-star size,
  4096 instances of 256x256 with integer costs in [1, 1000) on the
  int32 lattice: full matchings, a dual certificate of exact optimality
  for every instance, scipy's objective on a sample;
- big dense singles on the cluster kernel: one 4096x4096 instance
  (scipy's objective) and one 8192x8192 instance made on the card (a
  float64 price certificate);
- the native straggler tail of the host-costs branch (scipy's
  objectives);
- the batched sparse mode on the Khosla kernel: 5 batches of 4096
  instances of 128 persons x 512 objects with 8 arcs per person, made
  and staged on the card (``stage_batch_sparse_device``) and streamed
  (``solve_batch_sparse_stream``), scipy's objective on a sample; the
  kernel's time beside its bound, its phase split and CTA timeline; the
  host-staged path with column compaction (``solve_batch_sparse``) on
  1024 x (256 x 2048, k = 8); a batch with infeasible instances;
- the arc route on the arc Khosla kernel (``csrc/ksp_arcs_kernel.cu``):
  the kernel bit-equal to its plain version in float32 and float64 on
  small cases (unsorted slots, repeated columns, single arcs, an
  infeasible instance), on the float32 stall at the crate's ε, and to
  the plane kernel at 64 x 128 x 8,192; the reference crate's config B,
  2 x 256 x (2,000 x 60,000, 32 arcs) made on the card, staged with no
  plane (float64, ε = 1/60,000) and streamed, scipy's optimum on a
  sample; the kernel's time beside its bound and its plain version, its
  phase split and CTA timeline, its float32 instance where float32
  keeps ε (2^-12) and the padded engine on the same batch;
- the forward engine on the fused round kernel: 4096 instances of
  256 persons x 512 objects through ``solve_batch`` (``solver="auto"``,
  scipy's objective on a sample), the eps-scaling path on 512 x 256²
  (``solver="forward"``), rectangular ``linear_sum_assignment``; the
  Khosla engine and the plain-rounds FR route (float64, N % 128 != 0);
- the single-instance dense round ``fused_dense_round`` on its own
  kernel (``csrc/dense_round_single.cu``; no path calls it): bit-equal to
  the plain round at every checkpoint of the forward chunk's check, and
  timed at 256², 512 x 256 and 4096² from the opening and a late state,
  beside its bound, a latency floor, the ``torch.profiler`` count of
  what one call issues (one launch, no memcpy) and the route it took
  before that kernel (the chunk kernel at B = 1);
- the reference-crate API, which runs no kernel of the port (plain
  PyTorch rounds, graphed, and the native engine): the README example on
  every engine, the error probes and infeasible instances; the
  n = 100,000 headline (``bench.py:169-270``) on the native ladder, the
  hybrid and the device route, each against scipy's
  ``min_weight_full_bipartite_matching`` with its eps-CS certificate,
  and a full-scan and a slot-list chunk bit-equal on the card and the
  CPU; the reference crate's bench configs B (2,000 x 60,000, k = 32)
  and A (n = 10,000, density 1%), native and on the card;
  ``solve_batch_sparse(engine="padded")`` beside ``"dense"``;
- the sharded modes (``parallel/sharded.py``) on a world of one NCCL
  rank: the collective audit on the card; ``solve_batch_sharded`` on the
  north-star batch (FR kernel; bit-equal to ``solve_batch``, every
  instance certified) and its stream of three batches (bit-equal to
  ``solve_batch_stream``); ``solve_batch_sparse_sharded`` on one
  sparse-stream batch (Khosla kernel; bit-equal to
  ``solve_batch_sparse``); ``solve_fr_dense_sharded`` on big-4096 (plain
  rounds; scipy's objective, bit-equal to the big-single route); and
  ``solve_sharded_khosla`` on config B and ``solve_sharded_forward`` on
  config A, each with the native engine's objective; every solve's
  collective counts against the audit table;
- the in-kernel round trace (``ops/round_log.py``) of the three round
  kernels: each kernel's log bit-equal to its plain version's rows
  (``fr_kernel`` at 64 x 256² to done, ``fr_big_kernel`` on the 4096²
  opening and the all-equal 2048² instance, ``ksp_kernel`` on a
  sparse-stream batch), the north-star chunk with tracing on (its
  printed lines parsed) bit-identical to it with tracing off, the
  kernels' times with the trace off and on, their registers and
  spills, and what the traces show (flips, rounds at the last
  unmatched person);
- host costs of six types (uint8, uint32, int64, int8, bool, float16;
  8 x 256²) through ``solve_batch`` on the three dense solvers in both
  senses: scipy's optimum on every instance, or the JAX package's answer
  where integer wraps make it another (pinned by
  ``tests/test_torch_dtypes.py``), the first 2 instances bit-equal to the
  CPU route, and the JAX package's ``TypeError`` where it raises.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present, or when
the port's package is not beside this script.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 20261016
T_START = time.perf_counter()

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(obj) -> None:
    """One JSON line; a phase line also gets the script's elapsed
    seconds at its end (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sync_ms(fn, reps=1):
    """Median wall time (ms) of ``fn()`` ended by a device sync."""
    times = []
    out = None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def event_ms(fn, reps=3):
    """Median device time (ms) of ``fn()`` between two CUDA events."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def lattice_values(costs, negate=True):
    """[B, N, N] integer costs -> (values_t, work) on the int32 lattice
    with scale N + 1, as solve_batch stages them."""
    from sparse_linear_assignment_tpu_torch import batch

    n = costs.shape[1]
    return batch._stage(costs, negate, n + 1)[:2]


def states_equal(a, b):
    from sparse_linear_assignment_tpu_torch.ops.fr_dense import FRState

    bad = [k for k in FRState._fields
           if not torch.equal(getattr(a, k), getattr(b, k))]
    err = max(
        float((getattr(a, k).double() - getattr(b, k).double())
              .abs().max())
        for k in ("prices", "profits")
    )
    return bad, err


def phase_kernel_vs_plain(fr_kernel, fr_init):
    """The kernel against its plain version, bit for bit, on every
    FRState field and the bidder-row counts."""
    cases = []
    worst = 0.0
    gen = torch.Generator(device="cuda")
    for b, n, lo, hi, mode, rounds in [
        (64, 256, lo, hi, mode, r)
        for lo, hi in ((1, 1000), (1, 8))
        for mode in ("f32", "int")
        for r in (1, 7, 40)
    ] + [(16, 384, 1, 1000, "int", 40), (8, 1024, 1, 1000, "f32", 40)]:
        gen.manual_seed(SEED + n + hi + rounds)
        costs = torch.randint(lo, hi, (b, n, n), generator=gen,
                              device="cuda", dtype=torch.int32).float()
        if mode == "int":
            vt, work = lattice_values(costs)
            eps = 1
        else:
            work = (-costs).contiguous()
            vt = work.transpose(1, 2).contiguous()
            eps = 1.0 / n
        s0 = fr_init(vt, eps)
        rows_k = torch.zeros(b, dtype=torch.int64, device="cuda")
        rows_p = torch.zeros(b, dtype=torch.int64, device="cuda")
        got, _ = fr_kernel.fr_chunk(vt, s0, rounds, values=work,
                                    bid_rows=rows_k)
        torch.cuda.synchronize()
        want, _ = fr_kernel.fr_chunk_reference(vt, s0, rounds,
                                               bid_rows=rows_p)
        bad, err = states_equal(got, want)
        if not torch.equal(rows_k, rows_p):
            bad.append("bid_rows")
        assigned = int((got.p2o != fr_kernel.UNASSIGNED).sum())
        assert not bad, (b, n, lo, hi, mode, rounds, bad)
        assert assigned > 0
        worst = max(worst, err)
        cases.append([b, n, hi, mode, rounds])
    emit({"phase": "kernel_vs_plain", "kernel": "fr_kernel",
          "cases": len(cases), "tolerance": 0, "max_abs_err": worst,
          "fields": "all FRState fields + bid_rows, bit-exact"})
    return worst


def certify_lattice(work, states, eps=1):
    """Dual certificate on the int32 lattice, in int64, per chunk of
    instances: pi_i + p_j >= a_ij - eps everywhere, with equality on the
    assigned pairs."""
    b = work.shape[0]
    for c0 in range(0, b, 256):
        w = work[c0:c0 + 256].long()                       # [b, N, M]
        pi = states.profits[c0:c0 + 256].long()[:, :, None]
        p = states.prices[c0:c0 + 256].long()[:, None, :]
        slack = pi + p - w
        assert bool((slack >= -eps).all()), "eps-CS violated"
        p2o = states.p2o[c0:c0 + 256].long()
        tight = slack.gather(2, p2o[:, :, None])
        assert bool((tight == 0).all()), "assigned pair not tight"


def kernel_split(phases, cyc, stamps, nits):
    """A one-CTA-per-instance kernel's phase counters (``phases``, ending
    in ``total`` and ``rounds``) as shares of its CTAs' round cycles, and
    its timeline from the CTAs' global-timer stamps: when the last CTA
    started (the waves), when half and all had ended, and the instance
    with the most rounds (the straggler); and a least-squares line of a
    CTA's time against its rounds (``per_round_us``, what one more round
    costs, and ``fixed_us``)."""
    c = dict(zip(phases, cyc.tolist()))
    st = stamps.cpu().numpy().astype(np.float64)
    t0 = st[:, 0].min()
    start = (st[:, 0] - t0) / 1e6
    end = (st[:, 1] - t0) / 1e6
    n = nits.cpu().numpy()
    k = int(n.argmax())
    per_round, fixed = np.polyfit(n.astype(np.float64), (end - start) * 1e3,
                                  1)
    return {
        "cycle_share": {p: c[p] / c["total"] for p in phases
                        if p not in ("total", "rounds")},
        "cycles": c, "cycles_per_round": c["total"] / c["rounds"],
        "timeline_ms": {"span": float(end.max()),
                        "last_start": float(start.max()),
                        "half_ended": float(np.median(end)),
                        "straggler": {"nits": int(n[k]),
                                      "start": float(start[k]),
                                      "end": float(end[k])}},
        "us_per_round_median": float(np.median(
            (end - start) * 1e3 / np.maximum(n, 1))),
        "cta_time_fit": {"per_round_us": float(per_round),
                         "fixed_us": float(fixed)},
    }


#: the staging kernel's shapes: the north star's batch on the int32
#: lattice (scale 257) and one big single in float32, both minimising
STAGE_SHAPES = (("b4096_n256", (4096, 256, 256), 257),
                ("b1_n4096", (1, 4096, 4096), None))


def phase_stage_kernel_time(stage_mod):
    """The staging kernel at the main path's shapes: bit-equal to its
    plain version, one launch a call, its device time (one call behind a
    queued wait, median of 9) beside the plain chain's and the bound
    (each cost read once, both layouts and the maxima written once, at
    the card's bandwidth)."""
    out = {}
    gen = torch.Generator(device="cuda")
    for name, shape, scale in STAGE_SHAPES:
        gen.manual_seed(SEED + shape[1])
        x = torch.randint(1, 1000, shape, generator=gen, device="cuda",
                          dtype=torch.int32).float()
        before = stage_mod.LAUNCHES
        got = stage_mod.stage(x, True, scale)
        torch.cuda.synchronize()
        assert stage_mod.LAUNCHES == before + 1
        want = stage_mod.stage_reference(x, True, scale)
        bad = [k for k, g, w in zip(("values_t", "work", "profits"), got,
                                    want)
               if g.dtype != w.dtype or not torch.equal(g, w)]
        assert not bad, (name, bad)
        nbytes = (x.numel() * x.element_size()
                  + sum(t.numel() * t.element_size() for t in got))
        del got, want
        ms = queued_ms(lambda: stage_mod.stage(x, True, scale), reps=9)
        plain_ms = queued_ms(
            lambda: stage_mod.stage_reference(x, True, scale), reps=9)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {"shape": list(shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bytes": nbytes,
                     "share_of_bound": bound_ms / ms,
                     "rows": stage_mod.strip_rows(
                         shape[0], shape[1], torch.cuda.get_device_properties(
                             0).multi_processor_count)}
        del x
    emit({"phase": "stage_kernel_time", **out, "bound_by": "bytes",
          "plain_bit_exact": True})
    return out


def lone_trace(fr_big, vt, work, eps, fr_init):
    """The kernel's round log of one solve from ``fr_init`` to done, and
    where its lone tail lies: the rounds run before the first round that
    starts with one person unmatched, the rounds run up to the first
    lone round that flips the mode to reverse, and the count of rounds
    that start at cardinality S - 1 (the rounds the tail should run)."""
    n = vt.shape[1]
    s0 = fr_init(vt, eps)
    rows = traced_rows(1, 100_000, 4)
    got, done = fr_big.fr_big_chunk(vt, s0, 100_000, values=work,
                                    trace_rows=rows)
    assert bool(done)
    nits = int(got.nits[0])
    card = rows[0, :nits, 2].tolist()
    mode = rows[0, :nits, 1].tolist()
    before = [0] + card[:-1]  # the cardinality each round starts at
    first = before.index(n - 1)
    flip = next((r + 1 for r in range(first, nits)
                 if mode[r] == 0 and (mode[r - 1] if r else 1) == 1), None)
    return {"nits": nits, "first_lone": first, "first_reverse": flip,
            "lone_rounds": sum(c == n - 1 for c in before)}


def phase_big_kernel_vs_plain(batch, fr_big, fr_init):
    """The cluster kernel against its plain version, bit for bit, on
    every FRState field and the bidder-row counts: on 2048² (costs in
    [1, 1000) and in [1, 8)) and 1152² after 7, 40 and 400 rounds and at
    done; on 2048² with every cost equal (the sliced merge's worst ties)
    after 7, 40 and 400 rounds, then on to done on the kernel alone
    (34,770 rounds, too many for the plain version in the time limit) and
    its price certificate; on the 4096² instance of the big-single phase
    after 1, 2 and 3 rounds (the wide opening) and at done.  On 2048²
    (costs in [1, 1000)) and 4096² a launch also stops inside the lone
    tail: right before its first round (the next launch starts in the
    tail), 1 and 37 rounds after it, and right after its first flip to
    reverse mode; there the kernel runs each chunk a second time with
    its round log, whose state must equal the first and whose rows must
    equal the plain version's.  Returns the 4096² plain run: its time,
    final state and bidder rows, and its lone tail (``lone_trace``)."""
    from sparse_linear_assignment_tpu_torch.solution import UNASSIGNED

    gen = torch.Generator(device="cuda")
    cases = []

    def run(vt, work, eps, stops, what, to_done=True, traced=False):
        got = want = fr_init(vt, eps)
        rows_k = torch.zeros(1, dtype=torch.int64, device="cuda")
        rows_p = torch.zeros(1, dtype=torch.int64, device="cuda")
        total, plain_ms = 0, 0.0
        chunks = [b - a for a, b in zip([0] + stops, stops)]
        for chunk in chunks + ([100_000] if to_done else []):
            prev = got
            got, _ = fr_big.fr_big_chunk(vt, prev, chunk, values=work,
                                         bid_rows=rows_k)
            rk = rp = None
            if traced:
                rk, rp = traced_rows(1, chunk, 4), traced_rows(1, chunk, 4)
                logged, _ = fr_big.fr_big_chunk(vt, prev, chunk, values=work,
                                                trace_rows=rk)
                bad, _ = states_equal(logged, got)
                assert not bad, (what, total + chunk, "log on/off", bad)
            ms, (want, _) = sync_ms(lambda: fr_big.fr_big_chunk_reference(
                vt, want, chunk, bid_rows=rows_p, trace_rows=rp))
            plain_ms += ms
            total += chunk
            bad, _ = states_equal(got, want)
            if not torch.equal(rows_k, rows_p):
                bad.append("bid_rows")
            if traced and not torch.equal(rk, rp):
                bad.append("round log")
            assert not bad, (what, total, bad)
            if bool(got.done[0]):
                break
        compared = int(got.nits[0])
        if not to_done:
            got, _ = fr_big.fr_big_chunk(vt, got, 100_000, values=work,
                                         bid_rows=rows_k)
            certify_prices(work, got, eps, 1e-3)
        assert bool(got.done[0]), (what, "not done", total)
        assert int((got.p2o == UNASSIGNED).sum()) == 0, what
        cases.append({"case": what, "n": vt.shape[1],
                      "nits": int(got.nits[0]), "compared_nits": compared,
                      "stops": stops, "bid_rows": int(rows_k[0])})
        return {"plain_ms": plain_ms, "state": want,
                "bid_rows": int(rows_p[0])}

    def lone_stops(lone):
        first = lone["first_lone"]
        assert first + 37 < lone["nits"], lone
        stops = [first, first + 1, first + 37, lone["first_reverse"]]
        return [r for r in stops if r is not None]

    tails = {}
    for n, hi in ((2048, 1000), (2048, 8), (2048, 2), (1152, 1000)):
        gen.manual_seed(SEED + n + hi)
        costs = torch.randint(1, hi, (1, n, n), generator=gen,
                              device="cuda", dtype=torch.int32).float()
        work = (-costs).contiguous()
        vt = work.transpose(1, 2).contiguous()
        eps = 1.0 / (n + 1)
        if hi == 2:
            run(vt, work, eps, [7, 40, 400], "all costs equal",
                to_done=False)
        elif (n, hi) == (2048, 1000):
            lone = tails[n] = lone_trace(fr_big, vt, work, eps, fr_init)
            run(vt, work, eps, sorted({7, 40, 400, *lone_stops(lone)}),
                f"costs in [1, {hi})", traced=True)
        else:
            run(vt, work, eps, [7, 40, 400], f"costs in [1, {hi})")
        del costs, work, vt
    n = 4096
    rng = np.random.default_rng(SEED)
    dev = torch.from_numpy(
        rng.integers(1, 1000, size=(1, n, n)).astype(np.float32)).cuda()
    vt, work, _ = batch._stage(dev, True, None)
    lone = tails[n] = lone_trace(fr_big, vt, work, 1.0 / (n + 1), fr_init)
    plain = run(vt, work, 1.0 / (n + 1), sorted({1, 2, 3, *lone_stops(lone)}),
                "the big-single 4096² instance", traced=True)
    emit({"phase": "big_kernel_vs_plain", "kernel": "fr_big_kernel",
          "checkpoints": "after 7, 40, 400 rounds and at done (all "
                         "costs equal: a price certificate at done); "
                         "4096²: after 1, 2, 3 rounds and at done; "
                         "2048² [1, 1000) and 4096²: also before the "
                         "first lone round, 1 and 37 after it and after "
                         "its first flip to reverse, with the round log",
          "cases": cases, "lone_tails": tails, "tolerance": 0,
          "max_abs_err": 0.0,
          "fields": "all FRState fields + bid_rows (+ round log rows "
                    "where traced), bit-exact"})
    return {**plain, "lone": lone}


def certify_prices(work, st, eps, slack):
    """Float64 price certificate of a full matching: every person's
    chosen profit is at least its row's max profit minus eps, up to
    ``slack`` (the f32 path's rounding).  Returns the worst shortfall
    beyond eps."""
    n = work.shape[1]
    p = st.prices[0].double()
    p2o = st.p2o[0].long()
    worst = -float("inf")
    for r0 in range(0, n, 512):
        prof = work[0, r0:r0 + 512].double() - p[None, :]
        chosen = prof.gather(1, p2o[r0:r0 + 512, None])[:, 0]
        worst = max(worst, float((prof.amax(dim=1) - eps - chosen).max()))
    assert worst <= slack, ("price certificate", worst)
    return worst


def phase_big_single(port, batch, fr_big, fr_kernel, fr_init, scipy_lsa):
    """Big dense singles through ``solve_batch``: 4096² with host and
    device costs as the JAX bench drives it (scipy's objective), then
    8192² made on the card (price certificate).  Returns what the
    later phases reuse."""
    n = 4096
    rng = np.random.default_rng(SEED)
    costs = rng.integers(1, 1000, size=(1, n, n)).astype(np.float64)
    dev = torch.from_numpy(costs.astype(np.float32)).cuda()
    eps = 1.0 / (n + 1)

    def solve():
        return port.solve_batch(costs, costs_device=dev, eps=eps,
                                dtype=np.float32)

    fr_big.LAUNCHES = 0
    fused_before = fr_kernel.LAUNCHES
    first_ms, sol = sync_ms(solve)
    launches = fr_big.LAUNCHES
    assert launches > 0, "the big-single path launched no fr_big kernel"
    assert fr_kernel.LAUNCHES == fused_before, "fr_kernel ran on a big single"
    warm_ms, sol2 = sync_ms(solve, reps=3)
    assert np.array_equal(sol.person_to_object, sol2.person_to_object)
    assert int(sol.num_unassigned[0]) == 0, "unassigned persons at 4096²"
    t0 = time.perf_counter()
    r, c = scipy_lsa(costs[0])
    scipy_s = time.perf_counter() - t0
    assert sol.objective[0] == costs[0][r, c].sum(), "4096² objective"
    nits = int(sol.nits[0])
    emit({"phase": "big_single", "n": n, "costs": "integers in [1, 1000), "
          "host f64 + device f32", "eps": eps, "first_call_ms": first_ms,
          "warm_median_ms": warm_ms, "nits": nits,
          "rounds_per_s": nits / (warm_ms / 1e3),
          "fr_big_launches": launches, "fr_kernel_launches": 0,
          "objective": float(sol.objective[0]), "scipy_equal": True,
          "scipy_s": scipy_s})

    n8 = 8192
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + n8)
    c8 = torch.randint(1, 1000, (1, n8, n8), generator=gen, device="cuda",
                       dtype=torch.int32).float()
    eps8 = 1.0 / (n8 + 1)
    wall8, sol8 = sync_ms(lambda: port.solve_batch(
        None, costs_device=c8, eps=eps8, dtype=np.float32))
    assert int(sol8.num_unassigned[0]) == 0, "unassigned persons at 8192²"
    # the same deterministic solve through the kernel in one launch, for
    # its prices, its time and its phase counters
    vt8, work8, _ = batch._stage(c8, True, None)
    s8 = fr_init(vt8, eps8)
    cyc8 = torch.zeros(len(fr_big.PHASES), dtype=torch.int64, device="cuda")
    st, done8 = fr_big.fr_big_chunk(vt8, s8, 100_000, values=work8,
                                    phase_cycles=cyc8)
    assert bool(done8)
    assert np.array_equal(st.p2o.cpu().numpy(), sol8.person_to_object)
    slack = 1e-3
    worst = certify_prices(work8, st, eps8, slack)
    nits8 = int(st.nits[0])
    ms8 = event_ms(lambda: fr_big.fr_big_chunk(vt8, s8, 100_000,
                                               values=work8), reps=3)
    lone8 = lone_trace(fr_big, vt8, work8, eps8, fr_init)
    k8 = {"n": n8, "nits": nits8, "ms": ms8, "lone": lone8,
          "us_per_round": ms8 * 1e3 / nits8, **cycle_split(fr_big, cyc8)}
    emit({"phase": "big_single_8192", "n": n8,
          "costs": "integers in [1, 1000) made on the card",
          "eps": eps8, "wall_ms": wall8, "nits": int(sol8.nits[0]),
          "rounds_per_s": int(sol8.nits[0]) / (wall8 / 1e3),
          "objective": float(sol8.objective[0]),
          "certificate": "f64 chosen profit >= row max - eps - slack",
          "slack": slack, "worst_shortfall": worst, "kernel_ms": ms8,
          "kernel_us_per_round": k8["us_per_round"]})
    del c8, vt8, work8, st, s8
    return dev, eps, launches, k8


def cycle_split(fr_big, cyc):
    """The kernel's phase counters as shares of the leader thread's round
    cycles (the lone tail's apart from the five phases), the wide rounds
    and the lone rounds."""
    c = dict(zip(fr_big.PHASES, cyc.tolist()))
    total = c["total"]
    return {
        "cycle_share": {k: c[k] / total for k in (
            "rows", "merge_bid", "apply", "control", "barrier_wait")},
        "cycles": c,
        "wide_rounds": c["wide_rounds"],
        "wide_share": c["wide_cycles"] / total,
        "lone_rounds": c["lone_rounds"],
        "lone_share": c["lone_cycles"] / total,
    }


def phase_big_batch(port, scipy_lsa):
    """A batch of big singles: the route stages one instance at a time,
    so the solve's device memory beyond the costs stays within two
    staged copies of one instance (negated values and their transpose),
    whatever the batch."""
    b, n = 3, 2048
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + b * n)
    costs = torch.randint(1, 1000, (b, n, n), generator=gen, device="cuda",
                          dtype=torch.int32).float()
    eps = 1.0 / (n + 1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    wall_ms, sol = sync_ms(lambda: port.solve_batch(
        None, costs_device=costs, eps=eps, dtype=np.float32))
    extra = torch.cuda.max_memory_allocated() - base
    instance = n * n * costs.element_size()
    limit = 2 * instance + (8 << 20)
    assert extra <= limit, ("big batch staging", extra, limit)
    assert int(sol.num_unassigned.max()) == 0, "unassigned persons"
    host = costs.cpu().numpy().astype(np.float64)
    for i in range(b):
        r, c = scipy_lsa(host[i])
        assert sol.objective[i] == host[i][r, c].sum(), i
    emit({"phase": "big_batch", "batch": b, "n": n, "wall_ms": wall_ms,
          "nits": sol.nits.tolist(), "peak_extra_bytes": extra,
          "instance_bytes": instance, "limit_bytes": limit,
          "scipy_equal": b})


def phase_big_kernel_time(batch, fr_big, fr_init, dev, eps, plain, k8):
    """The 4096² solve's kernel alone: CUDA-event time of one launch
    from the initial state to done, bit-equal to the plain version's run
    of ``phase_big_kernel_vs_plain`` (whose time it reports), the bound,
    the phase counters, and a latency floor from the probe's measured
    cluster barrier and dependent HBM load.  ``k8`` holds the same
    figures of the 8192² launch."""
    n = dev.shape[1]
    vt, work, _ = batch._stage(dev, True, None)
    s0 = fr_init(vt, eps)
    budget = 100_000
    rows = torch.zeros(1, dtype=torch.int64, device="cuda")
    cyc = torch.zeros(len(fr_big.PHASES), dtype=torch.int64, device="cuda")
    got, done = fr_big.fr_big_chunk(vt, s0, budget, values=work,
                                    bid_rows=rows, phase_cycles=cyc)
    assert bool(done)
    nits, bid_rows = int(got.nits[0]), int(rows[0])
    kernel_ms = event_ms(
        lambda: fr_big.fr_big_chunk(vt, s0, budget, values=work), reps=5)
    bad, err = states_equal(got, plain["state"])
    assert not bad and bid_rows == plain["bid_rows"], ("big 4096²", bad)
    pl = fr_big.plan(n)
    # a cluster barrier of the kernel's shape and a dependent load that
    # misses L2 (a 1 GiB chain, 16 MB strides)
    links = 1 << 28
    chain = torch.remainder(
        torch.arange(links, dtype=torch.int32, device="cuda") + 4_194_319,
        links).to(torch.int32)
    pr = fr_big.probe(chain, 2000, pl.cluster)
    del chain
    assert pr["dsmem_cas_max64_atomic"], pr
    barrier_ns, load_ns = pr["cluster_barrier_ns"], pr["hbm_load_ns"]
    split = cycle_split(fr_big, cyc)
    figures = {}
    for size, ms, rounds, sp, lone in (
            (n, kernel_ms, nits, split, plain["lone"]),
            (k8["n"], k8["ms"], k8["nits"], k8, k8["lone"])):
        barriers = sp["cycles"]["barriers"]
        per_round = barriers / rounds
        floor_ms = rounds * (barrier_ns * per_round + load_ns) / 1e6
        nlone = sp["lone_rounds"]
        # the tail runs every round that starts with one person unmatched
        assert nlone == lone["lone_rounds"], (size, nlone, lone)
        figures[str(size)] = {
            "ms": ms, "nits": rounds, "us_per_round": ms * 1e3 / rounds,
            "lone_rounds": nlone, "lone_cycles": sp["cycles"]["lone_cycles"],
            "lone_share_of_time": sp["lone_share"],
            "us_per_lone_round": ms * 1e3 * sp["lone_share"] / max(nlone, 1),
            "us_per_other_round": ms * 1e3 * (1 - sp["lone_share"])
            / max(rounds - nlone, 1),
            "barriers_per_launch": barriers,
            "barriers_per_round": per_round,
            "latency_floor_ms": floor_ms,
            "us_per_round_by_phase": {
                k: v * ms * 1e3 / rounds
                for k, v in sp["cycle_share"].items()},
            "cycle_share": sp["cycle_share"],
            "wide_rounds": sp["wide_rounds"],
            "wide_share_of_time": sp["wide_share"]}
    elem = vt.element_size()
    state_bytes = 2 * 4 * n * 4              # prices, profits, p2o, o2p
    bytes_once = n * n * elem + state_bytes  # one layout + the state
    ops = 2 * n * bid_rows                   # a subtract and a max each
    bound_bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    row_bytes = bid_rows * n * elem
    plain_ms = plain["plain_ms"]
    emit({"phase": "big_kernel_time", "n": n, "dtype": "float32",
          "cluster": pl.cluster, "plan": pl._asdict(),
          "nits": nits, "ms": kernel_ms, "us_per_round": kernel_ms * 1e3 /
          nits, "plain_ms": plain_ms, "plain_rounds": nits,
          "plain_ms_per_round": plain_ms / nits, "bound_ms": bound_ms,
          "bound_by": bound_by, "bytes_once": bytes_once,
          "bid_rows": bid_rows, "bidder_row_bytes": row_bytes,
          "bidder_row_bound_ms": row_bytes / HBM_BYTES_PER_S * 1e3,
          **pr,
          "latency_floor": "rounds x (cluster barrier x barriers a round "
                           "+ one dependent HBM load)",
          "by_size": figures, "library_ms": None, "plain_bit_exact": True})
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "cluster": pl.cluster,
            "us_per_round": kernel_ms * 1e3 / nits,
            "latency_floor_ms": figures[str(n)]["latency_floor_ms"],
            "ms_8192": k8["ms"],
            "us_per_round_8192": k8["us_per_round"]}


def phase_native_tail(port, batch, scipy_lsa):
    """The host-costs branch's native straggler tail: a 20-round first
    chunk leaves the instances undone, the native engine finishes them
    on the card's host."""
    b, n = 64, 256
    rng = np.random.default_rng(SEED + 1)
    costs = rng.integers(1, 1000, size=(b, n, n)).astype(np.float64)
    saved = batch._fr_fused_schedule
    batch._fr_fused_schedule = lambda b_, n_, m_: 20
    try:
        wall_ms, sol = sync_ms(lambda: port.solve_batch(costs))
    finally:
        batch._fr_fused_schedule = saved
    tail = batch.LAST_TAIL_COUNT
    assert 0 < tail <= b, tail
    assert int((sol.nits == 20).sum()) >= tail
    assert int(sol.num_unassigned.max()) == 0
    for i in range(b):
        r, c = scipy_lsa(costs[i])
        assert sol.objective[i] == costs[i][r, c].sum(), i
    emit({"phase": "native_tail", "batch": b, "n": n,
          "first_chunk_rounds": 20, "tail_instances": tail,
          "wall_ms": wall_ms, "scipy_equal": b,
          "host_cpus": os.cpu_count()})


# ----------------------------------------------------------------------
# batched sparse mode (the Khosla kernel)
# ----------------------------------------------------------------------
KSP_FIELDS = ("prices", "p2o", "o2p", "dropped", "nits")


def device_arcs(gen, b, n, m, k, lo, hi):
    """k distinct columns per person and integer values in [lo, hi) as
    float32, made on the card from a seeded generator."""
    scores = torch.rand((b, n, m), generator=gen, device="cuda")
    cols = scores.topk(k, dim=2).indices.to(torch.int32)
    vals = torch.randint(lo, hi, (b, n, k), generator=gen, device="cuda",
                         dtype=torch.int32).float()
    return cols, vals


def sparse_scipy_objective(scipy_lsa, cols, vals, m):
    """scipy's optimum of one k-sparse instance on the 1e9-filled dense
    matrix (integer values: exact)."""
    n = cols.shape[0]
    full = np.full((n, m), 1e9)
    for i in range(n):
        real = cols[i] >= 0
        full[i, cols[i][real]] = vals[i][real]
    r, c = scipy_lsa(full)
    return full[r, c].sum()


def ksp_states_equal(a, b):
    return [k for k in KSP_FIELDS
            if not torch.equal(getattr(a, k), getattr(b, k))]


def ksp_active(s):
    return (s.p2o == 2**31 - 1) & ~s.dropped


def phase_ksp_kernel_vs_plain(port, batch, ksp):
    """The Khosla kernel against its plain version, bit for bit, on
    every KhoslaState field and the active-row counts, after 1, 2 and 5
    rounds and at done.  Every launch after the first enters with
    assigned persons and the stale ``o2p`` the kernel passes through, so
    the kernel rebuilds its owner map from ``p2o``; the mid-solve case
    enters the first launch that way too, with ``o2p`` filled with
    noise."""
    gen = torch.Generator(device="cuda")
    planes = []

    def staged_on_card(name, b, n, m, k, lo, hi, eps, infeasible=0,
                       mid_solve=0):
        gen.manual_seed(SEED + b + n + m + hi)
        cols, vals = device_arcs(gen, b, n, m, k, lo, hi)
        if infeasible:
            # every person of these instances has one arc, to object 0
            cols[:infeasible] = -1
            cols[:infeasible, :, 0] = 0
        st = port.stage_batch_sparse_device(cols, vals, m, eps=eps)
        eps32 = np.float32(st.eps_val)
        start = ksp.khosla_init(st.values_nm)
        if mid_solve:
            # the plain version's state after `mid_solve` rounds
            start = ksp.ksp_chunk_reference(st.values_nm, start, eps32,
                                            st.thresholds, mid_solve)
            start = start._replace(o2p=torch.randint(
                -1, n, start.o2p.shape, generator=gen, device="cuda",
                dtype=torch.int32))
            assert bool((start.p2o != 2**31 - 1).any()), name
            assert bool(ksp_active(start).any()), name
        planes.append((name, st.values_nm, st.thresholds, eps32,
                       infeasible, start))

    staged_on_card("256x(128x512,k=8)", 256, 128, 512, 8, 300, 1000,
                   1.0 / 512)
    staged_on_card("64x(256x2048,k=8)", 64, 256, 2048, 8, 300, 1000,
                   1.0 / 2048)
    staged_on_card("tie-heavy [1,4) 256x(128x512,k=8)", 256, 128, 512, 8,
                   1, 4, 1.0 / 512)
    staged_on_card("8 infeasible of 64x(32x128,k=4)", 64, 32, 128, 4, 1, 5,
                   0.5, infeasible=8)
    # N == M': every round displaces owners
    staged_on_card("square 64x(128x128,k=16)", 64, 128, 128, 16, 1, 100,
                   0.125)
    # the narrowest plane: one warp's width
    staged_on_card("narrowest 256x(24x32,k=6)", 256, 24, 32, 6, 300, 1000,
                   1.0 / 32)
    staged_on_card("mid-solve from 2 plain rounds, noisy o2p, "
                   "64x(128x512,k=8)", 64, 128, 512, 8, 300, 1000,
                   1.0 / 512, mid_solve=2)
    # about the widest plane whose state fits a block: 148 groups of
    # 16-byte loads a row
    staged_on_card("widest tie-heavy [1,4) 2x(128x18944,k=8)", 2, 128,
                   18944, 8, 1, 4, 1.0 / 18944)
    # n not a multiple of 8, plane compacted on the host
    hc, hv = port.generators.gen_batch_ksparse(SEED, 32, 100, 700, 6)
    hst = port.stage_batch_sparse(hc, hv, 700)
    width = hst.values_nm.shape[2]
    assert width & (width - 1), ("expected a width off the powers of two",
                                 width)
    planes.append(("host-compacted 32x(100x700,k=6)", hst.values_nm,
                   hst.thresholds, np.float32(hst.eps_val), 0,
                   ksp.khosla_init(hst.values_nm)))

    cases = []
    for name, plane, thr, eps, infeasible, start in planes:
        b, n, mp = plane.shape
        got = want = start
        rows_k = torch.zeros(b, dtype=torch.int64, device="cuda")
        rows_p = torch.zeros(b, dtype=torch.int64, device="cuda")
        total = 0
        for chunk in [1, 1, 3] + [64] * 200:
            got = ksp.ksp_chunk(plane, got, eps, thr, chunk,
                                act_rows=rows_k)
            torch.cuda.synchronize()
            want = ksp.ksp_chunk_reference(plane, want, eps, thr, chunk,
                                           act_rows=rows_p)
            total += chunk
            bad = ksp_states_equal(got, want)
            if not torch.equal(rows_k, rows_p):
                bad.append("act_rows")
            assert not bad, (name, total, bad)
            if not bool(ksp_active(got).any()):
                break
        assert not bool(ksp_active(got).any()), (name, "not done", total)
        unassigned = (got.p2o == 2**31 - 1).sum(dim=1)
        assert unassigned[:infeasible].tolist() == [n - 1] * infeasible
        assert int(unassigned[infeasible:].max()) == 0, name
        # a state that enters done comes out unchanged
        again = ksp.ksp_chunk(plane, got, eps, thr, 64)
        assert not ksp_states_equal(again, got), (name, "done at entry")
        cases.append({"case": name, "plane": [b, n, mp],
                      "nits_max": int(got.nits.max()),
                      "dropped": int(got.dropped.sum()),
                      "act_rows": int(rows_k.sum())})
    emit({"phase": "ksp_kernel_vs_plain", "kernel": "ksp_kernel",
          "checkpoints": "after 1, 2, 5 rounds, then every 64 to done, "
                         "then once more from the done state",
          "entry": "each launch with the o2p it passed through; the "
                   "mid-solve case from the plain version's state with "
                   "o2p noise",
          "cases": cases, "tolerance": 0, "max_abs_err": 0.0,
          "fields": "prices, p2o, o2p, dropped, nits + act_rows, "
                    "bit-exact"})


def phase_sparse_stream(port, batch, ksp, scipy_lsa):
    """The sparse mode at full size: 5 batches of 4096 x (128 x 512, k = 8)
    made on the card, staged on the card, streamed with window 2."""
    b, n, m, k, nbatch = 4096, 128, 512, 8, 5
    gen = torch.Generator(device="cuda")
    raw = []
    for i in range(nbatch):
        gen.manual_seed(SEED + 100 + i)
        raw.append(device_arcs(gen, b, n, m, k, 300, 1000))
    stage_ms, staged = sync_ms(lambda: [
        port.stage_batch_sparse_device(c, v, m, eps=1.0 / m)
        for c, v in raw])

    ksp.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    first_ms, sols = sync_ms(
        lambda: port.solve_batch_sparse_stream(staged, window=2))
    launches = ksp.LAUNCHES
    assert launches > 0, "the sparse path launched no Khosla kernel"
    warm_ms, sols2 = sync_ms(
        lambda: port.solve_batch_sparse_stream(staged, window=2), reps=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    call_ms, one = sync_ms(
        lambda: batch._sparse_solve_staged(staged[0], 10_000_000, 16),
        reps=3)
    # the stream's yardsticks: the same batches one after another, and
    # the stream with one batch in flight
    seq_ms, _ = sync_ms(lambda: [
        batch._sparse_solve_staged(st, 10_000_000, 16) for st in staged],
        reps=3)
    window1_ms, _ = sync_ms(
        lambda: port.solve_batch_sparse_stream(staged, window=1), reps=3)
    assert len(sols) == nbatch
    for s, s2 in zip(sols, sols2):
        assert int(s.num_unassigned.sum()) == 0, "unassigned persons"
        assert np.array_equal(s.person_to_object, s2.person_to_object)
    for field in ("person_to_object", "object_to_person", "nits",
                  "objective", "num_unassigned"):
        assert np.array_equal(getattr(one, field), getattr(sols[0], field)), \
            ("per-call solve differs from the stream", field)
    checked = 0
    for bi_batch in (0, nbatch - 1):
        cols = raw[bi_batch][0].cpu().numpy()
        vals = raw[bi_batch][1].cpu().numpy().astype(np.float64)
        for bi in range(0, b, b // 4):
            want = sparse_scipy_objective(scipy_lsa, cols[bi], vals[bi], m)
            assert sols[bi_batch].objective[bi] == want, (bi_batch, bi)
            checked += 1
    nits = np.concatenate([s.nits for s in sols])
    emit({"phase": "sparse_stream", "batches": nbatch, "batch": b, "n": n,
          "m": m, "k": k, "values": "integers in [300, 1000) as float32, "
          "made on the card", "eps": 1.0 / m, "window": 2,
          "stage_ms": stage_ms, "first_call_ms": first_ms,
          "warm_median_ms": warm_ms,
          "instances_per_s_streamed": nbatch * b / (warm_ms / 1e3),
          "sequential_ms": seq_ms, "window1_ms": window1_ms,
          "per_call_ms": call_ms,
          "instances_per_s_per_call": b / (call_ms / 1e3),
          "nits_p50": float(np.median(nits)), "nits_max": int(nits.max()),
          "ksp_kernel_launches": launches, "scipy_checked": checked,
          "per_call_equals_stream": True, "peak_device_gib": peak_gib})
    return staged, launches


def phase_ksp_kernel_time(batch, ksp, staged):
    """The Khosla kernel at the main path's shape: CUDA-event time of one
    launch from the initial state, the plain version on the same input
    for the same rounds, and the bound; the leader thread's cycles a
    round by phase and the CTA timeline from a launch with the counters
    on (``counted_ms`` its time)."""
    st = staged[0]
    plane, thr = st.values_nm, st.thresholds
    eps = np.float32(st.eps_val)
    b, n, mp = plane.shape
    budget = batch._SPARSE_KERNEL_BUDGET
    s0 = ksp.khosla_init(plane)
    rows = torch.zeros(b, dtype=torch.int64, device="cuda")
    cyc = torch.zeros(len(ksp.PHASES), dtype=torch.int64, device="cuda")
    stamps = torch.zeros((b, 2), dtype=torch.int64, device="cuda")
    got = ksp.ksp_chunk(plane, s0, eps, thr, budget, act_rows=rows,
                        phase_cycles=cyc, stamps=stamps)
    assert not bool(ksp_active(got).any()), "not done within the budget"
    act_rows = int(rows.sum())
    kernel_ms = event_ms(
        lambda: ksp.ksp_chunk(plane, s0, eps, thr, budget), reps=5)
    counted_ms = event_ms(lambda: ksp.ksp_chunk(
        plane, s0, eps, thr, budget, phase_cycles=torch.zeros_like(cyc),
        stamps=torch.zeros_like(stamps)), reps=3)
    split = kernel_split(ksp.PHASES, cyc, stamps, got.nits)
    plain_ms, want = sync_ms(
        lambda: ksp.ksp_chunk_reference(plane, s0, eps, thr, budget))
    bad = ksp_states_equal(got, want)
    assert not bad, ("ksp kernel at the main path's shape", bad)
    err = float((got.prices.double() - want.prices.double()).abs().max())
    elem = plane.element_size()
    # prices, p2o, dropped and nits read and written; thresholds read
    state_bytes = 2 * (b * mp * 4 + b * n * 4 + b * n + b * 4) + b * 4
    bytes_once = plane.numel() * elem + state_bytes
    ops = 2 * mp * act_rows                  # a subtract and a max each
    bound_bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    row_bytes = act_rows * mp * elem
    nits_max = int(got.nits.max())
    emit({"phase": "ksp_kernel_time", "shape": [b, n, mp],
          "dtype": "float32", "rounds_budget": budget,
          "nits_p50": float(got.nits.float().median()),
          "nits_max": nits_max, "ms": kernel_ms, "plain_ms": plain_ms,
          "plain_rounds": nits_max, "bound_ms": bound_ms,
          "bound_by": bound_by, "bytes_once": bytes_once,
          "bound_ops_ms": bound_ops_ms, "act_rows": act_rows,
          "active_row_bytes": row_bytes,
          "active_row_bound_ms": row_bytes / HBM_BYTES_PER_S * 1e3,
          "counted_ms": counted_ms, **split,
          "library_ms": None, "plain_bit_exact": True})
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def phase_sparse_host(port, batch, ksp, scipy_lsa):
    """The host-staged path: ``solve_batch_sparse(engine="dense")`` from
    host arrays, the compacted plane and the ``used_cols`` map back to
    original object ids."""
    b, n, m, k = 1024, 256, 2048, 8
    t0 = time.perf_counter()
    cols, vals = port.generators.gen_batch_ksparse(SEED, b, n, m, k)
    gen_s = time.perf_counter() - t0
    before = ksp.LAUNCHES
    wall_ms, sol = sync_ms(lambda: port.solve_batch_sparse(
        cols, vals, m, engine="dense"))
    assert ksp.LAUNCHES > before
    assert int(sol.num_unassigned.sum()) == 0, "unassigned persons"
    for bi in range(0, b, b // 4):
        want = sparse_scipy_objective(scipy_lsa, cols[bi], vals[bi], m)
        assert sol.objective[bi] == want, bi
        for i, j in enumerate(sol.person_to_object[bi]):
            assert j in cols[bi, i] and sol.object_to_person[bi, j] == i
    width = batch._plane_width(int(np.max([
        np.unique(cols[bi]).size for bi in range(b)])))
    emit({"phase": "sparse_host", "batch": b, "n": n, "m": m, "k": k,
          "generate_s": gen_s, "wall_ms": wall_ms, "plane_width": width,
          "nits_p50": float(np.median(sol.nits)),
          "nits_max": int(sol.nits.max()), "scipy_equal": 4,
          "note": "wall_ms holds the host densify and the copy of the "
                  "plane to the card"})


def phase_sparse_infeasible(port):
    """A small batch with infeasible instances ends through the drop
    rule, with the expected ``num_unassigned``."""
    b, n, m, k, bad = 16, 32, 128, 4, (3, 7, 12)
    cols, vals = port.generators.gen_batch_ksparse(SEED + 1, b, n, m, k,
                                                   min_value=1.0,
                                                   range_width=4.0)
    for bi in bad:  # every person's only arc is object 5
        cols[bi] = -1
        cols[bi, :, 0] = 5
    wall_ms, sol = sync_ms(lambda: port.solve_batch_sparse(
        cols, vals, m, eps=0.5, engine="dense"))
    want = np.zeros(b, dtype=np.int32)
    want[list(bad)] = n - 1
    assert np.array_equal(sol.num_unassigned, want), sol.num_unassigned
    owners = [int(np.nonzero(sol.person_to_object[bi] == 5)[0][0])
              for bi in bad]
    emit({"phase": "sparse_infeasible", "batch": b, "n": n, "m": m,
          "infeasible": list(bad), "num_unassigned": want.tolist(),
          "owners_of_the_shared_object": owners,
          "nits_max": int(sol.nits.max()), "wall_ms": wall_ms})


# ----------------------------------------------------------------------
# the arc Khosla kernel (csrc/ksp_arcs_kernel.cu) and its route
# ----------------------------------------------------------------------
ARCS_FIELDS = ("prices", "p2o", "dropped", "nits")
#: the reference crate's ε for config B: n·ε = 0.033 < 1, exact optimum
CRATE_EPS = 1 / 60_000
#: a coarser ε that float32 keeps at the crate's values (its spacing at
#: 2,000 is 2^-13) and that still gives the exact optimum (n·ε < 1)
CRATE_EPS_F32 = 2.0 ** -12


def arcs_states_differ(a, b):
    return [k for k in ARCS_FIELDS
            if not torch.equal(getattr(a, k), getattr(b, k))]


def arcs_small_case(seed, b, n, m, k, hi):
    """Arcs on the card with a repeated column, single-arc persons and
    unsorted slots; instance 2 infeasible (every person's only arc is
    object 0, threshold 0.5: it drops)."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.stack([rng.choice(m, size=k, replace=False)
                               for _ in range(n)])
                     for _ in range(b)]).astype(np.int32)
    vals = -rng.integers(1, hi, size=(b, n, k)).astype(np.float64)
    cols[0, 1, 1] = cols[0, 1, 0]
    cols[0, 2, 1:] = -1
    cols[2] = 0
    cols[2, :, 1:] = -1
    cols[3, :, 2] = cols[3, :, k - 1]
    thr = np.full(b, (m / 2.0) * (hi + 1.0 / m))
    thr[2] = 0.5
    return (torch.from_numpy(cols).cuda(), torch.from_numpy(vals).cuda(),
            torch.from_numpy(thr).cuda())


def densify_arcs(cols, vals, m):
    """The plane of the arcs, a repeated column's later slot kept (the
    staging's scatter, one slot at a time)."""
    b, n, k = cols.shape
    plane = torch.full((b, n, m), -float("inf"), dtype=vals.dtype,
                       device=cols.device)
    for j in range(k):
        c = cols[:, :, j:j + 1]
        cj = c.clamp(min=0).long()
        plane.scatter_(2, cj, torch.where(c >= 0, vals[:, :, j:j + 1],
                                          plane.gather(2, cj)))
    return plane


def crate_arcs(gen, b):
    """A batch of the reference crate's config B on the card
    (``benches/benchmark.rs:159-249``): 32 distinct uniform columns of
    60,000 a person (a row with a repeat is drawn again), values
    floor(700·Beta(3,3) + 300), Beta(3,3) the median of five uniforms;
    float32 values, columns unsorted."""
    n, m, k = CONFIG_B
    cols = torch.randint(0, m, (b * n, k), generator=gen, device="cuda",
                         dtype=torch.int32)
    while True:
        s = cols.sort(dim=1).values
        again = (s[:, 1:] == s[:, :-1]).any(dim=1).nonzero()[:, 0]
        if again.numel() == 0:
            break
        cols[again] = torch.randint(0, m, (again.numel(), k), generator=gen,
                                    device="cuda", dtype=torch.int32)
    vals = torch.cat([torch.floor(700.0 * torch.rand(
        (min(64, b - lo), n, k, 5), generator=gen, device="cuda",
        dtype=torch.float64).median(dim=-1).values + 300.0)
        for lo in range(0, b, 64)]).float()
    return cols.view(b, n, k), vals


def arcs_scipy_objective(cols, vals, m):
    """``min_weight_full_bipartite_matching``'s optimum of one instance's
    arcs (integer values: exact)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    n, k = cols.shape
    mat = csr_matrix((vals.reshape(-1).astype(np.float64),
                      cols.reshape(-1).astype(np.int64),
                      np.arange(0, n * k + 1, k)), shape=(n, m))
    rows, picked = min_weight_full_bipartite_matching(mat)
    return float(np.asarray(mat[rows, picked]).sum())


def check_crate_solutions(sols, raw, m, per_batch=4):
    """Every person assigned, the maps consistent, and ``per_batch``
    instances of each batch at scipy's optimum."""
    checked = 0
    for sol, (cols, vals) in zip(sols, raw):
        assert int(sol.num_unassigned.sum()) == 0, "unassigned persons"
        p2o = sol.person_to_object
        b, n = p2o.shape
        back = np.take_along_axis(sol.object_to_person,
                                  p2o.astype(np.int64), axis=1)
        assert np.array_equal(back, np.broadcast_to(np.arange(n), p2o.shape))
        c, v = cols.cpu().numpy(), vals.cpu().numpy()
        for bi in range(0, b, b // per_batch):
            assert sol.objective[bi] == arcs_scipy_objective(c[bi], v[bi], m)
            checked += 1
    return checked


def phase_ksp_arcs(port, batch, ka, ksp):
    """The arc Khosla kernel bit-equal to its plain version, and to the
    plane kernel where both run; its route at the reference crate's
    config B (2 x 256 x (2,000 x 60,000, 32 arcs), ε = 1/60,000, the
    benchmark cell's shape) through ``stage_batch_sparse_device`` and
    ``solve_batch_sparse_stream``; its times beside its bound, its plain
    version, its float32 instance and the padded engine."""
    n, m, k = CONFIG_B
    checks = {}
    # small cases in both value types: the twin against the plane's
    # plain rounds, the kernel against the twin, the rows read, the
    # round trace, a launch continued from another's state
    cases = [(4, 32, 32, 6, 40), (4, 32, 32, 6, 3), (4, 48, 96, 40, 3),
             (4, 64, 4096, 8, 3)]
    small = 0
    for seed, (b, sn, sm, sk, hi) in enumerate(cases):
        cols, vals64, thr64 = arcs_small_case(SEED + seed, b, sn, sm, sk, hi)
        for dtype, npt in ((torch.float32, np.float32),
                           (torch.float64, np.float64)):
            vals, thr, eps = vals64.to(dtype), thr64.to(dtype), npt(1 / 32)
            plane = densify_arcs(cols, vals, sm)
            for rounds in (1, 7, 5000):
                rows = [torch.zeros(b, dtype=torch.int64, device="cuda")
                        for _ in range(3)]
                trace = ([torch.zeros((b, rounds, 3), dtype=torch.int32,
                                      device="cuda") for _ in range(2)]
                         if rounds < 5000 else [None, None])
                plain = ksp.ksp_chunk_reference(
                    plane, ksp.khosla_init(plane), eps, thr, rounds,
                    act_rows=rows[0])
                twin = ka.ksp_arcs_chunk_reference(
                    cols, vals, ka.arcs_init(vals, sm), eps, thr, rounds,
                    act_rows=rows[1], trace_rows=trace[0])
                got = ka.ksp_arcs_chunk(
                    cols, vals, ka.arcs_init(vals, sm), eps, thr, rounds,
                    act_rows=rows[2], trace_rows=trace[1])
                part = ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, sm),
                                         eps, thr, 3)
                part = ka.ksp_arcs_chunk(cols, vals, part, eps, thr, rounds)
                whole = ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, sm),
                                          eps, thr, rounds + 3)
                bad = (arcs_states_differ(twin, plain)
                       + arcs_states_differ(got, twin)
                       + arcs_states_differ(part, whole))
                assert not bad, ("arc kernel, small case", seed, dtype,
                                 rounds, bad)
                assert all(torch.equal(r, rows[0]) for r in rows[1:])
                assert trace[0] is None or torch.equal(trace[0], trace[1])
                small += 1
    checks["small_cases"] = small
    # the float32 stall at the crate's values and ε, which float64 ends
    cols = torch.tensor([[[0, 1], [0, 2]]], dtype=torch.int32, device="cuda")
    stall = {}
    for dtype, npt in ((torch.float32, np.float32),
                       (torch.float64, np.float64)):
        vals = torch.tensor([[[-369.0, -408.0], [-336.0, -375.0]]],
                            dtype=dtype, device="cuda")
        thr = torch.tensor([1.5 * (72.0 + CRATE_EPS)], dtype=dtype,
                           device="cuda")
        got = ka.ksp_arcs_chunk(cols, vals, ka.arcs_init(vals, 3),
                                npt(CRATE_EPS), thr, 500)
        twin = ka.ksp_arcs_chunk_reference(cols, vals, ka.arcs_init(vals, 3),
                                           npt(CRATE_EPS), thr, 500)
        assert not arcs_states_differ(got, twin), ("stall", dtype)
        stall[str(dtype)] = {"nits": int(got.nits), "p2o": got.p2o.tolist()}
    assert stall["torch.float32"]["nits"] == 500
    assert stall["torch.float64"]["p2o"] == [[0, 2]]
    checks["stall"] = stall
    # a size both kernels take: 64 x 128 x 8,192, 32 arcs, float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 300)
    sb, sn, sm = 64, 128, 8192
    cols = torch.rand((sb, sn, sm), generator=gen, device="cuda").topk(
        32, dim=2).indices.to(torch.int32)
    cols = cols[:, :, torch.randperm(32, generator=gen, device="cuda")]
    vals = -torch.randint(300, 1000, (sb, sn, 32), generator=gen,
                          device="cuda", dtype=torch.int32).float()
    thr = (sm / 2.0) * (vals.amax(dim=(1, 2)) - vals.amin(dim=(1, 2))
                        + 1.0 / sm)
    eps = np.float32(1.0 / sm)
    plane = densify_arcs(cols, vals, sm)
    pinit, ainit = ksp.khosla_init(plane), ka.arcs_init(vals, sm)
    pk = ksp.ksp_chunk(plane, pinit, eps, thr, 5000)
    ak = ka.ksp_arcs_chunk(cols, vals, ainit, eps, thr, 5000)
    tw = ka.ksp_arcs_chunk_reference(cols, vals, ainit, eps, thr, 5000)
    bad = arcs_states_differ(ak, pk) + arcs_states_differ(ak, tw)
    assert not bad, ("arc kernel against the plane kernel", bad)
    checks["shared_size"] = {
        "shape": [sb, sn, sm, 32], "nits_max": int(pk.nits.max()),
        "plane_kernel_ms": event_ms(
            lambda: ksp.ksp_chunk(plane, pinit, eps, thr, 5000), reps=5),
        "arcs_kernel_ms": event_ms(
            lambda: ka.ksp_arcs_chunk(cols, vals, ainit, eps, thr, 5000),
            reps=5)}
    del plane, pinit, pk, ak, tw

    # the main path: two batches of config B made on the card, staged
    # with no plane and streamed
    raw = []
    for i in range(2):
        gen.manual_seed(SEED + 310 + i)
        raw.append(crate_arcs(gen, 256))
    routes = dict(batch.SPARSE_ROUTES)
    stage_ms, staged = sync_ms(lambda: [
        port.stage_batch_sparse_device(c, v, m, eps=CRATE_EPS)
        for c, v in raw])
    assert batch.SPARSE_ROUTES["arcs"] == routes["arcs"] + 2
    assert all(st.values_nm is None and st.work_device.dtype == torch.float64
               for st in staged)
    plane_before = ksp.LAUNCHES
    ka.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    first_ms, sols = sync_ms(
        lambda: port.solve_batch_sparse_stream(staged, window=2))
    launches = ka.LAUNCHES
    assert launches > 0, "the arc route launched no arc kernel"
    assert ksp.LAUNCHES == plane_before, "the plane kernel ran on the arcs"
    # a caller that drops each call's results before the next, so the
    # page-locked result blocks come back from the host allocator's
    # cache; then one that keeps every call's results (a new block a
    # call)
    warm_ms, _ = sync_ms(lambda: len(
        port.solve_batch_sparse_stream(staged, window=2)), reps=5)
    held = []
    held_ms, _ = sync_ms(lambda: held.append(
        port.solve_batch_sparse_stream(staged, window=2)), reps=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for s, s2 in zip(sols, held[-1]):
        assert np.array_equal(s.person_to_object, s2.person_to_object)
    del held
    checked = check_crate_solutions(sols, raw, m)
    nits = np.concatenate([s.nits for s in sols])
    emit({"phase": "ksp_arcs_route", "config": "reference crate config B",
          "batches": 2, "batch": 256, "n": n, "m": m, "k": k,
          "eps": CRATE_EPS, "dtype": "float64", "window": 2,
          "stage_ms": stage_ms, "first_call_ms": first_ms,
          "warm_median_ms": warm_ms, "results_held_ms": held_ms,
          "instances_per_s": 512 / (warm_ms / 1e3),
          "nits_p50": float(np.median(nits)), "nits_max": int(nits.max()),
          "ksp_arcs_launches": launches, "scipy_checked": checked,
          "peak_device_gib": peak_gib, **checks})

    # the kernel at the path's shape: one batch from the initial state
    # (its launch of the route's budget), the twin bit-equal, the phase
    # split and CTA timeline, the bound; float32 in the same call
    st = staged[0]
    cols, work, thr = st.columns_device, st.work_device, st.thresholds
    eps = np.float64(st.eps_val)
    b = work.shape[0]
    budget = batch._SPARSE_KERNEL_BUDGET
    s0 = ka.arcs_init(work, m)
    act = torch.zeros(b, dtype=torch.int64, device="cuda")
    cyc = torch.zeros(len(ksp.PHASES), dtype=torch.int64, device="cuda")
    stamps = torch.zeros((b, 2), dtype=torch.int64, device="cuda")
    got = ka.ksp_arcs_chunk(cols, work, s0, eps, thr, budget, act_rows=act,
                            phase_cycles=cyc, stamps=stamps)
    assert not bool(ksp_active(got).any()), "not done within the budget"
    kernel_ms = event_ms(
        lambda: ka.ksp_arcs_chunk(cols, work, s0, eps, thr, budget), reps=5)
    first_round_ms = event_ms(
        lambda: ka.ksp_arcs_chunk(cols, work, s0, eps, thr, 1), reps=5)
    split = kernel_split(ksp.PHASES, cyc, stamps, got.nits)
    plain_ms, want = sync_ms(lambda: ka.ksp_arcs_chunk_reference(
        cols, work, s0, eps, thr, budget))
    bad = arcs_states_differ(got, want)
    assert not bad, ("arc kernel at the path's shape", bad)
    err = float((got.prices - want.prices).abs().max())
    elem = work.element_size()
    # the arcs as stored read once; p2o, dropped, the prices of the
    # objects won and nits written once
    bytes_once = b * n * k * (4 + elem) + b * n * (4 + 1 + elem) + b * 4
    ops = 2 * k * int(act.sum())          # a subtract and a max an arc
    bound_bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    # float32 at the crate's ε: the instances it leaves stalled
    w32, t32 = work.float(), thr.float()
    s32 = ka.ksp_arcs_chunk(cols, w32, ka.arcs_init(w32, m),
                            np.float32(CRATE_EPS), t32, 5000)
    stalled = int(ksp_active(s32).any(dim=1).sum())
    del s32, w32, t32
    # the float32 instance where it serves: ε = 2^-12, which float32
    # keeps here and which gives the exact optimum too; staged by the
    # route (float32 arcs), beside the float64 instance on the same arcs
    f32 = [port.stage_batch_sparse_device(c, v, m, eps=CRATE_EPS_F32)
           for c, v in raw]
    assert all(s.work_device.dtype == torch.float32 for s in f32)
    f32_sols = port.solve_batch_sparse_stream(f32, window=2)
    f32_checked = check_crate_solutions(f32_sols, raw, m, per_batch=2)
    c32, w32, t32 = (f32[0].columns_device, f32[0].work_device,
                     f32[0].thresholds)
    i32 = ka.arcs_init(w32, m)
    w64, t64 = w32.double(), t32.double()
    i64 = ka.arcs_init(w64, m)
    f32_ms = event_ms(lambda: ka.ksp_arcs_chunk(
        c32, w32, i32, np.float32(CRATE_EPS_F32), t32, budget), reps=5)
    f64_same_ms = event_ms(lambda: ka.ksp_arcs_chunk(
        c32, w64, i64, np.float64(CRATE_EPS_F32), t64, budget), reps=5)
    f32_state = ka.ksp_arcs_chunk(c32, w32, i32, np.float32(CRATE_EPS_F32),
                                  t32, budget)
    f32_twin = ka.ksp_arcs_chunk_reference(
        c32, w32, i32, np.float32(CRATE_EPS_F32), t32, budget)
    assert not arcs_states_differ(f32_state, f32_twin), "float32 crate batch"
    del f32, f32_sols, w32, t32, i32, w64, t64, i64, f32_state, f32_twin
    # the padded engine on the same batch (host layouts, then the plain
    # gather rounds), 64 rounds at most
    c_host = cols.cpu().numpy()
    v_host = raw[0][1].cpu().numpy().astype(np.float64)
    chunk_ms = []
    real = batch._batch_chunk_sparse

    def timed_chunk(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args)
        end.record()
        torch.cuda.synchronize()
        chunk_ms.append(start.elapsed_time(end))
        return out

    batch._batch_chunk_sparse = timed_chunk
    try:
        padded_s, pad = wall_s(lambda: port.solve_batch_sparse(
            c_host, v_host, m, eps=CRATE_EPS, dtype=np.float64,
            engine="padded", max_rounds=budget))
    finally:
        batch._batch_chunk_sparse = real
    # the host entry point on the same batch: engine="auto" takes the
    # arcs (float64) and gives the stream's answer
    routes = dict(batch.SPARSE_ROUTES)
    before = ka.LAUNCHES
    auto_ms, auto = sync_ms(lambda: port.solve_batch_sparse(
        c_host, v_host, m, eps=CRATE_EPS))
    assert batch.SPARSE_ROUTES["arcs"] == routes["arcs"] + 1
    assert ka.LAUNCHES > before, "solve_batch_sparse launched no arc kernel"
    for field in ("person_to_object", "object_to_person", "nits",
                  "objective", "num_unassigned"):
        assert np.array_equal(getattr(auto, field), getattr(sols[0], field)), \
            ("solve_batch_sparse differs from the staged stream", field)
    emit({"phase": "ksp_arcs_kernel_time", "shape": [b, n, m, k],
          "dtype": "float64", "rounds_budget": budget,
          "nits_p50": float(got.nits.float().median()),
          "nits_max": int(got.nits.max()), "ms": kernel_ms,
          "first_round_ms": first_round_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes_once": bytes_once, "act_rows": int(act.sum()), **split,
          "float32_crate_eps_stalled_instances": stalled,
          "float32_eps": CRATE_EPS_F32, "float32_ms": f32_ms,
          "float64_same_eps_ms": f64_same_ms,
          "float32_scipy_checked": f32_checked,
          "padded_wall_s": padded_s, "padded_rounds_ms": sum(chunk_ms),
          "padded_nits_max": int(pad.nits.max()),
          "solve_batch_sparse_auto_ms": auto_ms,
          "library_ms": None, "plain_bit_exact": True})
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "launches": launches,
            "float32_ms": f32_ms}


# ----------------------------------------------------------------------
# the eps-scaling ladder on the arcs (scale_eps)
# ----------------------------------------------------------------------
#: the benchmark cell whose batch the ladder phase runs, and its eps
CONFIG_A_CELL = "ksparse-crate-a.b128x2-n10000"
CONFIG_A_EPS = 2.0 ** -15 / (10_000 + 1)


def config_a_arcs(gen, b, n, k, config):
    """A batch of the reference crate's config A law on the card, made by
    the benchmark's own generator (``benchmark/gen/ksparse_symmetric.py``)
    from the CUDA generator ``gen``."""
    from benchmark import plugins

    return plugins.load_module("gen", "ksparse_symmetric")._batch(
        gen, b, n, k, config, "cuda")


def padded_scipy_objective(cols, vals, m):
    """``min_weight_full_bipartite_matching``'s optimum of one instance's
    arcs with ``-1`` pads (float32 values on the 2^-15 lattice: the
    float64 sum is exact)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    ok = cols >= 0
    mat = csr_matrix((vals[ok].astype(np.float64), cols[ok].astype(np.int64),
                      np.concatenate([[0], np.cumsum(ok.sum(axis=1))])),
                     shape=(cols.shape[0], m))
    rows, picked = min_weight_full_bipartite_matching(mat)
    return float(np.asarray(mat[rows, picked]).sum())


def ladders_differ(a, b):
    """The fields in which two ``(states, ladder)`` results differ."""
    return (arcs_states_differ(a[0], b[0])
            + [k for k in a[1]._fields
               if not torch.equal(getattr(a[1], k), getattr(b[1], k))])


def phase_ksp_ladder(port, batch, ka):
    """The ladder kernel bit-equal to its plain version on small square
    batches in both value types (rows of 8 to 176 slots), whole, stopped
    and continued; one batch of the config A cell (128 instances of
    10,000², about 101 arcs a person in 176 slots, eps = 2^-15 / 10,001)
    staged with ``scale_eps`` and solved through the stream: its
    launches, the kernel's time on the batch beside its bound, rounds by
    phase; the batch's quickest, median and slowest instances, as the
    kernel's one launch over the whole batch left them, bit-equal to the
    plain version run on those three alone (both timed on those three),
    and scipy's optimum on each of them."""
    from benchmark import plugins

    cell = plugins.cell(CONFIG_A_CELL)
    config = cell.config
    gen = torch.Generator(device="cuda")
    small = 0
    for seed, (b, n, k, density, integer) in enumerate([
            (4, 64, 8, 0.05, True), (4, 64, 40, 0.3, False),
            (5, 200, 48, 0.1, False), (3, 300, 176, 0.3, False),
            (4, 256, 40, 0.04, True)]):
        gen.manual_seed(SEED + 400 + seed)
        cols, vals = config_a_arcs(gen, b, n, k,
                                   dict(config, density=density))
        if integer:  # ε = 1/(n+1) in float32: its own kernel instance
            vals = torch.where(cols >= 0, vals.floor(), 0.0)
        eps = 1.0 / (n + 1) if integer else 2.0 ** -15 / (n + 1)
        st = port.stage_batch_sparse_device(cols, vals, n, eps=eps,
                                            scale_eps=True)
        assert st.work_device.dtype == (torch.float32 if integer
                                        else torch.float64)
        c, w = st.columns_device, st.work_device
        s0 = ka.arcs_init(w, n)
        for rounds in (1, 7, 300, 1 << 18):
            got = ka.ksp_arcs_ladder(c, w, s0, st.ladder, eps, n, rounds)
            want = ka.ksp_arcs_ladder_reference(c, w, s0, st.ladder, eps,
                                                n, rounds)
            part = ka.ksp_arcs_ladder(c, w, s0, st.ladder, eps, n, 5)
            part = ka.ksp_arcs_ladder(c, w, *part, eps, n, rounds)
            whole = ka.ksp_arcs_ladder(c, w, s0, st.ladder, eps, n,
                                       rounds + 5)
            bad = ladders_differ(got, want) + ladders_differ(part, whole)
            assert not bad, ("ladder kernel, small case", seed, rounds, bad)
            small += 1
        assert not bool(ksp_active(got[0]).any()), "a small ladder undone"

    # the cell's batch, through the entry points
    spec = cell.spec
    n, b, k = spec["rows"], spec["batch"], spec["arcs"]
    gen.manual_seed(SEED + 420)
    cols, vals = config_a_arcs(gen, b, n, k, config)
    stage_ms, st = sync_ms(lambda: port.stage_batch_sparse_device(
        cols, vals, n, eps=CONFIG_A_EPS, scale_eps=True))
    assert st.ladder is not None and st.work_device.dtype == torch.float64
    before = ka.LADDER_LAUNCHES
    arcs_before = ka.LAUNCHES
    solve_ms, sol = sync_ms(
        lambda: port.solve_batch_sparse_stream([st], window=1)[0])
    launches = ka.LADDER_LAUNCHES - before
    assert launches == 1 and ka.LAUNCHES == arcs_before, launches
    assert int(sol.num_unassigned.sum()) == 0, "unassigned persons"
    assert np.array_equal(sol.rounds_by_phase.sum(axis=1), sol.nits)
    # the kernel from the initial state, one launch of the route's budget
    # over the whole batch
    c, w = st.columns_device, st.work_device
    budget = batch._SPARSE_LADDER_BUDGET
    s0 = ka.arcs_init(w, n)
    kernel_ms = event_ms(lambda: ka.ksp_arcs_ladder(
        c, w, s0, st.ladder, CONFIG_A_EPS, n, budget), reps=3)
    got = ka.ksp_arcs_ladder(c, w, s0, st.ladder, CONFIG_A_EPS, n, budget)
    assert np.array_equal(got[0].p2o.cpu().numpy(), sol.person_to_object)
    # the arcs as stored read once (int32 columns, float64 values), p2o,
    # dropped, the prices and nits written once
    bytes_once = b * n * k * 12 + b * n * (4 + 1 + 8) + b * 4
    bound_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    # three instances at their batch indices: the plain version on them
    # alone against the batch launch's rows, both timed on the three
    order = np.argsort(sol.nits, kind="stable")
    picks = [int(order[0]), int(order[len(order) // 2]), int(order[-1])]
    at = torch.tensor(picks, device="cuda")
    c3, w3 = c[at].contiguous(), w[at].contiguous()
    lad3 = ka.Ladder(*(x[at].contiguous() for x in st.ladder))
    s3 = ka.arcs_init(w3, n)
    plain_ms, want = sync_ms(lambda: ka.ksp_arcs_ladder_reference(
        c3, w3, s3, lad3, CONFIG_A_EPS, n, budget))
    picked_ms = event_ms(lambda: ka.ksp_arcs_ladder(
        c3, w3, s3, lad3, CONFIG_A_EPS, n, budget), reps=1)
    rows = (got[0]._replace(**{f: getattr(got[0], f)[at]
                               for f in ARCS_FIELDS}),
            ka.Ladder(*(x[at] for x in got[1])))
    bad = ladders_differ(rows, want)
    assert not bad, ("ladder kernel at config A", picks, bad)
    c_host, v_host = cols.cpu().numpy(), vals.cpu().numpy()
    for i in picks:
        assert sol.objective[i] == padded_scipy_objective(
            c_host[i], v_host[i], n), ("config A optimum", i)
    rbp = sol.rounds_by_phase
    emit({"phase": "ksp_ladder", "config": "reference crate config A",
          "cell": CONFIG_A_CELL, "shape": [b, n, n, k], "eps": CONFIG_A_EPS,
          "dtype": "float64", "small_cases": small,
          "arcs_mean": float((cols >= 0).sum(dim=2).float().mean()),
          "stage_ms": stage_ms, "first_solve_ms": solve_ms,
          "ladder_launches": launches, "ms": kernel_ms,
          "bound_ms": bound_ms, "bound_by": "bytes",
          "roofline_pct": 100.0 * bound_ms / kernel_ms,
          "nits_p50": float(np.median(sol.nits)),
          "nits_max": int(sol.nits.max()), "nits_min": int(sol.nits.min()),
          "phases": int(rbp.shape[1]),
          "rounds_by_phase_max": rbp.max(axis=0).tolist(),
          "rounds_by_phase_p50": np.median(rbp, axis=0).tolist(),
          "checked_instances": picks,
          "checked_nits": [int(sol.nits[i]) for i in picks],
          "plain_ms_checked": plain_ms, "kernel_ms_checked": picked_ms,
          "scipy_checked": len(picks), "library_ms": None,
          "plain_bit_exact": True})
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "launches": launches,
            "checked_instances": picks, "kernel_ms_checked": picked_ms,
            "max_abs_err": float((rows[0].prices - want[0].prices)
                                 .abs().max())}


# ----------------------------------------------------------------------
# the forward and Khosla engines (the fused dense round kernel)
# ----------------------------------------------------------------------
ROUND_OUT = ("prices", "p2o", "o2p", "chosen", "maxp")


def round_outputs_differ(got, want):
    return [k for k, a, b in zip(ROUND_OUT, got, want)
            if a.dtype != b.dtype or not torch.equal(a, b)]


FORWARD_FIELDS = ("prices", "p2o", "o2p", "eps", "nits", "nreductions",
                  "optimal_found", "done")


def forward_states_differ(a, b):
    return [k for k in FORWARD_FIELDS
            if not torch.equal(getattr(a, k), getattr(b, k))]


def phase_dense_chunk_vs_plain(dr, drs, forward_init):
    """The forward chunk kernel against its plain version, bit for bit,
    on every ForwardState field, ``alldone`` and the rows read, after 1,
    2, 5 and 64 rounds and then every 64 to done: forward-rect at full
    size, a square batch through its eps-reductions, forced done flags
    with a per-instance eps, a ``max_iterations`` that ends inside a
    chunk, a -inf plane with single-arc persons, and shapes off the
    16-byte path.  At each checkpoint ``fused_dense_round`` (the
    single-instance kernel) on two instances against the plain round at
    B = 1, as the state stands and with forced done flags and a
    per-instance eps; at the first four also the batch's single-round
    entry in both forms."""
    gen = torch.Generator(device="cuda")
    cases = []
    worst = 0.0
    for name, b, n, m, arcs, forced, max_it in (
        ("forward-rect 4096 x (256 x 512)", 4096, 256, 512, 0, False,
         100_000),
        ("square 512 x 256², eps-scaling", 512, 256, 256, 0, False,
         100_000),
        ("square 64 x 256², forced done, per-instance eps", 64, 256, 256,
         0, True, 100_000),
        ("square 64 x 128², max_iterations 37", 64, 128, 128, 0, False,
         37),
        ("-inf plane 128x512, 6 arcs a person, 8 single-arc persons",
         16, 128, 512, 6, False, 100_000),
        ("128x8192 wide rows", 8, 128, 8192, 0, False, 100_000),
        ("24x40 off every tile", 32, 24, 40, 0, False, 100_000),
        ("24x42 rows off 16 bytes", 32, 24, 42, 0, False, 100_000),
    ):
        gen.manual_seed(SEED + 7 * n + m)
        vals = -torch.randint(1, 1000, (b, n, m), generator=gen,
                              device="cuda", dtype=torch.int32).float()
        if arcs:
            keep = torch.rand((b, n, m), generator=gen,
                              device="cuda").argsort(dim=2) < arcs
            # persons 0..7 keep one arc each, to the object of their index
            keep[:, :8, :] = False
            keep[:, torch.arange(8), torch.arange(8)] = True
            vals = torch.where(keep, vals, float("-inf"))
        target = np.float32(1.0 / (n + 1))
        c = float(vals[torch.isfinite(vals)].abs().max())
        tol = np.float32(2.0 ** (int(np.log2(c + 1e-7)) - 53))
        sfoe = n != m
        vt = vals.transpose(1, 2)
        st = forward_init(vt, c / 128.0 if n == m else float(target))
        if forced:
            done = st.done.clone()
            done[::3] = True
            st = st._replace(done=done, eps=st.eps * torch.linspace(
                0.5, 2.0, b, device="cuda"))
        got = want = st
        rows_k = torch.zeros(b, dtype=torch.int64, device="cuda")
        rows_p = torch.zeros(b, dtype=torch.int64, device="cuda")
        total = 0
        for chunk in (1, 1, 3, 59) + (64,) * 40:
            got, gdone = dr.fused_dense_chunk(vals, got, target, tol, max_it,
                                              chunk, sfoe, rows=rows_k)
            torch.cuda.synchronize()
            want, wdone = dr.dense_chunk_reference(vals, want, target, tol,
                                                   max_it, chunk, sfoe,
                                                   rows=rows_p)
            total += chunk
            bad = forward_states_differ(got, want)
            if not torch.equal(rows_k, rows_p):
                bad.append("rows")
            if bool(gdone) != bool(wdone):
                bad.append("alldone")
            assert not bad, (name, total, bad)
            worst = max(worst, check_single_round(
                dr, drs, vals, got, name, total <= 64 and b <= 512))
            if bool(wdone):
                break
        assert bool(got.done.all()), (name, "not done", total)
        if max_it < 100:
            assert int(got.nits.max()) == max_it, name
        cases.append({"case": name, "batch": b, "rounds_compared": total,
                      "nits_max": int(got.nits.max()),
                      "eps_reductions_max": int(got.nreductions.max()),
                      "rows": int(rows_k.sum()),
                      "unassigned": int((got.p2o == 2**31 - 1).sum())})
    emit({"phase": "dense_chunk_vs_plain", "kernel": "dense_round_kernel",
          "checkpoints": "after 1, 2, 5, 64 rounds, then every 64 to done; "
                         "fused_dense_round (dense_round_single) on "
                         "instances 0 and 1 at every checkpoint against "
                         "the plain round at B=1, as the state stands "
                         "(Python scalars) and with forced done flags "
                         "and per-instance eps (0-d tensors); the batch's "
                         "single-round entry at the first four",
          "cases": cases, "tolerance": 0, "max_abs_err": worst,
          "fields": "every ForwardState field, alldone and rows; the "
                    "round's prices, p2o, o2p, chosen, maxp; bit-exact"})
    return worst


def check_single_round(dr, drs, vals_nm, st, name, batch_entry):
    """The single-round entry points at state ``st`` against their plain
    version, bit for bit; returns the largest price difference (0).
    ``fused_dense_round`` (``csrc/dense_round_single.cu``) on instances 0
    and 1: eps and done as the state stands, as Python scalars, and a
    per-instance eps with forced done flags, as 0-d tensors on the card,
    each against ``fused_dense_round_batch_reference`` at B = 1.  With
    ``batch_entry``, also ``fused_dense_round_batch`` (the chunk kernel's
    single-round mode) on the whole batch in both forms."""
    b = vals_nm.shape[0]
    vt = vals_nm.transpose(1, 2).contiguous()
    done2 = st.done.clone()
    done2[::3] = True
    eps2 = st.eps * torch.linspace(0.5, 2.0, b, device="cuda")
    worst = 0.0
    for eps_b, done_b in ((st.eps, st.done), (eps2, done2)):
        args = (vt, st.prices, st.p2o, st.o2p, eps_b, done_b)
        if batch_entry:
            got = dr.fused_dense_round_batch(*args, vals_nm=vals_nm)
            torch.cuda.synchronize()
            want = dr.fused_dense_round_batch_reference(*args)
            bad = round_outputs_differ(got, want)
            assert not bad, (name, "single round", bad)
            worst = max(worst, float((got[0].double() - want[0].double())
                                     .abs().max()))
        for i in range(min(b, 2)):
            one = (vt[i], st.prices[i], st.p2o[i], st.o2p[i])
            if eps_b is st.eps:
                scalars = (float(eps_b[i]), bool(done_b[i]))
            else:
                scalars = (eps_b[i], done_b[i])
            got = drs.fused_dense_round(*one, *scalars)
            torch.cuda.synchronize()
            want = drs.fused_dense_round_reference(*one, eps_b[i],
                                                   done_b[i])
            bad = round_outputs_differ(got, want)
            assert not bad, (name, "fused_dense_round", i, bad)
            worst = max(worst, float((got[0].double() - want[0].double())
                                     .abs().max()))
    return worst


def scipy_objectives(scipy_lsa, costs, rows, maximize=False):
    out = []
    for i in rows:
        c = costs[i].astype(np.float64)
        r, k = scipy_lsa(c, maximize=maximize)
        out.append(float(c[r, k].sum()))
    return out


def phase_forward_rect(port, batch, dr, scipy_lsa):
    """The forward engine at full size: 4096 instances of 256 persons x
    512 objects, float32 host costs, through ``solve_batch`` with
    ``solver="auto"`` (which resolves to the forward engine on N < M)."""
    b, n, m = 4096, 256, 512
    eps = 1.0 / (n + 1)
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    costs = rng.integers(1, 1000, size=(b, n, m), dtype=np.int32).astype(
        np.float32)
    gen_s = time.perf_counter() - t0

    def solve():
        return port.solve_batch(costs, eps=eps)

    dr.LAUNCHES = 0
    first_ms, sol = sync_ms(solve)
    launches = dr.LAUNCHES
    assert launches > 0, "the forward path launched no dense round kernel"
    # one launch a 64-round chunk, as many chunks as the slowest instance
    # needs
    chunks = -(-int(sol.nits.max()) // 64)
    assert launches == chunks, (launches, chunks)
    torch.cuda.reset_peak_memory_stats()
    warm_ms, sol2 = sync_ms(solve)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert np.array_equal(sol.person_to_object, sol2.person_to_object)
    assert int(sol.num_unassigned.max()) == 0, "unassigned persons"
    rows = list(range(0, b, b // 8))
    want = scipy_objectives(scipy_lsa, costs, rows)
    assert [float(sol.objective[i]) for i in rows] == want, "objectives"
    nits = sol.nits
    emit({"phase": "forward_rect", "batch": b, "n": n, "m": m,
          "costs": "integers in [1, 1000) as float32, host",
          "solver": "auto -> forward (N < M), start eps = target",
          "eps": eps, "generate_s": gen_s, "first_call_ms": first_ms,
          "warm_ms": warm_ms, "instances_per_s": b / (warm_ms / 1e3),
          "nits_p50": float(np.median(nits)), "nits_max": int(nits.max()),
          "dense_round_launches": launches, "chunks": chunks,
          "scipy_equal": len(rows), "peak_device_gib": peak_gib})
    return launches


def forward_loop(batch, costs, eps, solver):
    """``batch._solve_batch_dense`` on ``costs`` as ``solve_batch`` runs
    it, each step timed on its own and ended by a device sync: the host
    parameters, the copy to the card, the staging and the chunk loop,
    with the chunk kernel's launches timed by CUDA events."""
    b, n, m = costs.shape
    t = {}
    t["host_params_ms"], (eps_val, target, tol, thr) = sync_ms(
        lambda: batch._dense_engine_params(costs, False, solver, eps, n, m,
                                            128.0))
    t["copy_to_card_ms"], dev = sync_ms(
        lambda: torch.from_numpy(costs).cuda())
    t["stage_ms"], work = sync_ms(lambda: batch._stage_work(dev, True))
    del dev
    events = []
    real = batch.fused_dense_chunk

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    batch.fused_dense_chunk = timed
    try:
        t["loop_ms"], out = sync_ms(
            lambda: batch._solve_batch_dense(work, eps_val, target, tol, thr,
                                             solver, 100_000, n, m))
    finally:
        batch.fused_dense_chunk = real
    kernel_ms = sum(s.elapsed_time(e) for s, e in events)
    return t, out, kernel_ms, len(events)


def phase_forward_square(port, batch, dr, scipy_lsa):
    """``solver="forward"`` on square instances, the eps-scaling path
    (its wall, launches and chunk loop), and rectangular
    ``linear_sum_assignment`` in both orientations."""
    b, n = 512, 256
    rng = np.random.default_rng(SEED + 2)
    costs = rng.integers(1, 1000, size=(b, n, n)).astype(np.float32)
    eps = 1.0 / (n + 1)

    def solve():
        return port.solve_batch(costs, solver="forward", eps=eps)

    dr.LAUNCHES = 0
    first_ms, sol = sync_ms(solve)
    launches = dr.LAUNCHES
    chunks = -(-int(sol.nits.max()) // 64)
    assert launches == chunks, (launches, chunks)
    wall_ms, sol2 = sync_ms(solve, reps=3)
    assert np.array_equal(sol.person_to_object, sol2.person_to_object)
    assert int(sol.num_unassigned.max()) == 0, "unassigned persons"
    t, _, kernel_ms, _ = forward_loop(batch, costs, eps, "forward")
    start = np.abs(costs.reshape(b, -1)).max(axis=1) / 128.0
    reductions = np.rint(np.log(sol.eps / start) / np.log(0.15)).astype(int)
    assert reductions.max() > 0, "no eps reduction anywhere"
    rows = list(range(0, b, b // 8))
    want = scipy_objectives(scipy_lsa, costs, rows)
    assert [float(sol.objective[i]) for i in rows] == want, "objectives"
    lsa = []
    for shape in ((300, 200), (128, 256)):
        mat = rng.integers(1, 1000, size=shape).astype(np.float64)
        ms, (r, c) = sync_ms(lambda: port.linear_sum_assignment(mat))
        sr, sc = scipy_lsa(mat)
        assert len(r) == min(shape) and np.all(np.diff(r) > 0)
        assert len(set(c.tolist())) == min(shape)
        assert mat[r, c].sum() == mat[sr, sc].sum(), shape
        lsa.append({"shape": list(shape), "wall_ms": ms,
                    "scipy_equal": True})
    emit({"phase": "forward_square", "batch": b, "n": n, "eps": eps,
          "start_eps": "max|cost| / 128", "first_call_ms": first_ms,
          "wall_ms": wall_ms, "dense_round_launches": launches,
          "chunks": chunks, **t, "of_loop_kernel_ms": kernel_ms,
          "nits_p50": float(np.median(sol.nits)),
          "nits_max": int(sol.nits.max()),
          "eps_reductions_min": int(reductions.min()),
          "eps_reductions_max": int(reductions.max()),
          "final_eps_max": float(sol.eps.max()), "scipy_equal": len(rows),
          "linear_sum_assignment": lsa})


def phase_khosla_dense(port, scipy_lsa):
    """``solver="khosla"`` on dense instances: the plain rounds of
    ``ops/auction.py`` on the card."""
    b, n = 64, 256
    rng = np.random.default_rng(SEED + 3)
    costs = rng.integers(1, 10, size=(b, n, n)).astype(np.float32)
    eps = 1.0 / (n + 1)
    wall_ms, sol = sync_ms(lambda: port.solve_batch(
        costs, solver="khosla", eps=eps))
    assert int(sol.num_unassigned.max()) == 0, "unassigned persons"
    rows = list(range(0, b, b // 4))
    want = scipy_objectives(scipy_lsa, costs, rows)
    assert [float(sol.objective[i]) for i in rows] == want, "objectives"
    emit({"phase": "khosla_dense", "batch": b, "n": n,
          "costs": "integers in [1, 10) as float32", "eps": eps,
          "wall_ms": wall_ms, "nits_p50": float(np.median(sol.nits)),
          "nits_max": int(sol.nits.max()),
          "ms_per_round": wall_ms / int(sol.nits.max()),
          "scipy_equal": len(rows)})


def phase_fr_plain_rounds(port, batch, fr_kernel, scipy_lsa):
    """The FR engine's plain-rounds route through ``solve_batch``:
    float64 values, and float32 instances off the fused kernel's
    tiling."""
    out = []
    before = fr_kernel.LAUNCHES
    for b, n, dtype in ((64, 256, np.float64), (64, 200, np.float32)):
        rng = np.random.default_rng(SEED + n)
        costs = rng.integers(1, 1000, size=(b, n, n)).astype(np.float64)
        eps = 1.0 / (n + 1)
        assert batch._route(b, n, n, dtype, None) == "plain"
        wall_ms, sol = sync_ms(lambda: port.solve_batch(
            costs, eps=eps, dtype=dtype, integer=False))
        assert int(sol.num_unassigned.max()) == 0, "unassigned persons"
        rows = list(range(0, b, b // 4))
        want = scipy_objectives(scipy_lsa, costs, rows)
        assert [float(sol.objective[i]) for i in rows] == want, (n, dtype)
        out.append({"batch": b, "n": n, "dtype": np.dtype(dtype).name,
                    "wall_ms": wall_ms,
                    "nits_p50": float(np.median(sol.nits)),
                    "nits_max": int(sol.nits.max()),
                    "scipy_equal": len(rows)})
    assert fr_kernel.LAUNCHES == before, "the FR kernel ran on a plain route"
    emit({"phase": "fr_plain_rounds", "cases": out,
          "host_cpus": os.cpu_count(),
          "note": "host costs: stragglers left after 96 rounds go to the "
                  "native engine, as on the JAX schedule"})


def phase_dense_chunk_time(dr, forward_init):
    """The forward chunk kernel at the main path's shape, 4096 x (256
    persons x 512 objects) float32 from the initial state: CUDA-event
    time of one 64-round launch, of its first round alone and of a
    launch on the finished batch; the plain version on the same input;
    the bound by bytes once and by the rows really read; and the
    single-round entry points at the same shape."""
    b, n, m = 4096, 256, 512
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 4)
    vals = -torch.randint(1, 1000, (b, n, m), generator=gen, device="cuda",
                          dtype=torch.int32).float()
    target = np.float32(1.0 / (n + 1))
    tol = np.float32(2.0 ** (int(np.log2(999.0)) - 53))
    st = forward_init(vals.transpose(1, 2), float(target))
    args = (target, tol, 100_000)
    rows = torch.zeros(b, dtype=torch.int64, device="cuda")
    got, _ = dr.fused_dense_chunk(vals, st, *args, 64, True, rows=rows)
    assert bool(got.done.all()), "forward-rect not done within one chunk"
    kernel_ms = event_ms(
        lambda: dr.fused_dense_chunk(vals, st, *args, 64, True), reps=5)
    first_round_ms = event_ms(
        lambda: dr.fused_dense_chunk(vals, st, *args, 1, True), reps=5)
    done_ms = event_ms(
        lambda: dr.fused_dense_chunk(vals, got, *args, 64, True), reps=5)
    plain_ms, (want, _) = sync_ms(
        lambda: dr.dense_chunk_reference(vals, st, *args, 64, True))
    bad = forward_states_differ(got, want)
    assert not bad, ("forward chunk at the main path's shape", bad)
    err = float((got.prices.double() - want.prices.double()).abs().max())
    rows_read = int(rows.sum())
    # every input read once, every output written once: the plane and
    # the state (prices, p2o, o2p, eps, nits, nreductions, two flags)
    state = b * (4 * m + 4 * n + 4 * m + 4 + 4 + 4 + 1 + 1)
    bytes_once = vals.numel() * 4 + 2 * state
    # a subtract and two compares for every element of every row read
    ops = 3 * rows_read * m
    bound_bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    rows_bound_ms = rows_read * m * 4 / HBM_BYTES_PER_S * 1e3
    # the single-round entry points: one round with both margins
    vt = vals.transpose(1, 2).contiguous()
    one = (vt, st.prices, st.p2o, st.o2p, st.eps, st.done)
    single_ms = event_ms(
        lambda: dr.fused_dense_round_batch(*one, vals_nm=vals), reps=5)
    single_plain_ms, _ = sync_ms(
        lambda: dr.fused_dense_round_batch_reference(*one))
    b1 = (vt[:1], st.prices[:1], st.p2o[:1], st.o2p[:1], st.eps[:1],
          st.done[:1])
    b1_ms = event_ms(lambda: dr.fused_dense_round_batch(*b1), reps=5)
    del vt
    emit({"phase": "dense_chunk_time", "shape": [b, n, m],
          "dtype": "float32", "state": "initial, start eps = target",
          "chunk": 64, "nits_p50": float(got.nits.float().median()),
          "nits_max": int(got.nits.max()), "ms": kernel_ms,
          "first_round_ms": first_round_ms, "ms_all_done": done_ms,
          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes_once": bytes_once, "bound_ops_ms": bound_ops_ms,
          "rows_read": rows_read, "rows_bound_ms": rows_bound_ms,
          "bytes_per_s_achieved": rows_read * m * 4 / (kernel_ms / 1e3),
          "library_ms": None, "plain_bit_exact": True,
          "single_round": {"ms": single_ms, "plain_ms": single_plain_ms,
                           "b1_ms": b1_ms, "note": "one round with both "
                           "margins of every person, every person bidding"}})
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err,
            "rows_bound_ms": rows_bound_ms, "first_round_ms": first_round_ms,
            "single_round_ms": single_ms}


def old_route_fused_dense_round(dr, vals_t, prices, p2o, o2p, eps, done,
                                vals_nm=None):
    """``fused_dense_round`` as the port ran it before
    ``csrc/dense_round_single.cu``, the comparison's old side: the batch
    entry at B = 1 (the chunk kernel's single-round mode, one CTA, on a
    transposed copy of the plane), with eps and done copied to the
    card.  ``vals_nm``, the plane's transpose ``[1, N, M]`` made
    contiguous beforehand, leaves the copy out, to time the kernel
    alone."""
    dev = vals_t.device
    out = dr.fused_dense_round_batch(
        vals_t[None], prices[None], p2o[None], o2p[None],
        torch.as_tensor(eps, dtype=vals_t.dtype, device=dev).reshape(1),
        torch.as_tensor(done, dtype=torch.bool, device=dev).reshape(1),
        vals_nm=vals_nm,
    )
    return tuple(x[0] for x in out)


#: a wait queued on the card before a timed launch (about 0.5 ms), so
#: that the start event and the launch are both queued before the card
#: reaches them and the events time the device alone, not the host's
#: enqueueing
QUEUE_CYCLES = 1_000_000


def queued_ms(fn, reps=5):
    """Median device time (ms) of the launches of ``fn()``, timed by
    CUDA events behind a queued wait."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def launch_ms(mod, fn, reps=5):
    """Median device time (ms) of the kernel launches alone inside one
    ``fn()``: CUDA events around every call of ``mod._launch``, each
    behind a queued wait."""
    real = mod._launch
    per_call = []

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        real(*args, **kwargs)
        end.record()
        per_call[-1].append((start, end))

    mod._launch = timed
    try:
        for _ in range(reps):
            per_call.append([])
            fn()
        torch.cuda.synchronize()
    finally:
        mod._launch = real
    return statistics.median(sum(s.elapsed_time(e) for s, e in evs)
                             for evs in per_call)


#: torch.profiler captures device_ops takes at most for one count
PROFILE_TRIES = 3


def device_ops(fn):
    """The device work one ``fn()`` issues, from ``torch.profiler``:
    kernels by name, memcpys and memsets (after one warm call), and the
    captures it took.  A capture holding no CUDA event at all saw no
    device (on an H100 the first capture of a long process has come back
    so) and is taken again, up to ``PROFILE_TRIES`` times; the caller
    decides whether an empty count is a failure."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for capture in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels, copies, sets = {}, 0, 0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            low = e.name.lower()
            if "memcpy" in low:
                copies += 1
            elif "memset" in low:
                sets += 1
            else:
                kernels[e.name] = kernels.get(e.name, 0) + 1
        if kernels or copies or sets:
            break
    return {"kernels": kernels, "memcpy": copies, "memset": sets,
            "captures": capture}


#: the shipped instance of the single round's kernel (all three phases),
#: as torch.profiler names it
COOP_KERNEL = re.compile(r"dense_round_single_coop<(\(int\))?7>")
#: dense_round_single_time's shapes, (objects M, persons N) of vals_t,
#: and the eps of its rounds
SINGLE_SHAPES = ((256, 256), (512, 256), (4096, 4096))
SINGLE_EPS = 999.0 / 128.0
#: (objects, persons) off every tile and slice edge, checked bit-equal
ODD_SHAPES = ((1, 1), (3, 5), (7, 70), (70, 7), (513, 257), (1000, 33))
#: timings of a whole call (host work included, so noisier than a
#: kernel's) take the median of this many
CALL_REPS = 21


def single_round_states(drs, m, n):
    """``vals_t [m, n]`` (integer costs in [1, 1000) negated, made on the
    card from the seed) and two states ``(prices, p2o, o2p, plain
    rounds run)``: "opening", everyone unassigned at zero prices, and
    "late", after the plain rounds at ``SINGLE_EPS`` leave at most 8
    persons unassigned."""
    unassigned = 2**31 - 1
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11 * m + n)
    vt = -torch.randint(1, 1000, (m, n), generator=gen, device="cuda",
                        dtype=torch.int32).float()
    opening = (torch.zeros(m, device="cuda"),
               torch.full((n,), unassigned, dtype=torch.int32,
                          device="cuda"),
               torch.full((m,), unassigned, dtype=torch.int32,
                          device="cuda"))
    st, rounds = opening, 0
    while int((st[1] == unassigned).sum()) > 8:
        st = drs.fused_dense_round_reference(vt, *st, SINGLE_EPS,
                                             False)[:3]
        rounds += 1
    return vt, {"opening": (*opening, 0), "late": (*st, rounds)}


def phase_dense_round_single_time(dr, drs, fr_big):
    """``fused_dense_round`` (``csrc/dense_round_single.cu``) at 256²,
    512 objects x 256 persons and 4096² in the two states of
    :func:`single_round_states`.  Each: bit-equal to the plain version;
    the call's ms (CUDA events around the call, median of ``CALL_REPS``)
    and the kernel's (events around the launch alone, median of 5); the
    plain version's ms; the old route (:func:`old_route_fused_dense_round`,
    bit-equal) beside it: its call, its kernel on a plane transposed
    beforehand, and that transpose copy alone; the bound (the plane and
    the state each read once, the outputs written once, at 3.35 TB/s;
    three operations an element walked at 67 TFLOP/s) beside the
    design's bytes (the bidder tiles' columns for the bids and the plane
    again for the margins) and a latency floor (the skeleton instance,
    every phase empty, plus two dependent slice walks of measured HBM
    load latency); the device time split by phase (the instances running
    the first 0, 1, 2 and 3 phases); the kernels and memcpys of one call
    (``torch.profiler``: exactly one launch of the shipped instance, no
    memcpy, no memset)."""
    links = 1 << 28  # a dependent load that misses L2 (1 GiB chain)
    chain = torch.remainder(
        torch.arange(links, dtype=torch.int32, device="cuda") + 4_194_319,
        links).to(torch.int32)
    load_ns = fr_big.probe(chain, 2000)["hbm_load_ns"]
    del chain
    unassigned = 2**31 - 1
    eps = SINGLE_EPS
    out, worst = [], 0.0
    for m, n in SINGLE_SHAPES:
        vt, states = single_round_states(drs, m, n)
        pl = drs.plan(m, n)
        for state, (prices, p2o, o2p, r) in states.items():
            args = (vt, prices, p2o, o2p, eps, False)
            got = drs.fused_dense_round(*args)
            torch.cuda.synchronize()
            plain_ms, want = sync_ms(
                lambda: drs.fused_dense_round_reference(*args), reps=3)
            bad = round_outputs_differ(got, want)
            assert not bad, ("dense_round_single", m, n, state, bad)
            old = old_route_fused_dense_round(dr, *args)
            bad = round_outputs_differ(old, want)
            assert not bad, ("old route", m, n, state, bad)
            worst = max(worst, float((got[0].double() - want[0].double())
                                     .abs().max()))
            call_ms = event_ms(lambda: drs.fused_dense_round(*args),
                               reps=CALL_REPS)
            kernel_ms = launch_ms(drs, lambda: drs.fused_dense_round(*args))
            ops = device_ops(lambda: drs.fused_dense_round(*args))
            names = list(ops["kernels"])
            assert (len(names) == 1 and COOP_KERNEL.search(names[0])
                    and ops["kernels"][names[0]] == 1
                    and ops["memcpy"] == 0 and ops["memset"] == 0), (
                "one call is not one launch of the round's kernel "
                "(no CUDA events means the profiler saw no device)", ops)
            # the old route: its call; its kernel on a plane transposed
            # beforehand (so _launch's .contiguous() copies nothing); the
            # transpose copy the call makes, alone
            vnm = vt.t().contiguous()[None]
            old_ms = {
                "call_ms": event_ms(
                    lambda: old_route_fused_dense_round(dr, *args),
                    reps=CALL_REPS),
                "kernel_ms": launch_ms(
                    dr, lambda: old_route_fused_dense_round(
                        dr, *args, vals_nm=vnm)),
                "copy_ms": queued_ms(
                    lambda: vt[None].transpose(1, 2).contiguous()),
                "ops": device_ops(
                    lambda: old_route_fused_dense_round(dr, *args))}
            bad = round_outputs_differ(
                old_route_fused_dense_round(dr, *args, vals_nm=vnm), want)
            assert not bad, ("old route, plane given", m, n, state, bad)
            del vnm
            # the bound: the plane read once, the state read (prices,
            # p2o, o2p) and written (the five outputs) once; operations: a
            # subtract and two compares an element the design walks (the
            # 32-person tiles holding a bidder over all M objects for the
            # bids, the plane again for the margins)
            bidders = p2o == unassigned
            tiles = int(torch.nn.functional.pad(
                bidders, (0, 32 * pl.tiles - n)).view(pl.tiles, 32)
                .any(dim=1).sum())
            bid_cols = min(32 * tiles, n)
            elems = (bid_cols + n) * m
            state_bytes = 4 * (2 * m + n) + 4 * (2 * m + 3 * n)
            nbytes = 4 * m * n + state_bytes
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = 3 * elems / F32_OPS_PER_S * 1e3
            bound_ms = max(bound_bytes_ms, bound_ops_ms)
            bound_by = ("bytes" if bound_bytes_ms >= bound_ops_ms
                        else "operations")
            # the design's bytes: both walks, not a bound of the function
            design_bytes_ms = ((4 * elems + state_bytes)
                               / HBM_BYTES_PER_S * 1e3)
            # device time of parts of the round (the instances running no
            # phase, the launch and barriers alone, then phase 1, 1-2, 1-3)
            outs = [torch.empty(k, dtype=d, device="cuda")
                    for k, d in ((m, torch.float32), (n, torch.int32),
                                 (m, torch.int32), (n, torch.float32),
                                 (n, torch.float32))]
            scratch = torch.empty(pl.scratch_bytes, dtype=torch.uint8,
                                  device="cuda")
            parts = {}
            for mask in (0, 1, 3, 7):
                parts[f"phases_{mask}"] = queued_ms(
                    lambda mask=mask: drs._launch(
                        vt, prices, p2o, o2p, eps, None, 0, None,
                        [t.data_ptr() for t in outs], scratch.data_ptr(),
                        pl, phases=mask))
            # the last launches were the whole round
            bad = round_outputs_differ(outs, want)
            assert not bad, ("dense_round_single by _launch", m, n, state,
                             bad)
            del outs, scratch
            split = {"launch_and_barriers": parts["phases_0"],
                     "phase1_bid_walk": parts["phases_1"]
                     - parts["phases_0"],
                     "phase2_merge_and_bid": parts["phases_3"]
                     - parts["phases_1"],
                     "phase3_margins": parts["phases_7"]
                     - parts["phases_3"]}
            walks_ms = 2 * pl.walk_steps * load_ns / 1e6
            floor_ms = parts["phases_0"] + walks_ms
            out.append({
                "m_objects": m, "n_persons": n, "state": state,
                "plain_rounds_before": r,
                "unassigned": int(bidders.sum()), "bidder_tiles": tiles,
                "plan": pl._asdict(), "bit_equal": True,
                "call_ms": call_ms, "kernel_ms": kernel_ms,
                "kernel_ms_queued": parts["phases_7"],
                "plain_ms": plain_ms, "old_route_call_ms": old_ms["call_ms"],
                "old_route_kernel_ms": old_ms["kernel_ms"],
                "old_route_copy_ms": old_ms["copy_ms"],
                "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ops_ms": bound_ops_ms,
                "design_bytes_ms": design_bytes_ms,
                "skeleton_ms": parts["phases_0"],
                "split_ms": split, "phase_instance_ms": parts,
                "latency_floor_ms": floor_ms, "ops_per_call": ops,
                "old_route_ops_per_call": old_ms["ops"]})
        del vt, states
    # shapes off every tile and slice edge, 12 rounds each from the
    # opening, bit-equal
    odd = []
    for m, n in ODD_SHAPES:
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED + m * 7 + n)
        vt = -torch.randint(1, 1000, (m, n), generator=gen, device="cuda",
                            dtype=torch.int32).float()
        st = (torch.zeros(m, device="cuda"),
              torch.full((n,), unassigned, dtype=torch.int32,
                         device="cuda"),
              torch.full((m,), unassigned, dtype=torch.int32,
                         device="cuda"))
        for r in range(12):
            got = drs.fused_dense_round(vt, *st, eps, False)
            want = drs.fused_dense_round_reference(vt, *st, eps, False)
            bad = round_outputs_differ(got, want)
            assert not bad, ("dense_round_single", m, n, r, bad)
            st = want[:3]
        odd.append([m, n])
    emit({"phase": "dense_round_single_time",
          "kernel": "dense_round_single", "eps": eps,
          "costs": "integers in [1, 1000) negated, float32, on the card",
          "hbm_load_ns": load_ns,
          "latency_floor": "the cooperative skeleton (launch and two grid "
                           "barriers) + 2 x walk_steps dependent HBM loads",
          "cases": out, "odd_shapes_12_rounds_bit_equal": odd,
          "max_abs_err": worst})
    main = next(c for c in out if (c["m_objects"], c["n_persons"],
                                   c["state"]) == (512, 256, "opening"))
    return {"ms": main["call_ms"], "kernel_ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "design_bytes_ms": main["design_bytes_ms"],
            "latency_floor_ms": main["latency_floor_ms"],
            "max_abs_err": worst}


# ----------------------------------------------------------------------
# the reference-crate API for one sparse instance (no kernel of its own:
# the JAX package runs these engines as plain XLA, the port as plain
# PyTorch, chunks replayed as CUDA graphs)
# ----------------------------------------------------------------------
#: the new phases' sizes (module constants so that a rehearsal on the
#: CPU can shrink them): the headline n, config B (persons, objects,
#: arcs a person), config A's n, the sparse-host batch
HEADLINE_N = 100_000
CONFIG_B = (2000, 60000, 32)
CONFIG_A_N = 10_000
SPARSE_HOST = (1024, 256, 2048, 8)


def kernel_counts(mods) -> dict:
    return {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES for m in mods}


def zero_counts(mods) -> None:
    for m in mods:
        m.LAUNCHES = 0


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def csr_original_units(solver):
    """The solver's arcs as a scipy CSR matrix in the caller's units."""
    from scipy.sparse import csr_matrix

    vals = np.asarray(solver.values, dtype=np.float64)
    if vals.size and vals[0] < 0:
        vals = -vals
    return csr_matrix((vals, solver.column_indices.astype(np.int64),
                       solver.i_starts_stops.astype(np.int64)),
                      shape=(solver.num_rows, solver.num_cols))


def scipy_sparse_optimum(solver):
    """``min_weight_full_bipartite_matching``'s objective and seconds."""
    from scipy.sparse.csgraph import min_weight_full_bipartite_matching

    mat = csr_original_units(solver)
    t0 = time.perf_counter()
    rows, cols = min_weight_full_bipartite_matching(mat)
    secs = time.perf_counter() - t0
    return float(np.asarray(mat[rows, cols]).sum()), secs


def ecs_worst(solver, solution):
    """The largest eps-CS violation ``max_profit - eps - chosen_profit``
    over the persons (<= 0 where the certificate holds with no slack)."""
    vals = np.asarray(solver.values, dtype=np.float64)
    cols = solver.column_indices.astype(np.int64)
    rows = np.repeat(np.arange(solver.num_rows),
                     solver.j_counts.astype(np.int64))
    profit = vals - solver.prices[cols]
    maxp = np.full(solver.num_rows, -np.inf)
    np.maximum.at(maxp, rows, profit)
    p2o = solution.person_to_object.astype(np.int64)
    chosen = np.full(solver.num_rows, -np.inf)
    hit = cols == p2o[rows]
    np.maximum.at(chosen, rows[hit], profit[hit])
    return float(np.max(maxp - solution.eps - chosen))


class Breakdown:
    """Seconds and calls of named module functions, each ended by a
    device sync, while the context is open (a breakdown run only)."""

    def __init__(self, targets):
        self.targets = targets  # [(module, name)]
        self.secs = {}
        self.calls = {}
        self.saved = []

    def __enter__(self):
        for mod, name in self.targets:
            real = getattr(mod, name)
            self.saved.append((mod, name, real))

            def timed(*a, _real=real, _name=name, **k):
                t0 = time.perf_counter()
                out = _real(*a, **k)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                self.secs[_name] = self.secs.get(_name, 0.0) + dt
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def readme_solvers(port, dtype=np.float64):
    out = []
    for cls in (port.KhoslaSolver, port.ForwardAuctionSolver):
        solver, solution = cls.new(10, 10, 100, dtype=dtype)
        solver.init(2, 4)
        for i, row in enumerate([[10, 6, 14, 1], [17, 18, 16]]):
            solver.extend_from_values(i, range(len(row)), row)
        out.append((solver, solution))
    return out


def phase_reference_api(port, mods, card):
    """The README 2x4 example on both solvers over every engine, the
    error probes, and an infeasible instance on each solver."""
    zero_counts(mods)
    unassigned = port.UNASSIGNED
    routes = {
        "KhoslaSolver": [{}, {"engine": "native"}, {"engine": "device"},
                         {"compact": True}, {"scale_eps": True},
                         {"hybrid": True},
                         {"hybrid": True, "scale_eps": True}],
        "ForwardAuctionSolver": [{}, {"engine": "native"},
                                 {"engine": "device"}],
    }
    walls = {}
    for dtype in (np.float64, np.float32):
        for solver, solution in readme_solvers(port, dtype):
            name = type(solver).__name__
            for kw in routes[name]:
                secs, _ = wall_s(lambda: solver.solve(solution, False, **kw))
                assert solution.num_unassigned == 0, (name, kw)
                assert solver.get_objective(solution) == 17.0, (name, kw)
                assert list(solution.person_to_object) == [3, 2], (name, kw)
                assert list(solution.object_to_person) == [
                    unassigned, unassigned, 1, 0], (name, kw)
                key = f"{name} {np.dtype(dtype).name} " + (
                    ",".join(f"{k}={v}" for k, v in kw.items()) or "auto")
                walls[key] = secs
    probes = []
    for cls in (port.KhoslaSolver, port.ForwardAuctionSolver):
        for engine in ("native", "device"):
            solver, solution = cls.new(4, 4, 16)
            for what, build in (
                    ("init(5, 4)", lambda s: s.init(5, 4)),
                    ("no arcs", lambda s: (s.init(1, 1), s.solve(
                        solution, engine=engine))),
                    ("column out of range", lambda s: (
                        s.init(1, 2), s.add_value(0, 5, 1.0),
                        s.solve(solution, engine=engine)))):
                try:
                    build(solver)
                except ValueError as e:
                    probes.append(f"{cls.__name__} {engine} {what}: {e}")
                else:
                    raise AssertionError(f"no ValueError: {what}")
    infeasible = {}
    for cls, kw in ((port.KhoslaSolver, {"engine": "native"}),
                    (port.KhoslaSolver, {"engine": "device"}),
                    (port.ForwardAuctionSolver, {})):
        solver, solution = cls.new(2, 2, 2)
        solver.init(2, 2)
        solver.add_value(0, 0, 1.0)
        solver.add_value(1, 0, 2.0)
        secs, _ = wall_s(lambda: solver.solve(solution, False, **kw))
        assert solution.num_unassigned == 1, (cls.__name__, kw)
        key = cls.__name__ + (" " + kw["engine"] if kw else " auto")
        infeasible[key] = {"num_unassigned": solution.num_unassigned,
                           "nits": solver.nits, "wall_s": secs}
        if cls is port.ForwardAuctionSolver:
            # single-arc rows: the device route, stopped by its
            # infeasibility certificate far below max_iterations
            assert not solver.optimal_soln_found
            assert solver.nits < 10_000, solver.nits
            infeasible[key]["optimal_soln_found"] = False
    launches = kernel_counts(mods)
    assert not any(launches.values()), launches
    emit({"phase": "reference_api", "card": card,
          "readme_example_walls_s": walls, "error_probes": probes,
          "infeasible": infeasible, "kernel_launches": launches})


def phase_khosla_headline(port, mods, card):
    """The repo's headline, not cut: n = 100,000, about 6 arcs a person,
    values U[0, 10), eps = 1/n, float32 (``bench.py:169-270``), on the
    auto route (the native ladder), the hybrid and the device route;
    each against scipy's ``min_weight_full_bipartite_matching``."""
    from sparse_linear_assignment_tpu_torch import hybrid
    from sparse_linear_assignment_tpu_torch.ops import compact
    from sparse_linear_assignment_tpu_torch.ops.padded import (
        build_padded_problem,
    )

    n = HEADLINE_N
    solver, solution = port.KhoslaSolver.new(n, n, 10 * n)
    t0 = time.perf_counter()
    port.generators.gen_symmetric_input(solver, 42, n, 5.0 / n, 0.0, 10.0)
    gen_s = time.perf_counter() - t0
    solver.dtype = np.dtype(np.float32)
    want, scipy_s = scipy_sparse_optimum(solver)
    c = float(np.abs(solver.values).max())
    # the device route's warm solve is its breakdown run: each chunk
    # ends in a readback anyway, so the syncs cost nothing extra
    routes = (("auto", {}, 3, None),
              ("hybrid", {"scale_eps": True, "hybrid": True}, 3, None),
              ("device", {"engine": "device", "scale_eps": True}, 1,
               [(compact, "khosla_full_chunk"), (compact, "khosla_run_chunk"),
                (compact, "repack_slots")]))
    out = {}
    for name, kw, warm_reps, targets in routes:
        zero_counts(mods)
        first, _ = wall_s(lambda: solver.solve(solution, False, **kw))
        with Breakdown(targets or []) as bd:
            warm = [wall_s(lambda: solver.solve(solution, False, **kw))[0]
                    for _ in range(warm_reps)]
        got = solver.get_objective(solution)
        assert solution.num_unassigned == 0, name
        assert abs(got - want) <= n * solution.eps + 1e-6, (name, got, want)
        # float32 rounds values and prices: the certificate holds within
        # a few roundings at the scale of the largest value plus the
        # largest price (docs/PARITY.md, deviation 6)
        tol = (c + float(np.abs(solver.prices).max())) * 2.0 ** -22
        assert solver.ecs_satisfied(solution.person_to_object,
                                    solution.eps, tol), name
        out[name] = {"first_s": first, "warm_s": warm,
                     "warm_median_s": statistics.median(warm),
                     "nits": solver.nits, "num_unassigned": 0,
                     "objective": got, "gap": got - want,
                     "ecs_toleration": tol,
                     "ecs_worst": ecs_worst(solver, solution),
                     "kernel_launches": kernel_counts(mods)}
        assert not any(out[name]["kernel_launches"].values()), name
        if targets:
            out[name]["breakdown"] = {"s": bd.secs, "calls": bd.calls}
    # where a warm hybrid solve's time goes (one more solve)
    with Breakdown([(hybrid, "khosla_full_chunk"),
                    (hybrid, "_read_lstate"),
                    (hybrid, "khosla_finish_cpu")]) as bd:
        secs, _ = wall_s(lambda: solver.solve(solution, False,
                                              scale_eps=True, hybrid=True))
    out["hybrid"]["breakdown"] = {"wall_s": secs, "s": bd.secs,
                                  "calls": bd.calls}
    # one full-scan and one slot-list chunk from the same state on the
    # card and on the CPU: bit-equal (scatters included)
    problem = solver._staged_problem[2]
    cpu_problem = build_padded_problem(
        n, n, solver.j_counts, solver.column_indices, solver.values,
        dtype=np.float32, device="cpu")
    eps = np.float32(solution.eps)
    thr = np.float32((n / 2.0) * (float(solver.values.max())
                                  - float(solver.values.min()) + 1e-5))
    st = compact.fresh_lstate(
        torch.zeros(n, dtype=problem.dtype, device=problem.device), n)
    st, _ = compact.khosla_full_chunk(problem, st, eps, thr, 6)
    st = compact.repack_slots(st, min(n, 32768))
    cst = compact.lstate_from_jax(compact.lstate_to_numpy(st), device="cpu")
    equal = {}
    for what, fn, chunk in (("khosla_full_chunk", compact.khosla_full_chunk,
                             4),
                            ("khosla_run_chunk", compact.khosla_run_chunk,
                             64)):
        card_st, card_n = fn(problem, st, eps, thr, chunk)
        cpu_st, cpu_n = fn(cpu_problem, cst, eps, thr, chunk)
        a = compact.lstate_to_numpy(card_st)
        b = compact.lstate_to_numpy(cpu_st)
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not bad and int(card_n) == int(cpu_n), (what, bad)
        equal[what] = {"rounds": chunk, "active_after": int(card_n),
                       "bit_equal": True}
    emit({"phase": "khosla_headline", "card": card, "n": n,
          "arcs": solver.num_of_arcs(), "generate_s": gen_s,
          "dtype": "float32", "eps": solution.eps,
          "scipy_objective": want, "scipy_s": scipy_s, "routes": out,
          "card_vs_cpu": equal})


def phase_khosla_asym(port, mods, card):
    """The reference's bench config B at its largest step, not cut:
    2,000 persons, 60,000 objects, 32 arcs a person, Beta(3,3) integer
    values in [300, 1000) (``benches/benchmark.rs:159-249``), native
    and on the card."""
    n, m, k = CONFIG_B
    solver, solution = port.KhoslaSolver.new(n, m, n * k)
    t0 = time.perf_counter()
    port.generators.gen_asymmetric_input(solver, SEED, n, m, k, 300.0,
                                         700.0)
    gen_s = time.perf_counter() - t0
    out = {}
    for name, kw in (("native", {"engine": "native"}),
                     ("device", {"engine": "device"})):
        zero_counts(mods)
        first, _ = wall_s(lambda: solver.solve(solution, False, **kw))
        warm, _ = wall_s(lambda: solver.solve(solution, False, **kw))
        assert solution.num_unassigned == 0, name
        out[name] = {"first_s": first, "warm_s": warm, "nits": solver.nits,
                     "objective": solver.get_objective(solution),
                     "kernel_launches": kernel_counts(mods)}
        assert not any(out[name]["kernel_launches"].values()), name
    gap = out["device"]["objective"] - out["native"]["objective"]
    assert abs(gap) <= n * solution.eps + 1e-6, gap
    emit({"phase": "khosla_asym", "card": card, "n": n, "m": m,
          "k": k, "values": "Beta(3,3) floored, [300, 1000)",
          "eps": solution.eps, "generate_s": gen_s, "routes": out,
          "objective_gap": gap, "bound": "n * eps"})


def phase_forward_config_a(port, mods, card):
    """The reference's bench config A at its largest step: n = 10,000,
    density 1%, values U[500, 1000) (``benches/benchmark.rs:81-157``),
    ``ForwardAuctionSolver`` native and on the card."""
    n = CONFIG_A_N
    solver, solution = port.ForwardAuctionSolver.new(n, n, n * n // 50)
    t0 = time.perf_counter()
    port.generators.gen_symmetric_input(solver, SEED, n, 0.01, 500.0,
                                        1000.0)
    gen_s = time.perf_counter() - t0
    want, scipy_s = scipy_sparse_optimum(solver)
    out = {}
    for name, kw in (("native", {"engine": "native"}),
                     ("device", {"engine": "device"})):
        zero_counts(mods)
        first, _ = wall_s(lambda: solver.solve(solution, False, **kw))
        warm, _ = wall_s(lambda: solver.solve(solution, False, **kw))
        got = solver.get_objective(solution)
        assert solution.num_unassigned == 0, name
        assert solver.optimal_soln_found, name
        assert abs(got - want) <= n * solution.eps + 1e-6, (name, got, want)
        out[name] = {"first_s": first, "warm_s": warm, "nits": solver.nits,
                     "nreductions": solver.nreductions,
                     "optimal_soln_found": True, "objective": got,
                     "gap": got - want, "eps": solution.eps,
                     "kernel_launches": kernel_counts(mods)}
        assert not any(out[name]["kernel_launches"].values()), name
    emit({"phase": "forward_config_a", "card": card, "n": n,
          "arcs": solver.num_of_arcs(), "generate_s": gen_s,
          "scipy_objective": want, "scipy_s": scipy_s, "routes": out})


def phase_batch_sparse_padded(port, mods, card):
    """``solve_batch_sparse(engine="padded")`` on the sparse-host
    configuration, beside ``engine="dense"`` (the Khosla kernel)."""
    b, n, m, k = SPARSE_HOST
    cols, vals = port.generators.gen_batch_ksparse(SEED, b, n, m, k)
    dense_ms, dense = sync_ms(lambda: port.solve_batch_sparse(
        cols, vals, m, engine="dense"), reps=3)
    zero_counts(mods)
    padded_ms, padded = sync_ms(lambda: port.solve_batch_sparse(
        cols, vals, m, engine="padded"), reps=3)
    launches = kernel_counts(mods)
    assert not any(launches.values()), launches
    assert int(padded.num_unassigned.sum()) == 0
    assert np.array_equal(padded.objective, dense.objective)
    same = float(np.mean(padded.person_to_object == dense.person_to_object))
    emit({"phase": "batch_sparse_padded", "card": card, "batch": b, "n": n,
          "m": m, "k": k, "padded_wall_ms": padded_ms,
          "dense_wall_ms": dense_ms, "objectives_equal": True,
          "same_assignment_share": same,
          "nits_max": int(padded.nits.max()),
          "kernel_launches": launches})


# ----------------------------------------------------------------------
# the sharded modes (parallel/sharded.py) on a world of one NCCL rank
# ----------------------------------------------------------------------
def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def collective_counts():
    from sparse_linear_assignment_tpu_torch.parallel import collectives

    return dict(collectives.COUNTS)


def reset_collectives():
    from sparse_linear_assignment_tpu_torch.parallel import collectives

    collectives.reset_counts()


def only_kernel(launches, name):
    """Raise unless ``name`` launched and no other kernel did."""
    assert launches[name] > 0, (name, launches)
    assert not any(v for k, v in launches.items() if k != name), launches


def solutions_equal(a, b, fields=("person_to_object", "object_to_person",
                                  "nits", "num_unassigned", "objective")):
    return [f for f in fields
            if not np.array_equal(getattr(a, f), getattr(b, f))]


def sharded_north_star(port, batch, sharded, mods, fr_init):
    """``solve_batch_sharded`` on the north-star batch against
    ``solve_batch`` (bit-equal), every instance certified by its duals,
    and the stream of three such batches against ``solve_batch_stream``."""
    b, n, max_cost = 4096, 256, 1000
    gen = torch.Generator(device="cuda")
    batches = []
    for k in range(3):
        gen.manual_seed(SEED + k)
        batches.append(torch.randint(1, max_cost, (b, n, n), generator=gen,
                                     device="cuda",
                                     dtype=torch.int32).float())
    costs = batches[0]
    host = costs.cpu().numpy()
    kw = dict(integer=True, max_cost=max_cost)

    def solve_sharded():
        return sharded.solve_batch_sharded(host, costs_device=costs, **kw)

    zero_counts(mods)
    reset_collectives()
    first_ms, sol = sync_ms(solve_sharded)
    launches = kernel_counts(mods)
    counts = collective_counts()
    only_kernel(launches, "fr_kernel")
    # batched: no collective a round, one done count a chunk (a launch
    # each), one gather of the result
    assert counts == {"all_gather": 1, "max": 0, "min": 0,
                      "sum": launches["fr_kernel"]}, counts
    warm_ms, sol2 = sync_ms(solve_sharded, reps=3)
    ref_ms, ref = sync_ms(lambda: port.solve_batch(
        None, costs_device=costs, **kw), reps=3)
    assert not solutions_equal(sol, sol2)
    bad = solutions_equal(sol, ref)
    assert not bad, ("solve_batch_sharded differs from solve_batch", bad)
    assert int(sol.num_unassigned.max()) == 0
    # the same deterministic solve through the sharded pieces, for its
    # duals: every instance is certified optimal
    scale = batch._integer_scale(None, None, n, n, True, max_cost)
    sched = batch._fr_fused_schedule(b, n, 100_000)
    vt, work, profits = sharded._stage_values_t_sharded(costs, True, scale)
    st, undone = sharded._fr_batch_chunk_local(
        vt, fr_init(vt, 1, profits=profits), 100_000, 128, True, sched,
        values=work)
    while int(undone):
        st, undone = sharded._fr_batch_chunk_local(
            vt, st, 100_000, 128, True, values=work)
    assert np.array_equal(st.p2o.cpu().numpy(), sol.person_to_object)
    certify_lattice(work, st)
    del vt, work, profits, st
    # where a warm sharded solve's time goes (one more solve, each step
    # ended by a device sync)
    with Breakdown([(sharded, name) for name in (
            "_local_costs", "_stage_values_t_sharded", "fr_init",
            "_fr_batch_chunk_local", "all_gather_parts")]
            + [(batch, "_batch_solution")]) as bd:
        bd_s, _ = wall_s(solve_sharded)
    north = {"batch": b, "n": n, "first_call_ms": first_ms,
             "warm_median_ms": warm_ms, "solve_batch_warm_median_ms": ref_ms,
             "instances_per_s": b / (warm_ms / 1e3),
             "bit_equal_to_solve_batch": True, "certified_optimal": b,
             "kernel_launches": launches, "collectives": counts,
             "breakdown": {"wall_ms": bd_s * 1e3,
                           "ms": {k: v * 1e3 for k, v in bd.secs.items()},
                           "calls": bd.calls}}

    zero_counts(mods)
    reset_collectives()
    stream_ms, res = sync_ms(lambda: sharded.solve_batch_sharded_stream(
        batches, window=2, **kw))
    launches = kernel_counts(mods)
    counts = collective_counts()
    only_kernel(launches, "fr_kernel")
    # one gather a batch and a done check, one more of each after every
    # continuation chunk (a launch and a sum each)
    assert counts == {"all_gather": 3 + counts["sum"], "max": 0, "min": 0,
                      "sum": launches["fr_kernel"] - 3}, counts
    ref_stream_ms, ref_res = sync_ms(lambda: port.solve_batch_stream(
        batches, window=2, **kw))
    assert len(res) == 3
    for got, want in zip(res, ref_res):
        bad = solutions_equal(got, want)
        assert not bad, ("solve_batch_sharded_stream differs", bad)
    assert solutions_equal(res[0], sol) == []
    stream = {"batches": 3, "window": 2, "wall_ms": stream_ms,
              "solve_batch_stream_wall_ms": ref_stream_ms,
              "instances_per_s": 3 * b / (stream_ms / 1e3),
              "bit_equal_to_solve_batch_stream": True,
              "kernel_launches": launches, "collectives": counts}
    return north, stream


def sharded_sparse(port, sharded, mods):
    """``solve_batch_sparse_sharded`` on one sparse-stream batch against
    ``solve_batch_sparse`` on the same arcs."""
    b, n, m, k = 4096, 128, 512, 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 100)
    cols, vals = device_arcs(gen, b, n, m, k, 300, 1000)
    cols, vals = cols.cpu().numpy(), vals.cpu().numpy()
    zero_counts(mods)
    reset_collectives()
    first_ms, sol = sync_ms(
        lambda: sharded.solve_batch_sparse_sharded(cols, vals, m))
    launches = kernel_counts(mods)
    counts = collective_counts()
    only_kernel(launches, "ksparse_kernel")
    # no collective but the gathered result, one a budget tried
    assert counts == {"all_gather": launches["ksparse_kernel"], "max": 0,
                      "min": 0, "sum": 0}, counts
    warm_ms, sol2 = sync_ms(
        lambda: sharded.solve_batch_sparse_sharded(cols, vals, m), reps=3)
    ref_ms, ref = sync_ms(
        lambda: port.solve_batch_sparse(cols, vals, m), reps=3)
    assert not solutions_equal(sol, sol2)
    bad = solutions_equal(sol, ref)
    assert not bad, ("solve_batch_sparse_sharded differs", bad)
    assert int(sol.num_unassigned.sum()) == 0
    return {"batch": b, "n": n, "m": m, "k": k,
            "first_call_ms": first_ms, "warm_median_ms": warm_ms,
            "solve_batch_sparse_warm_median_ms": ref_ms,
            "bit_equal_to_solve_batch_sparse": True,
            "kernel_launches": launches, "collectives": counts}


def sharded_fr_dense(port, sharded, mods, scipy_lsa):
    """``solve_fr_dense_sharded`` on big-4096 (plain PyTorch rounds,
    never the big-single kernel) against scipy and the big-single
    route, whose kernel runs the same rounds."""
    n = 4096
    rng = np.random.default_rng(SEED)
    costs = rng.integers(1, 1000, size=(1, n, n)).astype(np.float64)
    eps = 1.0 / (n + 1)
    zero_counts(mods)
    reset_collectives()
    wall, (p2o, o2p, unassigned, nits, objective) = wall_s(
        lambda: sharded.solve_fr_dense_sharded(costs[0], eps=eps))
    launches = kernel_counts(mods)
    counts = collective_counts()
    assert not any(launches.values()), launches
    # a forward round: 2 max, 2 min, 1 sum; a reverse round: 1 max, 2 min
    fwd = counts["sum"]
    rev = counts["max"] - 2 * fwd
    assert fwd + rev == nits and counts["min"] == 2 * nits, counts
    assert counts["all_gather"] == 1, counts
    assert unassigned == 0
    r, c = scipy_lsa(costs[0])
    assert objective == costs[0][r, c].sum(), "sharded 4096² objective"
    dev = torch.from_numpy(costs.astype(np.float32)).cuda()
    big_ms, big = sync_ms(lambda: port.solve_batch(
        costs, costs_device=dev, eps=eps, dtype=np.float32), reps=3)
    assert np.array_equal(big.person_to_object[0], p2o)
    assert int(big.nits[0]) == nits
    assert np.array_equal(big.object_to_person[0], o2p)
    return {"n": n, "eps": eps, "wall_s": wall, "nits": nits,
            "forward_rounds": fwd, "reverse_rounds": rev,
            "ms_per_round": wall * 1e3 / nits,
            "big_single_route_warm_median_ms": big_ms,
            "scipy_equal": True, "equal_to_big_single_route": True,
            "kernel_launches": launches, "collectives": counts}


def sharded_reference(port, sharded, mods):
    """``solve_sharded_khosla`` on config B and ``solve_sharded_forward``
    on config A, each against the native engine's objective."""
    n, m, k = CONFIG_B
    solver, solution = port.KhoslaSolver.new(n, m, n * k)
    port.generators.gen_asymmetric_input(solver, SEED, n, m, k, 300.0,
                                         700.0)
    solver.solve(solution, False, engine="native")
    native = solver.get_objective(solution)
    zero_counts(mods)
    reset_collectives()
    first, (sol, nits) = wall_s(lambda: sharded.solve_sharded_khosla(solver))
    counts = collective_counts()
    launches = kernel_counts(mods)
    assert not any(launches.values()), launches
    # the chunks replay as CUDA graphs, which call no collective from
    # Python: the counts are those of the capture's eager warm-up round
    # and its 16-round chunk (5 gathers and 1 sum a round, 1 sum a
    # chunk) and of the gathered result.  The per-round counts are held
    # by the audit above, the rounds run by nits.
    assert counts == {"all_gather": 5 + 80 + 1, "max": 0, "min": 0,
                      "sum": 2 + 17}, counts
    rounds_run = 16 * -(-nits // 16)
    warm, _ = wall_s(lambda: sharded.solve_sharded_khosla(solver))
    assert sol.num_unassigned == 0
    got = solver.get_objective(sol)
    assert got == native, (got, native)
    khosla = {"n": n, "m": m, "k": k, "first_s": first, "warm_s": warm,
              "nits": nits, "rounds_run": rounds_run,
              "ms_per_round": warm * 1e3 / rounds_run, "objective": got,
              "native_objective": native, "kernel_launches": launches,
              "collectives_from_python": counts}

    n = CONFIG_A_N
    solver, solution = port.ForwardAuctionSolver.new(n, n, n * n // 50)
    port.generators.gen_symmetric_input(solver, SEED, n, 0.01, 500.0,
                                        1000.0)
    solver.solve(solution, False, engine="native")
    native = solver.get_objective(solution)
    native_nits = solver.nits
    zero_counts(mods)
    reset_collectives()
    wall, (sol, nits) = wall_s(lambda: sharded.solve_sharded_forward(solver))
    counts = collective_counts()
    launches = kernel_counts(mods)
    assert not any(launches.values()), launches
    # as for khosla: the capture's warm-up round and 16-round chunk (6
    # gathers and 3 sums a round) and the gathered result
    assert counts == {"all_gather": 6 + 96 + 1, "max": 0, "min": 0,
                      "sum": 3 + 48}, counts
    rounds_run = 16 * -(-nits // 16)
    assert sol.num_unassigned == 0 and solver.optimal_soln_found
    got = solver.get_objective(sol)
    assert got == native, (got, native)
    forward = {"n": n, "arcs": solver.num_of_arcs(), "wall_s": wall,
               "nits": nits, "nreductions": solver.nreductions,
               "rounds_run": rounds_run,
               "ms_per_round": wall * 1e3 / rounds_run,
               "objective": got, "native_objective": native,
               "native_nits": native_nits, "kernel_launches": launches,
               "collectives_from_python": counts}
    return khosla, forward


def phase_sharded(port, batch, mods, card, fr_init, scipy_lsa):
    """The sharded modes on a world of one NCCL rank, each at the size
    its unsharded counterpart runs above: the collective audit on the
    card, then every entry point against its unsharded route."""
    import datetime

    import torch.distributed as dist

    from sparse_linear_assignment_tpu_torch.parallel import dryrun, sharded

    t0 = time.perf_counter()
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        audit = dryrun.collective_audit(device=None)
        assert dryrun.audit_matches(audit), audit
        emit({"phase": "sharded_audit", "card": card, "world": 1,
              "backend": str(dist.get_backend()), "audit": audit})
        north, stream = sharded_north_star(port, batch, sharded, mods,
                                           fr_init)
        emit({"phase": "sharded_north_star", "card": card, **north})
        emit({"phase": "sharded_stream", "card": card, **stream})
        emit({"phase": "sharded_sparse", "card": card,
              **sharded_sparse(port, sharded, mods)})
        emit({"phase": "sharded_fr_dense", "card": card,
              **sharded_fr_dense(port, sharded, mods, scipy_lsa)})
        khosla, forward = sharded_reference(port, sharded, mods)
        emit({"phase": "sharded_khosla", "card": card, **khosla})
        emit({"phase": "sharded_forward", "card": card, **forward})
    finally:
        dist.destroy_process_group()
    emit({"phase": "sharded", "card": card,
          "seconds": time.perf_counter() - t0})


# ----------------------------------------------------------------------
# the in-kernel round trace (ops/round_log.py)
# ----------------------------------------------------------------------
FR_TRACE_LINE = (r"^fr kernel g=(\d+) round: nits=(-?\d+) mode=(-?\d+) "
                 r"card=(-?\d+) done=(-?\d+)$")


def fr_rows_agree(rows, s0, got):
    """A FR kernel's trace rows against its final state: the row of each
    instance's last round run holds its final nits, mode, cardinality
    and done, and every row after it is zero."""
    from sparse_linear_assignment_tpu_torch.solution import UNASSIGNED

    b, r, _ = rows.shape
    count = (got.nits - s0.nits).long()
    last = rows[torch.arange(b, device=rows.device),
                (count - 1).clamp(min=0)]
    final = torch.stack([got.nits, got.forward_mode.to(torch.int32),
                         (got.p2o != UNASSIGNED).sum(dim=1).to(torch.int32),
                         got.done.to(torch.int32)], dim=1)
    after = torch.arange(r, device=rows.device)[None, :] >= count[:, None]
    return bool(((last == final).all(dim=1) | (count == 0)).all()) and \
        not bool(rows[after].any())


def flips(rows, count):
    """Mode flips of each instance's trace rows ``[B, R, 4]`` over its
    ``count [B]`` rounds run from ``fr_init`` (forward mode at entry)."""
    mode = rows[:, :, 1]
    prev = torch.cat([torch.ones_like(mode[:, :1]), mode[:, :-1]], dim=1)
    r = torch.arange(rows.shape[1], device=rows.device)[None, :]
    return ((mode != prev) & (r < count[:, None])).sum(dim=1)


def traced_rows(*shape):
    return torch.zeros(shape, dtype=torch.int32, device="cuda")


def trace_ms(fn_off, fn_on, reps=5):
    """CUDA-event times of the same launch with the trace off and on (the
    log written to a tensor), in turns off, on, on, off."""
    a = event_ms(fn_off, reps)
    b = event_ms(fn_on, reps)
    c = event_ms(fn_on, reps)
    d = event_ms(fn_off, reps)
    return [a, d], [b, c]


def phase_kernel_trace(port, batch, fr_kernel, fr_big, ksp, fr_init,
                       _build, earlier):
    """The three round kernels' in-kernel trace against their plain
    versions on the card, row for row (int32, bit-equal): ``fr_kernel``
    at 64 x 256² on the lattice to done, ``fr_big_kernel`` for one
    64-round chunk of the 4096² big single and 400 rounds of the
    all-equal 2048² instance, ``ksp_kernel`` on one sparse-stream batch
    to done.  The north-star chunk through ``fr_chunk`` with tracing on
    (its lines captured and parsed) leaves the same state as with it
    off, prints each instance's rounds and ends on its final nits, mode
    and done.  Each kernel's time with the trace off and on (the log
    written to a tensor) beside the earlier phases' figures
    (``earlier``), the traced north-star wall with its printing, the
    kernels' registers and spills, and what the traces show: the
    slowest north-star instance's rounds and flips, the big singles'
    rounds per flip."""
    import io

    from sparse_linear_assignment_tpu_torch.ops import round_log
    from sparse_linear_assignment_tpu_torch.utils import trace

    out = {"phase": "kernel_trace"}
    gen = torch.Generator(device="cuda")

    # fr_kernel, 64 x 256² on the lattice, to done
    b, n = 64, 256
    gen.manual_seed(SEED + 10)
    costs = torch.randint(1, 1000, (b, n, n), generator=gen, device="cuda",
                          dtype=torch.int32).float()
    vt, work = lattice_values(costs)
    s0 = fr_init(vt, 1)
    rounds = batch._fr_fused_schedule(b, n, 100_000)
    rk, rp = traced_rows(b, rounds, 4), traced_rows(b, rounds, 4)
    got, _ = fr_kernel.fr_chunk(vt, s0, rounds, values=work, trace_rows=rk)
    want, _ = fr_kernel.fr_chunk_reference(vt, s0, rounds, trace_rows=rp)
    bad, _ = states_equal(got, want)
    assert not bad and bool(got.done.all()), ("fr_kernel 64x256²", bad)
    assert torch.equal(rk, rp), "fr_kernel trace rows differ from plain"
    assert fr_rows_agree(rk, s0, got)
    out["fr_kernel_64x256"] = {"rows": int((got.nits - s0.nits).sum()),
                               "nits_max": int(got.nits.max())}
    del costs, vt, work, s0, got, want, rk, rp

    # fr_big_kernel: one 64-round chunk of the 4096² big single, 400
    # rounds of the all-equal 2048² instance
    big_cases = []
    rng = np.random.default_rng(SEED)
    dev4 = torch.from_numpy(rng.integers(1, 1000, size=(1, 4096, 4096))
                            .astype(np.float32)).cuda()
    gen.manual_seed(SEED + 2048 + 2)
    dev2 = torch.randint(1, 2, (1, 2048, 2048), generator=gen,
                         device="cuda", dtype=torch.int32).float()
    for dev, chunk, what in ((dev4, 64, "4096² from fr_init"),
                             (dev2, 400, "2048², all costs equal")):
        sz = dev.shape[1]
        vt, work, _ = batch._stage(dev, True, None)
        s0 = fr_init(vt, 1.0 / (sz + 1))
        rk, rp = traced_rows(1, chunk, 4), traced_rows(1, chunk, 4)
        got, _ = fr_big.fr_big_chunk(vt, s0, chunk, values=work,
                                     trace_rows=rk)
        want, _ = fr_big.fr_big_chunk_reference(vt, s0, chunk,
                                                trace_rows=rp)
        bad, _ = states_equal(got, want)
        assert not bad, (what, bad)
        assert torch.equal(rk, rp), (what, "trace rows differ from plain")
        assert fr_rows_agree(rk, s0, got), what
        big_cases.append({"case": what, "rounds": chunk,
                          "flips": int(flips(rk, got.nits)[0])})
        del vt, work, s0, got, want, rk, rp
    out["fr_big_kernel"] = big_cases
    del dev2

    # the big singles to done, traced: time off and on, rounds per flip
    big = {}
    gen.manual_seed(SEED + 8192)
    dev8 = torch.randint(1, 1000, (1, 8192, 8192), generator=gen,
                         device="cuda", dtype=torch.int32).float()
    for dev in (dev4, dev8):
        sz = dev.shape[1]
        vt, work, _ = batch._stage(dev, True, None)
        s0 = fr_init(vt, 1.0 / (sz + 1))
        budget = 100_000
        rows = traced_rows(1, budget, 4)
        off, _ = fr_big.fr_big_chunk(vt, s0, budget, values=work)
        on, _ = fr_big.fr_big_chunk(vt, s0, budget, values=work,
                                    trace_rows=rows)
        bad, _ = states_equal(on, off)
        assert not bad and bool(on.done[0]), (sz, "trace on/off", bad)
        assert fr_rows_agree(rows, s0, on), sz
        nits = int(on.nits[0])
        nflip = int(flips(rows, on.nits)[0])
        run = rows[0, :nits]
        card = run[:, 2]
        entry = {"nits": nits, "nits_per_n": nits / sz, "flips": nflip,
                 "rounds_per_flip": nits / max(nflip, 1),
                 "forward_rounds": int((run[:, 1] == 0).sum()),
                 "rounds_to_card_99pct": int((card < 0.99 * sz).sum()),
                 "rounds_at_last_unmatched": int((card == sz - 1).sum())}
        if sz == 4096:
            entry["ms_off"], entry["ms_on"] = trace_ms(
                lambda: fr_big.fr_big_chunk(vt, s0, budget, values=work),
                lambda: fr_big.fr_big_chunk(vt, s0, budget, values=work,
                                            trace_rows=rows), reps=3)
            entry["big_kernel_time_ms"] = earlier.get("big_kernel_time_ms")
        big[str(sz)] = entry
        del vt, work, s0, off, on, rows
    out["big_single_to_done"] = big
    del dev4, dev8

    # ksp_kernel, one sparse-stream batch, to done
    bk, nk, mk, kk = 4096, 128, 512, 8
    gen.manual_seed(SEED + 100)
    cols, vals = device_arcs(gen, bk, nk, mk, kk, 300, 1000)
    st = port.stage_batch_sparse_device(cols, vals, mk, eps=1.0 / mk)
    plane, thr = st.values_nm, st.thresholds
    eps = np.float32(st.eps_val)
    budget = batch._SPARSE_KERNEL_BUDGET
    k0 = ksp.khosla_init(plane)
    rk, rp = traced_rows(bk, budget, 3), traced_rows(bk, budget, 3)
    got = ksp.ksp_chunk(plane, k0, eps, thr, budget, trace_rows=rk)
    want = ksp.ksp_chunk_reference(plane, k0, eps, thr, budget,
                                   trace_rows=rp)
    off = ksp.ksp_chunk(plane, k0, eps, thr, budget)
    assert not ksp_states_equal(got, want), "ksp kernel vs plain"
    assert not ksp_states_equal(got, off), "ksp kernel trace on/off"
    assert not bool(ksp_active(got).any()), "not done within the budget"
    assert torch.equal(rk, rp), "ksp_kernel trace rows differ from plain"
    count = got.nits.long()
    last = rk[torch.arange(bk, device="cuda"), (count - 1).clamp(min=0)]
    assert bool((last[count > 0] == torch.stack(
        [got.nits, torch.zeros_like(got.nits), torch.ones_like(got.nits)],
        dim=1)[count > 0]).all())
    ms_off, ms_on = trace_ms(
        lambda: ksp.ksp_chunk(plane, k0, eps, thr, budget),
        lambda: ksp.ksp_chunk(plane, k0, eps, thr, budget, trace_rows=rk))
    out["ksp_kernel"] = {"shape": [bk, nk, plane.shape[2]],
                         "rows": int(count.sum()),
                         "nits_max": int(count.max()), "ms_off": ms_off,
                         "ms_on": ms_on,
                         "ksp_kernel_time_ms":
                             earlier.get("ksp_kernel_time_ms")}
    del cols, vals, st, plane, thr, k0, got, want, off, rk, rp

    # the main path at full width: the north-star chunk through fr_chunk
    b, n = 4096, 256
    gen.manual_seed(SEED)
    costs = torch.randint(1, 1000, (b, n, n), generator=gen, device="cuda",
                          dtype=torch.int32).float()
    vt, work = lattice_values(costs)
    del costs
    s0 = fr_init(vt, 1)
    rounds = batch._fr_fused_schedule(b, n, 100_000)
    off, _ = fr_kernel.fr_chunk(vt, s0, rounds, values=work)
    sink = io.StringIO()
    saved = sys.stderr
    sys.stderr = sink
    trace.set_debug(True)
    try:
        traced_wall_ms, (on, _) = sync_ms(
            lambda: fr_kernel.fr_chunk(vt, s0, rounds, values=work))
    finally:
        trace.set_debug(False)
        sys.stderr = saved
    bad, _ = states_equal(on, off)
    assert not bad, ("north-star trace on/off", bad)
    lines = np.array(re.findall(FR_TRACE_LINE, sink.getvalue(), re.M),
                     dtype=np.int64)
    del sink
    nits = off.nits.cpu().numpy().astype(np.int64)
    assert len(lines) == int(nits.sum()), (len(lines), int(nits.sum()))
    g = lines[:, 0]
    assert np.array_equal(g, np.repeat(np.arange(b), nits)), "line order"
    ends = np.cumsum(nits) - 1
    final = np.stack([nits, off.forward_mode.cpu().numpy(),
                      off.done.cpu().numpy()], axis=1).astype(np.int64)
    assert np.array_equal(lines[ends][:, [1, 2, 4]], final), "last rows"
    assert bool(off.done.all()) and np.all(lines[ends][:, 3] == n)
    rows = traced_rows(b, rounds, 4)
    fr_kernel.fr_chunk(vt, s0, rounds, values=work, trace_rows=rows)
    assert fr_rows_agree(rows, s0, off)
    ms_off, ms_on = trace_ms(
        lambda: fr_kernel.fr_chunk(vt, s0, rounds, values=work),
        lambda: fr_kernel.fr_chunk(vt, s0, rounds, values=work,
                                   trace_rows=rows))
    slow = int(nits.argmax())
    card = rows[slow, :nits[slow], 2]
    all_flips = flips(rows, off.nits).cpu().numpy()
    out["north_star"] = {
        "shape": [b, n, n], "rounds_budget": rounds,
        "lines": int(len(lines)),
        "log_bytes": b * rounds * 4 * 4,
        "log_pieces": -(-b * rounds * 4 * 4 // round_log.MAX_LOG_BYTES),
        "ms_off": ms_off, "ms_on": ms_on,
        "kernel_time_ms": earlier.get("kernel_time_ms"),
        "traced_wall_ms_with_printing": traced_wall_ms,
        "states_equal_on_off": True,
        "slowest": {"instance": slow, "rounds": int(nits[slow]),
                    "flips": int(all_flips[slow]),
                    "rounds_at_last_unmatched": int((card == n - 1).sum()),
                    "rounds_to_card_99pct": int((card < 0.99 * n).sum())},
        "rounds_p50": float(np.median(nits)),
        "flips_p50": float(np.median(all_flips)),
        "rounds_per_flip_p50": float(np.median(
            nits / np.maximum(all_flips, 1)))}
    del vt, work, s0, off, on, rows, lines

    out["ptxas"] = {name: _build.ptxas_table(_build.BUILD_LOG[name])
                    for name in ("fr_kernel", "fr_big_kernel", "ksp_kernel")
                    if name in _build.BUILD_LOG}
    out["tolerance"] = 0
    emit(out)


#: the host_dtypes phase's cost types: the name and how the integers in
#: [0, 1000) are brought into the type's range first
HOST_DTYPES = {
    "uint8": lambda x: x % 256,
    "uint32": lambda x: x,
    "int64": lambda x: x,
    "int8": lambda x: x % 256 - 128,
    "bool": lambda x: x,
    "float16": lambda x: x,
}

#: the cases where the JAX package's answer is not scipy's optimum, and
#: the port keeps it (ROADMAP.md section 3; tests/test_torch_dtypes.py):
#: ``-costs`` wraps on unsigned costs, so the forward engine's start eps
#: is near 2^32 / 128 and its float32 ladder stalls; the Khosla span of
#: int8 costs holding -128 and 127 wraps to -1, a negative drop
#: threshold that drops every person in the first round
HOST_DTYPES_REFERENCE = {
    ("uint32", "forward", False): "start eps from the wrapped C stalls",
    ("int8", "khosla", False): "wrapped span drops every person",
    ("int8", "khosla", True): "wrapped span drops every person",
}

#: rounds of the comparison with the CPU route: a whole Khosla solve of
#: these costs takes thousands of plain rounds, seconds a case on the
#: host
HOST_DTYPES_CPU_ROUNDS = 128


def host_dtypes_raises(name, solver, maximize) -> bool:
    """Whether the JAX package raises numpy's ``TypeError`` on bool host
    costs: every sign flip, the Khosla span (a bool subtract) and the FR
    lattice check (``-costs.min()``) at N % 128 == 0."""
    return name == "bool" and not (solver == "forward" and maximize)


def phase_host_dtypes(port, fr_kernel, dr, scipy_lsa):
    """``solve_batch`` on host costs of six types (8 x 256², integers in
    [0, 1000) with a 0, brought into each type's range) on the three
    solvers and both senses: every instance fully matched at scipy's
    optimum, or where the JAX package's answer is not (the reference
    cases above) the same unmatched persons; the first 2 instances
    bit-equal to the CPU route over ``HOST_DTYPES_CPU_ROUNDS`` rounds.
    Where the JAX package raises, the port raises the same
    ``TypeError`` on the card and on the CPU."""
    b, n = 8, 256
    eps = 1.0 / (n + 1)
    rng = np.random.default_rng(SEED + 12)
    base = rng.integers(0, 1000, size=(b, n, n))
    base[:, 0, 0] = 0
    for name, into_range in HOST_DTYPES.items():
        costs = into_range(base).astype(name)
        exact = costs.astype(np.float64)
        cases = []
        t_dtype = time.perf_counter()
        for solver in ("fr", "forward", "khosla"):
            for maximize in (False, True):
                kw = dict(solver=solver, maximize=maximize, eps=eps)
                if host_dtypes_raises(name, solver, maximize):
                    for device in ("cuda", "cpu"):
                        try:
                            port.solve_batch(costs[:2], device=device, **kw)
                        except TypeError:
                            continue
                        raise AssertionError((name, solver, maximize,
                                              device, "did not raise"))
                    cases.append({"solver": solver, "maximize": maximize,
                                  "raises": "TypeError"})
                    continue
                before = (fr_kernel.LAUNCHES, dr.LAUNCHES)
                wall_ms, sol = sync_ms(lambda: port.solve_batch(costs, **kw))
                launched = (fr_kernel.LAUNCHES - before[0],
                            dr.LAUNCHES - before[1])
                if solver == "fr":
                    assert launched[0] > 0, (name, "fr_kernel not run")
                if solver == "forward":
                    assert launched[1] > 0, (name, "dense_round not run")
                reference = HOST_DTYPES_REFERENCE.get(
                    (name, solver, maximize))
                if reference is None:
                    assert int(sol.num_unassigned.max()) == 0, (
                        name, solver, maximize, "unassigned persons")
                    want = scipy_objectives(scipy_lsa, exact, range(b),
                                            maximize)
                    assert sol.objective.tolist() == want, (
                        name, solver, maximize, "objectives")
                else:
                    assert int(sol.num_unassigned.min()) > 0, (
                        name, solver, maximize, "reference case matched")
                small = dict(kw, max_iterations=HOST_DTYPES_CPU_ROUNDS)
                card = port.solve_batch(costs[:2], **small)
                host = port.solve_batch(costs[:2], device="cpu", **small)
                differ = solutions_equal(card, host, fields=(
                    "person_to_object", "object_to_person", "num_unassigned",
                    "nits", "objective", "eps"))
                assert not differ, (name, solver, maximize, "card != cpu",
                                    differ)
                cases.append({
                    "solver": solver, "maximize": maximize,
                    "wall_ms": wall_ms, "nits_p50": float(np.median(sol.nits)),
                    "nits_max": int(sol.nits.max()),
                    "unassigned": int(sol.num_unassigned.sum()),
                    "check": (f"reference: {reference}" if reference
                              else f"scipy optimum on all {b}"),
                    "fr_kernel_launches": launched[0],
                    "dense_round_launches": launched[1],
                    "cpu_bit_equal_rounds": HOST_DTYPES_CPU_ROUNDS})
        emit({"phase": "host_dtypes", "dtype": name, "batch": b, "n": n,
              "eps": eps, "seconds": time.perf_counter() - t_dtype,
              "cases": cases})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script needs one CUDA GPU", file=sys.stderr)
        return 2
    import sparse_linear_assignment_tpu_torch as port

    if Path(port.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: the port imported from {port.__file__}, not "
              f"from this checkout", file=sys.stderr)
        return 2
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    from sparse_linear_assignment_tpu_torch import batch, cpu_reference
    from sparse_linear_assignment_tpu_torch.ops import (
        _build,
        fr_big,
        fr_kernel,
    )
    from sparse_linear_assignment_tpu_torch.ops import dense_round as dr
    from sparse_linear_assignment_tpu_torch.ops import (
        dense_round_single as drs,
    )
    from sparse_linear_assignment_tpu_torch.ops import ksparse_arcs as ka
    from sparse_linear_assignment_tpu_torch.ops import ksparse_kernel as ksp
    from sparse_linear_assignment_tpu_torch.ops import stage as stage_mod
    from sparse_linear_assignment_tpu_torch.ops.auction import forward_init
    from sparse_linear_assignment_tpu_torch.ops.fr_dense import fr_init

    # 1. the card and the build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    fr_kernel._kernel_lib()
    fr_big._kernel_lib()
    ksp._kernel_lib()
    ka._kernel_lib()
    dr._kernel_lib()
    drs._kernel_lib()
    stage_mod._kernel_lib()
    build_s = time.perf_counter() - t0
    # the native engine is built here too (g++, first use), so that no
    # timed phase below pays for its build
    t0 = time.perf_counter()
    cpu_reference.get_lib()
    native_build_s = time.perf_counter() - t0
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in _build.BUILD_LOG.items()}
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "native_build_s": native_build_s, "ptxas": regs})

    # 2. kernels vs plain versions on the card
    max_err = phase_kernel_vs_plain(fr_kernel, fr_init)
    big_plain = phase_big_kernel_vs_plain(batch, fr_big, fr_init)
    phase_ksp_kernel_vs_plain(port, batch, ksp)
    dr_err = phase_dense_chunk_vs_plain(dr, drs, forward_init)

    # 3. the north-star solve through the public entry point
    b, n, max_cost = 4096, 256, 1000
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    costs = torch.randint(1, max_cost, (b, n, n), generator=gen,
                          device="cuda", dtype=torch.int32).float()

    def solve():
        return port.solve_batch(None, costs_device=costs, integer=True,
                                max_cost=max_cost)

    fr_kernel.LAUNCHES = 0
    drs.LAUNCHES = 0
    stage_mod.LAUNCHES = 0
    first_ms, sol = sync_ms(solve)
    launches = fr_kernel.LAUNCHES
    single_launches = drs.LAUNCHES
    stage_launches = stage_mod.LAUNCHES
    assert launches > 0, "the main path launched no FR kernel"
    assert stage_launches == 1, "the main path did not stage on the kernel"
    torch.cuda.reset_peak_memory_stats()
    warm_ms, sol2 = sync_ms(solve, reps=3)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    assert np.array_equal(sol.person_to_object, sol2.person_to_object)
    assert int(sol.num_unassigned.max()) == 0, "unassigned persons"
    scale = batch._integer_scale(None, None, n, n, True, max_cost)
    assert scale == n + 1 and n * 1 < scale
    # the same deterministic solve through batch.py's pieces, for its
    # duals: the certificate makes every instance exactly optimal
    rounds0 = batch._fr_fused_schedule(b, n, 100_000)
    vt, work, st = batch._fr_dispatch(costs, True, scale, 1, rounds0)
    st, _, _ = batch._fr_continue(vt, work, st, rounds0, 100_000)
    assert np.array_equal(st.p2o.cpu().numpy(), sol.person_to_object)
    certify_lattice(work, st)
    # the straggler continuation on the card: from a 20-round first chunk
    # (128-round chunks, then the gathered 128-instance bucket) to the
    # same answer as the deep chunk
    vt2, work2, st2 = batch._fr_dispatch(costs, True, scale, 1, 20)
    st2, cont_rounds, _ = batch._fr_continue(vt2, work2, st2, 20,
                                             100_000)
    assert torch.equal(st2.p2o, st.p2o) and torch.equal(st2.nits, st.nits)
    del vt2, work2, st2
    host = costs[:8].cpu().numpy().astype(np.float64)
    for i in range(8):
        r, c = scipy_lsa(host[i])
        assert sol.objective[i] == host[i][r, c].sum(), i
    nits = sol.nits
    emit({"phase": "north_star", "batch": b, "n": n,
          "costs": "integers in [1, 1000), int32 lattice, scale 257",
          "first_call_ms": first_ms, "warm_median_ms": warm_ms,
          "instances_per_s": b / (warm_ms / 1e3),
          "nits_p50": float(np.median(nits)), "nits_max": int(nits.max()),
          "fr_kernel_launches": launches, "certified_optimal": b,
          "scipy_checked": 8, "peak_device_gib": peak_gib,
          "continuation_from_20_rounds_equal": True,
          "continuation_rounds_budgeted": cont_rounds})

    # 4. the kernel at the main path's shape: time, plain time, bound
    del vt, work, st
    vt, work = lattice_values(costs)
    s0 = fr_init(vt, 1)
    rows = torch.zeros(b, dtype=torch.int64, device="cuda")
    cyc = torch.zeros(len(fr_kernel.PHASES), dtype=torch.int64,
                      device="cuda")
    stamps = torch.zeros((b, 2), dtype=torch.int64, device="cuda")
    got, _ = fr_kernel.fr_chunk(vt, s0, rounds0, values=work,
                                bid_rows=rows, phase_cycles=cyc,
                                stamps=stamps)
    bid_rows = int(rows.sum())
    kernel_ms = event_ms(
        lambda: fr_kernel.fr_chunk(vt, s0, rounds0, values=work), reps=5
    )
    counted_ms = event_ms(lambda: fr_kernel.fr_chunk(
        vt, s0, rounds0, values=work, phase_cycles=torch.zeros_like(cyc),
        stamps=torch.zeros_like(stamps)), reps=3)
    split = kernel_split(fr_kernel.PHASES, cyc, stamps, got.nits)
    plain_ms, (want, _) = sync_ms(
        lambda: fr_kernel.fr_chunk_reference(vt, s0, rounds0)
    )
    bad, err = states_equal(got, want)
    assert not bad, ("main-path shape", bad)
    max_err = max(max_err, err)
    elem = vt.element_size()
    state_bytes = 2 * 4 * b * n * 4          # prices, profits, p2o, o2p
    bytes_once = vt.numel() * elem + state_bytes
    ops = 2 * n * bid_rows                   # a subtract and a max each
    bound_bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    row_bytes = bid_rows * n * elem
    row_bound_ms = row_bytes / HBM_BYTES_PER_S * 1e3
    emit({"phase": "kernel_time", "shape": [b, n, n], "dtype": "int32",
          "rounds_budget": rounds0, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes_once": bytes_once, "bid_rows": bid_rows,
          "bidder_row_bytes": row_bytes,
          "bidder_row_bound_ms": row_bound_ms,
          "target_ms": 2 * row_bound_ms,
          "meets_target": kernel_ms <= 2 * row_bound_ms,
          "ms_with_counters": counted_ms, **split,
          "plain_bit_exact": True})
    del vt, work, s0, got, want

    # 4a. the staging kernel at the north star's and the big single's
    # shapes
    stg = phase_stage_kernel_time(stage_mod)

    # 4b. the single-instance dense round (no path calls it): its time,
    # plain time, bound and latency floor, beside its old route
    drst = phase_dense_round_single_time(dr, drs, fr_big)

    # 5. the float path at the slice's largest size (host costs)
    fb, fn = 64, 1024
    rng = np.random.default_rng(SEED)
    fcosts = rng.integers(1, max_cost, size=(fb, fn, fn)).astype(np.float32)
    feps = 1.0 / (fn + 1)
    float_ms, fsol = sync_ms(lambda: port.solve_batch(
        fcosts, eps=feps, integer=False))
    assert int(fsol.num_unassigned.max()) == 0
    gaps = []
    for i in range(4):
        r, c = scipy_lsa(fcosts[i].astype(np.float64))
        gap = float(fsol.objective[i] - fcosts[i][r, c].astype(
            np.float64).sum())
        assert -1e-6 <= gap <= fn * feps + 1e-6, (i, gap)
        gaps.append(gap)
    emit({"phase": "float_1024", "batch": fb, "n": fn, "eps": feps,
          "wall_ms": float_ms, "nits_p50": float(np.median(fsol.nits)),
          "nits_max": int(fsol.nits.max()), "scipy_gaps": gaps,
          "bound": "gap <= n * eps"})
    del fcosts, fsol

    # 6. the streamed solve over three staged north-star batches
    batches = [costs]
    for k in (1, 2):
        gen.manual_seed(SEED + k)
        batches.append(torch.randint(1, max_cost, (b, n, n), generator=gen,
                                     device="cuda",
                                     dtype=torch.int32).float())
    stream_ms, res = sync_ms(lambda: port.solve_batch_stream(
        batches, integer=True, max_cost=max_cost, window=2))
    assert len(res) == 3
    assert all(int(r.num_unassigned.max()) == 0 for r in res)
    assert np.array_equal(res[0].person_to_object, sol.person_to_object)
    emit({"phase": "stream", "batches": 3, "batch": b, "n": n,
          "window": 2, "wall_ms": stream_ms,
          "instances_per_s": 3 * b / (stream_ms / 1e3)})

    del batches, res, costs

    # 7. big dense singles on the cluster kernel
    bdev, beps, big_launches, k8 = phase_big_single(
        port, batch, fr_big, fr_kernel, fr_init, scipy_lsa)
    big = phase_big_kernel_time(batch, fr_big, fr_init, bdev, beps,
                                big_plain, k8)
    del big_plain
    del bdev
    phase_big_batch(port, scipy_lsa)

    # 8. the native straggler tail of the host-costs branch
    phase_native_tail(port, batch, scipy_lsa)

    # 9. the batched sparse mode on the Khosla kernel
    staged, ksp_launches = phase_sparse_stream(port, batch, ksp, scipy_lsa)
    kspt = phase_ksp_kernel_time(batch, ksp, staged)
    del staged
    phase_sparse_host(port, batch, ksp, scipy_lsa)
    phase_sparse_infeasible(port)

    # 9b. the arc route at the reference crate's config B, on the arc
    # Khosla kernel
    arcs = phase_ksp_arcs(port, batch, ka, ksp)

    # 9c. the eps-scaling ladder at the reference crate's config A, on
    # the arc ladder kernel
    ladder = phase_ksp_ladder(port, batch, ka)

    # 10. the forward and Khosla engines and the plain-rounds FR route
    dr_launches = phase_forward_rect(port, batch, dr, scipy_lsa)
    phase_forward_square(port, batch, dr, scipy_lsa)
    phase_khosla_dense(port, scipy_lsa)
    phase_fr_plain_rounds(port, batch, fr_kernel, scipy_lsa)
    drt = phase_dense_chunk_time(dr, forward_init)

    # 11. the reference-crate API and the single sparse device engines:
    # no kernel of the port on this path (the JAX package runs it as
    # plain XLA); every phase reads the six kernels' counts (0)
    mods = (fr_kernel, fr_big, ksp, ka, dr, drs)
    phase_reference_api(port, mods, card)
    phase_khosla_headline(port, mods, card)
    phase_khosla_asym(port, mods, card)
    phase_forward_config_a(port, mods, card)
    phase_batch_sparse_padded(port, mods, card)

    # 12. the sharded modes on a world of one NCCL rank: fr_kernel and
    # ksp_kernel under the batch-sharded entry points
    phase_sharded(port, batch, mods, card, fr_init, scipy_lsa)

    # 13. the in-kernel round trace of the three round kernels
    phase_kernel_trace(port, batch, fr_kernel, fr_big, ksp, fr_init, _build,
                       {"kernel_time_ms": kernel_ms,
                        "big_kernel_time_ms": big["ms"],
                        "ksp_kernel_time_ms": kspt["ms"]})

    # 14. host costs of six types on the three dense solvers
    phase_host_dtypes(port, fr_kernel, dr, scipy_lsa)

    # 15. the run's total and the kernels line
    emit({"phase": "total", "seconds": time.perf_counter() - T_START})
    emit({"kernels": [{
        "name": "fr_kernel",
        "route": "cuda",
        "source": "sparse_linear_assignment_tpu_torch/csrc/fr_kernel.cu",
        "replaces": "sparse_linear_assignment_tpu/ops/pallas_fr.py:398",
        "launches": launches,
        "max_abs_err": max_err,
        "checked_vs_plain": True,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "fr_big_kernel",
        "route": "cuda",
        "source": "sparse_linear_assignment_tpu_torch/csrc/fr_big_kernel.cu",
        "replaces": "sparse_linear_assignment_tpu/ops/pallas_fr_big.py:606",
        "launches": big_launches,
        "max_abs_err": big["max_abs_err"],
        "checked_vs_plain": True,
        "ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"],
        "library_ms": None,
        "cluster": big["cluster"],
        "us_per_round": big["us_per_round"],
        "latency_floor_ms": big["latency_floor_ms"],
        "ms_8192": big["ms_8192"],
        "us_per_round_8192": big["us_per_round_8192"],
    }, {
        "name": "ksp_kernel",
        "route": "cuda",
        "source": "sparse_linear_assignment_tpu_torch/csrc/ksp_kernel.cu",
        "replaces": "sparse_linear_assignment_tpu/ops/pallas_ksparse.py:211",
        "launches": ksp_launches,
        "max_abs_err": kspt["max_abs_err"],
        "checked_vs_plain": True,
        "ms": kspt["ms"],
        "plain_ms": kspt["plain_ms"],
        "bound_ms": kspt["bound_ms"],
        "bound_by": kspt["bound_by"],
        "library_ms": None,
    }, {
        "name": "ksp_arcs_kernel",
        "route": "cuda",
        "source": "sparse_linear_assignment_tpu_torch/csrc/ksp_arcs_kernel.cu",
        "replaces": None,
        "launches": arcs["launches"],
        "max_abs_err": arcs["max_abs_err"],
        "checked_vs_plain": True,
        "ms": arcs["ms"],
        "plain_ms": arcs["plain_ms"],
        "bound_ms": arcs["bound_ms"],
        "bound_by": arcs["bound_by"],
        "library_ms": None,
        "float32_ms": arcs["float32_ms"],
    }, {
        "name": "ksp_arcs_ladder_kernel",
        "route": "cuda",
        "source": "sparse_linear_assignment_tpu_torch/csrc/ksp_arcs_kernel.cu",
        "replaces": None,
        "launches": ladder["launches"],
        "max_abs_err": ladder["max_abs_err"],
        "checked_vs_plain": True,
        "ms": ladder["ms"],
        "ms_on": "the config A cell's batch of 128 instances",
        "plain_ms": ladder["plain_ms"],
        "plain_ms_on": "3 of its instances alone (quickest, median, "
                       "slowest): checked_instances",
        "checked_instances": ladder["checked_instances"],
        "ms_checked_instances": ladder["kernel_ms_checked"],
        "bound_ms": ladder["bound_ms"],
        "bound_by": ladder["bound_by"],
        "library_ms": None,
    }, {
        "name": "dense_round_kernel",
        "route": "cuda",
        "source":
            "sparse_linear_assignment_tpu_torch/csrc/dense_round_kernel.cu",
        "replaces": "sparse_linear_assignment_tpu/ops/pallas_dense.py:191",
        "launches": dr_launches,
        "max_abs_err": max(dr_err, drt["max_abs_err"]),
        "checked_vs_plain": True,
        "ms": drt["ms"],
        "plain_ms": drt["plain_ms"],
        "bound_ms": drt["bound_ms"],
        "bound_by": drt["bound_by"],
        "library_ms": None,
    }, {
        "name": "dense_round_single",
        "route": "cuda",
        "source":
            "sparse_linear_assignment_tpu_torch/csrc/dense_round_single.cu",
        "replaces": "sparse_linear_assignment_tpu/ops/pallas_dense.py:247",
        "launches": single_launches,
        "max_abs_err": max(dr_err, drst["max_abs_err"]),
        "checked_vs_plain": True,
        "ms": drst["ms"],
        "kernel_ms": drst["kernel_ms"],
        "plain_ms": drst["plain_ms"],
        "bound_ms": drst["bound_ms"],
        "bound_by": drst["bound_by"],
        "design_bytes_ms": drst["design_bytes_ms"],
        "latency_floor_ms": drst["latency_floor_ms"],
        "library_ms": None,
    }, {
        "name": "stage_kernel",
        "route": "cuda",
        "source": "sparse_linear_assignment_tpu_torch/csrc/stage_kernel.cu",
        "replaces": None,
        "launches": stage_launches,
        "max_abs_err": 0.0,
        "checked_vs_plain": True,
        "ms": stg["b4096_n256"]["ms"],
        "plain_ms": stg["b4096_n256"]["plain_ms"],
        "bound_ms": stg["b4096_n256"]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_4096": stg["b1_n4096"]["ms"],
        "plain_ms_4096": stg["b1_n4096"]["plain_ms"],
        "bound_ms_4096": stg["b1_n4096"]["bound_ms"],
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
