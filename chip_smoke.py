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
- big dense singles on the multi-CTA kernel: one 4096x4096 instance
  (scipy's objective) and one 8192x8192 instance made on the card (a
  float64 price certificate);
- the native straggler tail of the host-costs branch (scipy's
  objectives).

Every phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present, or when
the port's package is not beside this script.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 20261016

#: H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(obj) -> None:
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
    return batch._stage(costs, negate, n + 1)


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


def phase_breakdown(batch, fr_kernel, fr_init, costs, scale, rounds,
                    warm_ms):
    """Where the wall time of one warm north-star solve goes: each step
    of the device-resident solve timed on its own (median of 3, each
    ended by a device sync)."""
    from sparse_linear_assignment_tpu_torch.solution import (
        UNASSIGNED,
        o2p_from_p2o,
    )

    n = costs.shape[1]
    t = {}
    t["stage_ms"], (vt, work) = sync_ms(
        lambda: batch._stage(costs, True, scale), reps=3)
    t["init_ms"], s0 = sync_ms(lambda: fr_init(vt, 1), reps=3)
    t["kernel_ms"], (st, _) = sync_ms(
        lambda: fr_kernel.fr_chunk(vt, s0, rounds, values=work), reps=3)
    t["done_check_ms"], _ = sync_ms(lambda: int((~st.done).sum()), reps=3)
    t["readback_ms"], p2o = sync_ms(
        lambda: (st.p2o.cpu().numpy(), st.nits.cpu().numpy())[0], reps=3)
    t["objective_ms"], _ = sync_ms(
        lambda: batch._device_objective(work, st.p2o, True).cpu(), reps=3)
    t["host_post_ms"], _ = sync_ms(
        lambda: (o2p_from_p2o(p2o, n), (p2o == UNASSIGNED).sum(axis=1)),
        reps=3)
    total = sum(t.values())
    emit({"phase": "breakdown", **t, "sum_ms": total,
          "warm_wall_ms": warm_ms,
          "kernel_share_of_sum": t["kernel_ms"] / total})


def phase_big_kernel_vs_plain(fr_big, fr_init):
    """The multi-CTA kernel against its plain version, bit for bit, on
    every FRState field and the bidder-row counts, after 7, 40 and 400
    rounds and at done."""
    gen = torch.Generator(device="cuda")
    cases = []
    for n, hi in ((2048, 1000), (2048, 8), (1152, 1000)):
        gen.manual_seed(SEED + n + hi)
        costs = torch.randint(1, hi, (1, n, n), generator=gen,
                              device="cuda", dtype=torch.int32).float()
        work = (-costs).contiguous()
        vt = work.transpose(1, 2).contiguous()
        got = want = fr_init(vt, 1.0 / (n + 1))
        rows_k = torch.zeros(1, dtype=torch.int64, device="cuda")
        rows_p = torch.zeros(1, dtype=torch.int64, device="cuda")
        total = 0
        for chunk in [7, 33, 360] + [4000] * 25:
            got, _ = fr_big.fr_big_chunk(vt, got, chunk, values=work,
                                         bid_rows=rows_k)
            want, _ = fr_big.fr_big_chunk_reference(vt, want, chunk,
                                                    bid_rows=rows_p)
            total += chunk
            bad, _ = states_equal(got, want)
            if not torch.equal(rows_k, rows_p):
                bad.append("bid_rows")
            assert not bad, (n, hi, total, bad)
            if bool(got.done[0]):
                break
        assert bool(got.done[0]), (n, hi, "not done", total)
        cases.append({"n": n, "costs_hi": hi, "nits": int(got.nits[0]),
                      "bid_rows": int(rows_k[0])})
    emit({"phase": "big_kernel_vs_plain", "kernel": "fr_big_kernel",
          "checkpoints": "after 7, 40, 400 rounds, then every 4000 to "
                         "done", "cases": cases, "tolerance": 0,
          "max_abs_err": 0.0,
          "fields": "all FRState fields + bid_rows, bit-exact"})


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
    # the same deterministic solve through the kernel, for its prices
    vt8, work8 = batch._stage(c8, True, None)
    st = fr_init(vt8, eps8)
    while not bool(st.done[0]):
        st, _ = fr_big.fr_big_chunk(vt8, st, 2 * n8, values=work8)
    assert np.array_equal(st.p2o.cpu().numpy(), sol8.person_to_object)
    slack = 1e-3
    worst = certify_prices(work8, st, eps8, slack)
    emit({"phase": "big_single_8192", "n": n8,
          "costs": "integers in [1, 1000) made on the card",
          "eps": eps8, "wall_ms": wall8, "nits": int(sol8.nits[0]),
          "rounds_per_s": int(sol8.nits[0]) / (wall8 / 1e3),
          "objective": float(sol8.objective[0]),
          "certificate": "f64 chosen profit >= row max - eps - slack",
          "slack": slack, "worst_shortfall": worst})
    del c8, vt8, work8, st
    return costs, dev, eps, launches, warm_ms


def phase_big_breakdown(batch, fr_init, costs, dev, eps, warm_ms):
    """Where the wall of one warm 4096² big-single solve goes: each step
    timed on its own (median of 3, each ended by a device sync)."""
    from sparse_linear_assignment_tpu_torch.solution import o2p_from_p2o

    n = costs.shape[1]
    stage_ms, _ = sync_ms(lambda: batch._stage(dev, True, None), reps=3)
    t = {}
    t["solve_ms"], (p2o_dev, _, _) = sync_ms(
        lambda: batch._fr_big_solve(dev, True, eps, 100_000), reps=3)
    t["readback_ms"], p2o = sync_ms(lambda: p2o_dev.cpu().numpy(), reps=3)
    t["host_objective_ms"], _ = sync_ms(lambda: np.take_along_axis(
        costs, p2o[:, :, None], axis=2).sum(), reps=3)
    t["host_post_ms"], _ = sync_ms(lambda: o2p_from_p2o(p2o, n), reps=3)
    total = sum(t.values())
    emit({"phase": "big_breakdown", "n": n, **t, "sum_ms": total,
          "stage_ms": stage_ms, "warm_wall_ms": warm_ms,
          "solve_share_of_sum": t["solve_ms"] / total,
          "note": "solve_ms holds the staging (stage_ms, timed alone "
                  "too), fr_init, the kernel chunks and the per-chunk "
                  "done readback"})


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


def phase_big_kernel_time(batch, fr_big, fr_init, dev, eps):
    """The 4096² solve's kernel alone: CUDA-event time of one launch
    from the initial state to done, the plain version on the same
    input for the same rounds, and the bound."""
    n = dev.shape[1]
    vt, work = batch._stage(dev, True, None)
    s0 = fr_init(vt, eps)
    budget = 100_000
    rows = torch.zeros(1, dtype=torch.int64, device="cuda")
    got, done = fr_big.fr_big_chunk(vt, s0, budget, values=work,
                                    bid_rows=rows)
    assert bool(done)
    nits, bid_rows = int(got.nits[0]), int(rows[0])
    kernel_ms = event_ms(
        lambda: fr_big.fr_big_chunk(vt, s0, budget, values=work), reps=5)
    plain_ms, (want, _) = sync_ms(
        lambda: fr_big.fr_big_chunk_reference(vt, s0, nits))
    bad, err = states_equal(got, want)
    assert not bad, ("big kernel at 4096²", bad)
    elem = vt.element_size()
    state_bytes = 2 * 4 * n * 4              # prices, profits, p2o, o2p
    bytes_once = n * n * elem + state_bytes  # one layout + the state
    ops = 2 * n * bid_rows                   # a subtract and a max each
    bound_bytes_ms = bytes_once / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    row_bytes = bid_rows * n * elem
    emit({"phase": "big_kernel_time", "n": n, "dtype": "float32",
          "nits": nits, "ms": kernel_ms, "us_per_round": kernel_ms * 1e3 /
          nits, "plain_ms": plain_ms, "plain_rounds": nits,
          "plain_ms_per_round": plain_ms / nits, "bound_ms": bound_ms,
          "bound_by": bound_by, "bytes_once": bytes_once,
          "bid_rows": bid_rows, "bidder_row_bytes": row_bytes,
          "bidder_row_bound_ms": row_bytes / HBM_BYTES_PER_S * 1e3,
          "library_ms": None, "plain_bit_exact": True})
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


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
    from sparse_linear_assignment_tpu_torch.ops.fr_dense import fr_init

    # 1. the card and the build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    fr_kernel._kernel_lib()
    fr_big._kernel_lib()
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
    phase_big_kernel_vs_plain(fr_big, fr_init)

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
    first_ms, sol = sync_ms(solve)
    launches = fr_kernel.LAUNCHES
    assert launches > 0, "the main path launched no FR kernel"
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
    phase_breakdown(batch, fr_kernel, fr_init, costs, scale, rounds0,
                    warm_ms)

    # 4. the kernel at the main path's shape: time, plain time, bound
    del vt, work, st
    vt, work = lattice_values(costs)
    s0 = fr_init(vt, 1)
    rows = torch.zeros(b, dtype=torch.int64, device="cuda")
    got, _ = fr_kernel.fr_chunk(vt, s0, rounds0, values=work,
                                bid_rows=rows)
    bid_rows = int(rows.sum())
    kernel_ms = event_ms(
        lambda: fr_kernel.fr_chunk(vt, s0, rounds0, values=work), reps=5
    )
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
    emit({"phase": "kernel_time", "shape": [b, n, n], "dtype": "int32",
          "rounds_budget": rounds0, "ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": bound_ms, "bound_by": bound_by,
          "bytes_once": bytes_once, "bid_rows": bid_rows,
          "bidder_row_bytes": row_bytes,
          "bidder_row_bound_ms": row_bytes / HBM_BYTES_PER_S * 1e3,
          "plain_bit_exact": True})
    del vt, work, s0, got, want

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

    # 7. big dense singles on the multi-CTA kernel
    bcosts, bdev, beps, big_launches, big_warm_ms = phase_big_single(
        port, batch, fr_big, fr_kernel, fr_init, scipy_lsa)
    phase_big_breakdown(batch, fr_init, bcosts, bdev, beps, big_warm_ms)
    big = phase_big_kernel_time(batch, fr_big, fr_init, bdev, beps)
    del bcosts, bdev
    phase_big_batch(port, scipy_lsa)

    # 8. the native straggler tail of the host-costs branch
    phase_native_tail(port, batch, scipy_lsa)

    # 9. the kernels line
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
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
