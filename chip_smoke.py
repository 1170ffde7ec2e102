#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Builds the CUDA kernels from
``sparse_linear_assignment_tpu_torch/csrc`` with ``nvcc`` (first use),
holds every kernel against its plain PyTorch version on the card, drives
the port's main path (batched dense assignment through the
forward-reverse auction) at the north-star size, 4096 instances of
256x256 with integer costs in [1, 1000) on the int32 lattice, and
checks the answers: full matchings, a dual certificate of exact
optimality for every instance, and scipy's objective on a sample.
Every phase prints one JSON line; any failure raises and exits non-zero.
The last line is ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present, or when
the port's package is not beside this script.
"""

from __future__ import annotations

import json
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

    from sparse_linear_assignment_tpu_torch import batch
    from sparse_linear_assignment_tpu_torch.ops import _build, fr_kernel
    from sparse_linear_assignment_tpu_torch.ops.fr_dense import fr_init

    # 1. the card and the build
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    fr_kernel._kernel_lib()
    build_s = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.BUILD_LOG.get("fr_kernel", "")
            .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "card", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "ptxas": regs})

    # 2. kernel vs plain version on the card
    max_err = phase_kernel_vs_plain(fr_kernel, fr_init)

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
    st, _ = batch._fr_continue(vt, work, st, rounds0, 100_000)
    assert np.array_equal(st.p2o.cpu().numpy(), sol.person_to_object)
    certify_lattice(work, st)
    # the straggler continuation on the card: from a 20-round first chunk
    # (128-round chunks, then the gathered 128-instance bucket) to the
    # same answer as the deep chunk
    vt2, work2, st2 = batch._fr_dispatch(costs, True, scale, 1, 20)
    st2, cont_rounds = batch._fr_continue(vt2, work2, st2, 20, 100_000)
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

    # 7. the kernels line
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
    }]})
    emit({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
