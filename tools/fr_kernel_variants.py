#!/usr/bin/env python3
"""The batched FR kernel at other launch shapes, on one card.

    python3 tools/fr_kernel_variants.py

Run from the root of a checkout on a machine with one CUDA GPU.  Builds
``csrc/fr_kernel.cu`` as it is (128 threads, 12 CTAs an SM, one bidder a
warp) and copies of it at other shapes, all at once, holds each against
the plain version on ``chip_smoke.py``'s fourteen cases, then times one
launch of each at the north-star shape (4096 × 256² int32 from
``fr_init``, the fused route's round budget) in the order of ``ORDER``,
which runs the shipped shape first and last so that a drift of the card
shows.  Every run must equal the first bit for bit.  Prints the card
line, then one JSON line per build (its ``ptxas`` register and spill
lines) and per run: CUDA-event ms (median of 5), the leader thread's
cycles a round and their split by phase, and the CTA timeline (span,
last start, half ended, the slowest instance's start and end).
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sparse_linear_assignment_tpu_torch import batch  # noqa: E402
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    _build,
    fr_kernel,
)
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (  # noqa: E402
    fr_init,
)

#: name: the constants of csrc/fr_kernel.cu it sets (none: as shipped)
VARIANTS = {
    "128x12": {},
    "256x8": {"kMaxThreads": 256, "kBlocksPerSm": 8, "kIndicesPerThread": 1},
    "128x16": {"kBlocksPerSm": 16},
    "96x14": {"kMaxThreads": 96, "kBlocksPerSm": 14, "kIndicesPerThread": 3},
    "64x15": {"kMaxThreads": 64, "kBlocksPerSm": 15, "kIndicesPerThread": 4},
    "128x12_2bidders": {"kBidders": 2},
}
ORDER = ("128x12", "256x8", "128x16", "96x14", "64x15", "128x12_2bidders",
         "256x8", "128x12")


def start_builds() -> dict:
    """Start one nvcc a variant, all at once, beside the package's build."""
    src = (_build.CSRC / "fr_kernel.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, consts in VARIANTS.items():
        text = src
        for const, value in consts.items():
            text, hits = re.subn(rf"constexpr int {const} = \d+;",
                                 f"constexpr int {const} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"fr_kernel.cu no longer sets {const}")
        cu = _build.BUILD_DIR / f"fr_kernel_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(so), str(cu)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    return jobs


def finish_build(name: str, so: Path, job) -> ctypes.CDLL:
    out, _ = job.communicate()
    print(json.dumps({"variant": name, "consts": VARIANTS[name],
                      "ptxas": [ln.strip() for ln in out.splitlines()
                                if "registers" in ln or "spill" in ln]}),
          flush=True)
    if job.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-3000:]}")
    lib = ctypes.CDLL(str(so))
    ref = fr_kernel._kernel_lib()
    for fn in ("slap_fr_rounds", "slap_cuda_error_string"):
        getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        getattr(lib, fn).restype = getattr(ref, fn).restype
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("fr_kernel_variants: needs one CUDA GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    jobs = start_builds()
    libs = {name: finish_build(name, so, job)
            for name, (so, job) in jobs.items()}
    b, n = 4096, 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    costs = torch.randint(1, 1000, (b, n, n), generator=gen, device="cuda",
                          dtype=torch.int32).float()
    vt, work = cs.lattice_values(costs)
    s0 = fr_init(vt, 1)
    rounds = batch._fr_fused_schedule(b, n, 100_000)
    first = None
    shipped = fr_kernel._lib
    try:
        for name in ORDER:
            fr_kernel._lib = libs[name]
            cs.phase_kernel_vs_plain(fr_kernel, fr_init)
            cyc = torch.zeros(len(fr_kernel.PHASES), dtype=torch.int64,
                              device="cuda")
            stamps = torch.zeros((b, 2), dtype=torch.int64, device="cuda")
            got, _ = fr_kernel.fr_chunk(vt, s0, rounds, values=work,
                                        phase_cycles=cyc, stamps=stamps)
            if first is None:
                first = got
            bad, _ = cs.states_equal(got, first)
            assert not bad, (name, bad)
            ms = cs.event_ms(lambda: fr_kernel.fr_chunk(
                vt, s0, rounds, values=work), reps=5)
            split = cs.kernel_split(fr_kernel.PHASES, cyc, stamps,
                                    got.nits)
            print(json.dumps({"variant": name, "ms": ms,
                              "cycle_share": split["cycle_share"],
                              "cycles_per_round": split["cycles_per_round"],
                              "timeline_ms": split["timeline_ms"]}),
                  flush=True)
    finally:
        fr_kernel._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
