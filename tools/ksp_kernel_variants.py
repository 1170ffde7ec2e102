#!/usr/bin/env python3
"""The batched-sparse Khosla kernel's designs and launch shapes, on one card.

    python3 tools/ksp_kernel_variants.py [VARIANT ...]

Run from the root of a checkout on a machine with one CUDA GPU.  Builds
``csrc/ksp_kernel.cu`` as it is, copies of it at other launch shapes and
the first port's design (``tools/ksp_kernel_three_pass.cu``: one warp a
row in 4-byte loads, three passes over the instance a round), all at
once.
Holds each against the plain version on ``chip_smoke.py``'s sparse
cases, then times one launch of each at the main path's shape (4096 x
(128 x 512, k = 8) float32 staged on the card from ``khosla_init``, the
sparse solve's 64-round budget) in the order of ``ORDER``, which runs
the shipped build first and last so that a drift of the card shows.
Every run is bit-equal to the plain version.  Prints the card line,
then one JSON line per build (its ``ptxas`` register and spill lines)
and per run: CUDA-event ms (median of 5), the leader thread's cycles a
round and their split by phase, and the CTA timeline (span, last start,
half ended, the slowest instance's start and end).  Names given on the
command line keep only those variants, in ``ORDER``'s order.
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
import sparse_linear_assignment_tpu_torch as port  # noqa: E402
from sparse_linear_assignment_tpu_torch import batch  # noqa: E402
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    _build,
)
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    ksparse_kernel as ksp,
)

SHIPPED = _build.CSRC / "ksp_kernel.cu"
THREE_PASS = ROOT / "tools" / "ksp_kernel_three_pass.cu"

#: name: (source, the constants of it that the build sets); the shipped
#: build is 128 threads x 8 CTAs an SM with 4 loads a lane in flight
VARIANTS = {
    "128x8": (SHIPPED, {}),
    "three_pass": (THREE_PASS, {}),
    "128x12": (SHIPPED, {"kBlocksPerSm": 12}),
    "128x10": (SHIPPED, {"kBlocksPerSm": 10}),
    "256x4": (SHIPPED, {"kThreads": 256, "kBlocksPerSm": 4}),
    "128x8_2loads": (SHIPPED, {"kLoadsInFlight": 2}),
}
ORDER = ("128x8", "three_pass", "128x12", "128x10", "256x4",
         "128x8_2loads", "three_pass", "128x8")


def start_builds(names) -> dict:
    """Start one nvcc a variant, all at once, beside the package's build."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src, consts = VARIANTS[name]
        text = src.read_text()
        for const, value in consts.items():
            text, hits = re.subn(rf"constexpr int {const} = \d+;",
                                 f"constexpr int {const} = {value};", text)
            if hits != 1:
                raise RuntimeError(f"{src.name} no longer sets {const}")
        cu = _build.BUILD_DIR / f"ksp_kernel_{name}.cu"
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
    src, consts = VARIANTS[name]
    print(json.dumps({"variant": name, "source": str(src.relative_to(ROOT)),
                      "consts": consts,
                      "ptxas": [ln.strip() for ln in out.splitlines()
                                if "registers" in ln or "spill" in ln]}),
          flush=True)
    if job.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-3000:]}")
    return ksp.bind(ctypes.CDLL(str(so)))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("ksp_kernel_variants: needs one CUDA GPU", file=sys.stderr)
        return 2
    unknown = set(argv) - set(VARIANTS)
    if unknown:
        print(f"ksp_kernel_variants: no variant {sorted(unknown)}; "
              f"the variants are {list(VARIANTS)}", file=sys.stderr)
        return 2
    order = [name for name in ORDER if not argv or name in argv]
    print(cs.card_line(), flush=True)
    jobs = start_builds(dict.fromkeys(order))
    libs = {name: finish_build(name, so, job)
            for name, (so, job) in jobs.items()}
    b, n, m, k = 4096, 128, 512, 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 100)  # phase_sparse_stream's first batch
    cols, vals = cs.device_arcs(gen, b, n, m, k, 300, 1000)
    staged = [port.stage_batch_sparse_device(cols, vals, m, eps=1.0 / m)]
    shipped = ksp._lib
    checked = set()
    try:
        for name in order:
            ksp._lib = libs[name]
            print(json.dumps({"variant": name}), flush=True)
            if name not in checked:
                cs.phase_ksp_kernel_vs_plain(port, batch, ksp)
                checked.add(name)
            cs.phase_ksp_kernel_time(batch, ksp, staged)
    finally:
        ksp._lib = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
