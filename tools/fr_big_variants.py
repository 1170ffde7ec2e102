#!/usr/bin/env python3
"""The cluster big-single kernel at other launch shapes, on one card.

    python3 tools/fr_big_variants.py

Run from the root of a checkout on a machine with one CUDA GPU.  Builds
``csrc/fr_big_kernel.cu`` as it is (512 threads a CTA) and a copy at 256
threads a CTA, then times one launch from ``fr_init`` to done on the
4096² and 8192² instances of ``chip_smoke.py`` for each thread count at
cluster sizes 16 and 8, in the order 512, 256, 256, 512 so that a drift
of the card shows.  Every run must equal the first bit for bit.  Prints
the card line, then one JSON line per run: CUDA-event ms, µs a round,
the kernel's phase split and the share of rounds with more than 1,024
bidders.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sparse_linear_assignment_tpu_torch import batch  # noqa: E402
from sparse_linear_assignment_tpu_torch.ops import _build, fr_big  # noqa: E402
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (  # noqa: E402
    fr_init,
)


def thread_variant(threads: int) -> ctypes.CDLL:
    """The kernel's source at ``threads`` threads a CTA, built beside the
    package's own build."""
    src = (_build.CSRC / "fr_big_kernel.cu").read_text()
    line = "constexpr int kThreads = 512;"
    if line not in src:
        raise RuntimeError("fr_big_kernel.cu no longer sets kThreads = 512")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"fr_big_kernel_{threads}.cu"
    cu.write_text(src.replace(line, f"constexpr int kThreads = {threads};"))
    so = cu.with_suffix(".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    ref = fr_big._kernel_lib()
    for name in ("slap_fr_big_rounds", "slap_cuda_error_string"):
        getattr(lib, name).argtypes = getattr(ref, name).argtypes
        getattr(lib, name).restype = getattr(ref, name).restype
    return lib


def instances():
    """The 4096² and 8192² instances of chip_smoke.py, staged."""
    rng = np.random.default_rng(cs.SEED)
    c4 = torch.from_numpy(rng.integers(1, 1000, size=(1, 4096, 4096))
                          .astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED + 8192)
    c8 = torch.randint(1, 1000, (1, 8192, 8192), generator=gen,
                       device="cuda", dtype=torch.int32).float()
    return {n: batch._stage(c, True, None) for n, c in ((4096, c4),
                                                         (8192, c8))}


def main() -> int:
    if not torch.cuda.is_available():
        print("fr_big_variants: needs one CUDA GPU", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    libs = {512: fr_big._kernel_lib(), 256: thread_variant(256)}
    plan = fr_big.plan
    staged = instances()
    first = {}
    try:
        for threads in (512, 256, 256, 512):
            for cluster in (16, 8):
                fr_big._lib = libs[threads]
                fr_big.plan = (lambda S, c=cluster: plan(S, max_cluster=c))
                for n, (vt, work) in staged.items():
                    s0 = fr_init(vt, 1.0 / (n + 1))
                    cyc = torch.zeros(len(fr_big.PHASES), dtype=torch.int64,
                                      device="cuda")
                    got, done = fr_big.fr_big_chunk(
                        vt, s0, 100_000, values=work, phase_cycles=cyc)
                    assert bool(done), (threads, cluster, n)
                    bad = cs.states_equal(got, first.setdefault(n, got))[0]
                    assert not bad, (threads, cluster, n, bad)
                    ms = cs.event_ms(lambda: fr_big.fr_big_chunk(
                        vt, s0, 100_000, values=work), reps=3)
                    nits = int(got.nits[0])
                    split = cs.cycle_split(fr_big, cyc)
                    print(json.dumps({
                        "threads": threads, "cluster": cluster, "n": n,
                        "ms": ms, "us_per_round": ms * 1e3 / nits,
                        "nits": nits, "equal_to_first": True,
                        "cycle_share": split["cycle_share"],
                        "wide_share": split["wide_share"]}), flush=True)
    finally:
        fr_big._lib, fr_big.plan = libs[512], plan
    return 0


if __name__ == "__main__":
    sys.exit(main())
