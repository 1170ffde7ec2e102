#!/usr/bin/env python3
"""The three round kernels against an older build of themselves, with
the round trace off, on one card.

    python3 tools/kernel_ab.py OLD_CSRC_DIR

Run from the root of a checkout on a machine with one CUDA GPU.
``OLD_CSRC_DIR`` is an older checkout's ``csrc/`` whose kernels take no
round-log pointer (``git archive`` of the parent commit, unpacked).
Builds its ``fr_kernel.cu``, ``fr_big_kernel.cu`` and ``ksp_kernel.cu``
with the package's flags, all at once, and runs them behind this
checkout's wrappers (the log argument, null with the trace off, is
dropped from each call).  Each kernel runs at ``chip_smoke.py``'s
shapes: the north-star chunk (4096 x 256² int32 from ``fr_init``, the
fused route's budget), the 4096² big single from ``fr_init`` to done,
one sparse-stream batch (4096 x 128 x 512, k = 8) for the kernel
route's 64 rounds.  Every result must equal the first bit for bit.
Prints the card line, then one JSON line a kernel: CUDA-event ms
(median of 5 each) in turns old, new, new, old.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import sparse_linear_assignment_tpu_torch as port  # noqa: E402
from sparse_linear_assignment_tpu_torch import batch  # noqa: E402
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    _build,
    fr_big,
    fr_kernel,
)
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    ksparse_kernel as ksp,
)
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (  # noqa: E402
    fr_init,
)

#: kernel: (wrapper module, C entry point, its error-string function,
#: the position of the round-log argument in the current interface)
KERNELS = {
    "fr_kernel": (fr_kernel, "slap_fr_rounds", "slap_cuda_error_string",
                  12),
    "fr_big_kernel": (fr_big, "slap_fr_big_rounds",
                      "slap_cuda_error_string", 10),
    "ksp_kernel": (ksp, "slap_ksp_rounds", "slap_ksp_error_string", 9),
}


def build_old(csrc: Path) -> dict:
    """The older sources' libraries, one ``nvcc`` each, all at once."""
    out_dir = _build.BUILD_DIR / "ab_old"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in KERNELS:
        so = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(so), str(csrc / f"{name}.cu")]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, job) in jobs.items():
        out, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on the old {name}:\n{out}")
        libs[name] = older(name, ctypes.CDLL(str(so)))
    return libs


def older(name: str, lib: ctypes.CDLL):
    """``lib`` behind the current wrapper: the same calls without the
    round-log argument, which must be null."""
    mod, entry, error, at = KERNELS[name]
    new = mod._kernel_lib()
    fn = getattr(lib, entry)
    fn.argtypes = [t for i, t in enumerate(getattr(new, entry).argtypes)
                   if i != at]
    fn.restype = ctypes.c_int
    err = getattr(lib, error)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p

    def call(*args):
        if args[at] is not None:
            raise ValueError("the older kernel has no round log")
        return fn(*(args[:at] + args[at + 1:]))

    return types.SimpleNamespace(**{entry: call, error: err})


def cases():
    """name: (run, equal) at chip_smoke.py's shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    costs = torch.randint(1, 1000, (4096, 256, 256), generator=gen,
                          device="cuda", dtype=torch.int32).float()
    vt, work = cs.lattice_values(costs)
    s0 = fr_init(vt, 1)
    rounds = batch._fr_fused_schedule(4096, 256, 100_000)

    rng = np.random.default_rng(cs.SEED)
    dev = torch.from_numpy(rng.integers(1, 1000, size=(1, 4096, 4096))
                           .astype(np.float32)).cuda()
    bvt, bwork = batch._stage(dev, True, None)
    b0 = fr_init(bvt, 1.0 / 4097)

    gen.manual_seed(cs.SEED + 100)
    cols, vals = cs.device_arcs(gen, 4096, 128, 512, 8, 300, 1000)
    st = port.stage_batch_sparse_device(cols, vals, 512, eps=1.0 / 512)
    plane, thr = st.values_nm, st.thresholds
    eps = np.float32(st.eps_val)
    k0 = ksp.khosla_init(plane)

    def fr_equal(a, b):
        return not cs.states_equal(a[0], b[0])[0]

    return {
        "fr_kernel": (lambda: fr_kernel.fr_chunk(vt, s0, rounds,
                                                 values=work), fr_equal),
        "fr_big_kernel": (lambda: fr_big.fr_big_chunk(
            bvt, b0, 100_000, values=bwork), fr_equal),
        "ksp_kernel": (lambda: ksp.ksp_chunk(
            plane, k0, eps, thr, batch._SPARSE_KERNEL_BUDGET),
            lambda a, b: not cs.ksp_states_equal(a, b)),
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs one CUDA GPU", file=sys.stderr)
        return 2
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    _build.build_all()
    old = build_old(Path(argv[0]).resolve())
    for name, (run, equal) in cases().items():
        mod = KERNELS[name][0]
        new = mod._kernel_lib()
        times = {"old": [], "new": []}
        first = None
        try:
            for which in ("old", "new", "new", "old"):
                mod._lib = old[name] if which == "old" else new
                got = run()
                if first is None:
                    first = got
                assert equal(got, first), (name, which, "differs")
                times[which].append(cs.event_ms(run, reps=5))
        finally:
            mod._lib = new
        print(json.dumps({"kernel": name, "trace": "off",
                          "old_ms": times["old"], "new_ms": times["new"],
                          "bit_equal": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
