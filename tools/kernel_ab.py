#!/usr/bin/env python3
"""The three round kernels against an older build of themselves, with
the round trace off, and the single-instance dense round against the
route it took before its own kernel, on one card.

    python3 tools/kernel_ab.py OLD_CSRC_DIR

Run from the root of a checkout on a machine with one CUDA GPU.
``OLD_CSRC_DIR`` is an older checkout's ``csrc/`` whose kernels have
this checkout's C interface (``git archive`` of the parent commit,
unpacked).  Builds its ``fr_kernel.cu``, ``fr_big_kernel.cu`` and
``ksp_kernel.cu`` with the package's flags, all at once, and runs them
behind this checkout's wrappers.  Each kernel runs at ``chip_smoke.py``'s
shapes: the north-star chunk (4096 x 256² int32 from ``fr_init``, the
fused route's budget), the 4096² big single from ``fr_init`` to done,
one sparse-stream batch (4096 x 128 x 512, k = 8) for the kernel
route's 64 rounds.  Every result must equal the first bit for bit.
Prints the card line, then one JSON line a kernel: CUDA-event ms
(median of 5 each) in turns old, new, new, old.

Then ``fused_dense_round`` (``csrc/dense_round_single.cu``, one
cooperative launch) against the route it had before that kernel, the
batch entry's single-round mode of ``dense_round_kernel.cu`` at B = 1
(``chip_smoke.old_route_fused_dense_round``; ``OLD_CSRC_DIR`` must hold
the same ``dense_round_kernel.cu`` and no ``dense_round_single.cu``),
and against the same phases as three stream-ordered launches
(``tools/dense_round_single_stream.cu``, built here), at
``chip_smoke.py``'s three shapes in its opening and late states: one
JSON line a shape and state with each route's call ms (events around
the call, median of ``chip_smoke.CALL_REPS``) and kernel ms (events
around the launches alone, median of 5; the old route's on a plane
transposed beforehand, its transpose copy timed alone beside it), in
turns old, new, stream, stream, new, old, every result bit-equal to the
first.
"""

from __future__ import annotations

import ctypes
import functools
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
    dense_round as dr,
)
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    dense_round_single as drs,
)
from sparse_linear_assignment_tpu_torch.ops import (  # noqa: E402
    ksparse_kernel as ksp,
)
from sparse_linear_assignment_tpu_torch.ops.fr_dense import (  # noqa: E402
    fr_init,
)

#: kernel: (wrapper module, C entry point, its error-string function)
KERNELS = {
    "fr_kernel": (fr_kernel, "slap_fr_rounds", "slap_cuda_error_string"),
    "fr_big_kernel": (fr_big, "slap_fr_big_rounds",
                      "slap_cuda_error_string"),
    "ksp_kernel": (ksp, "slap_ksp_rounds", "slap_ksp_error_string"),
}


#: the single round's three stream-ordered launches
STREAM_CU = ROOT / "tools" / "dense_round_single_stream.cu"


def build_old(csrc: Path) -> dict:
    """The older sources' libraries and the single round's stream form
    (key ``"stream"``), one ``nvcc`` each, all at once."""
    out_dir = _build.BUILD_DIR / "ab_old"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {name: (csrc, csrc / f"{name}.cu") for name in KERNELS}
    sources["stream"] = (_build.CSRC, STREAM_CU)
    jobs = {}
    for name, (include, src) in sources.items():
        so = out_dir / f"{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include),
               "-o", str(so), str(src)]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (so, job) in jobs.items():
        out, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {sources[name][1]}:\n{out}")
        lib = ctypes.CDLL(str(so))
        libs[name] = stream_form(lib) if name == "stream" else older(name,
                                                                      lib)
    return libs


def stream_form(lib: ctypes.CDLL):
    """The stream form behind ``dense_round_single``'s wrapper: its entry
    point bound as the shipped one, with the same argument types."""
    new = drs._kernel_lib()
    fn = lib.slap_dense_round_single_stream
    fn.argtypes = new.slap_dense_round_single.argtypes
    fn.restype = ctypes.c_int
    err = lib.slap_dense_round_single_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return types.SimpleNamespace(slap_dense_round_single=fn,
                                 slap_dense_round_single_error_string=err)


def older(name: str, lib: ctypes.CDLL):
    """``lib`` behind the current wrapper: its entry point and error
    strings bound with the current library's argument types."""
    mod, entry, error = KERNELS[name]
    new = mod._kernel_lib()
    fn = getattr(lib, entry)
    fn.argtypes = getattr(new, entry).argtypes
    fn.restype = ctypes.c_int
    err = getattr(lib, error)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return types.SimpleNamespace(**{entry: fn, error: err})


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


def single_round_pairs(old_csrc: Path, stream_lib) -> None:
    """The single-instance round against its old route and its stream
    form, in turns, at chip_smoke.py's shapes and states."""
    name = "dense_round_kernel.cu"
    if (old_csrc / name).read_bytes() != (_build.CSRC / name).read_bytes():
        raise ValueError(f"the older {name} differs: the old route would "
                         f"not be the older checkout's")
    if (old_csrc / "dense_round_single.cu").exists():
        raise ValueError("the older checkout has the single-round kernel")
    new_lib = drs._kernel_lib()
    libs = {"new": new_lib, "stream": stream_lib}

    def old_route(*a, vals_nm=None):
        return cs.old_route_fused_dense_round(dr, *a, vals_nm=vals_nm)

    for m, n in cs.SINGLE_SHAPES:
        vt, states = cs.single_round_states(drs, m, n)
        vnm = vt.t().contiguous()[None]
        for state, (prices, p2o, o2p, rounds) in states.items():
            args = (vt, prices, p2o, o2p, cs.SINGLE_EPS, False)
            first = None
            times = {k: {"call_ms": [], "kernel_ms": []}
                     for k in ("old", "new", "stream")}
            times["old"]["copy_ms"] = []
            try:
                for which in ("old", "new", "stream", "stream", "new",
                              "old"):
                    if which == "old":
                        mod, call = dr, old_route
                        kernel = functools.partial(old_route, *args,
                                                   vals_nm=vnm)
                    else:
                        drs._lib = libs[which]
                        mod, call = drs, drs.fused_dense_round
                        kernel = functools.partial(call, *args)
                    for got in (call(*args), kernel()):
                        torch.cuda.synchronize()
                        if first is None:
                            first = got
                        assert not cs.round_outputs_differ(got, first), (
                            m, n, state, which)
                    times[which]["call_ms"].append(
                        cs.event_ms(lambda: call(*args), reps=cs.CALL_REPS))
                    times[which]["kernel_ms"].append(
                        cs.launch_ms(mod, kernel))
                    if which == "old":
                        times["old"]["copy_ms"].append(cs.queued_ms(
                            lambda: vt[None].transpose(1, 2).contiguous()))
            finally:
                drs._lib = new_lib
            print(json.dumps({"kernel": "dense_round_single",
                              "m_objects": m, "n_persons": n,
                              "state": state, "plain_rounds_before": rounds,
                              **{f"{k}_{q}": v[q] for k, v in times.items()
                                 for q in v},
                              "bit_equal": True}), flush=True)
        del vt, vnm, states


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
    stream_lib = old.pop("stream")
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
    single_round_pairs(Path(argv[0]).resolve(), stream_lib)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
