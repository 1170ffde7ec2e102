"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's files are found by name
(``BENCHMARK.json``, ``benchmark/workloads/<cell>.json`` and what it
names).  The run exits non-zero and prints no result when the cards the
cell asks for are missing, when the program is not in the checkout, or
when JAX or the JAX package is loaded.  A four-card cell starts one
process a card (this command with ``--rank``); rank 0 prints the line.
"""

import time

T_START = time.perf_counter()

import ctypes  # noqa: E402
import ctypes.util  # noqa: E402

#: glibc's ``M_MMAP_THRESHOLD`` at its adaptive rule's ceiling on 64 bits,
#: 32 MiB, and ``M_TRIM_THRESHOLD`` at twice that, as the rule sets it.  A
#: process under the rule raises its threshold to each larger block it
#: frees, at points that differ from run to run; fixed, every run starts
#: where a long-running caller ends up, its host arrays from the heap
#: (PERF.md, §2).
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
try:
    _libc = ctypes.CDLL(ctypes.util.find_library("c"))
    _libc.mallopt(_M_MMAP_THRESHOLD, 32 << 20)
    _libc.mallopt(_M_TRIM_THRESHOLD, 64 << 20)
except (OSError, AttributeError, TypeError):
    pass  # not glibc: its allocator has no adaptive threshold to fix

import argparse  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

# every cache of the program and of PyTorch at a fixed path in the
# checkout, so only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / ".cache" / sub)
os.environ["NCCL_SHM_DISABLE"] = "1"  # nothing of ours under /dev/shm
os.environ["USE_FLAX"] = "0"
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)  # the folder's modules go by ``benchmark.<name>``
sys.path.insert(0, str(REPO))

#: seconds the other ranks of a four-card cell get to finish after rank 0
RANK_WAIT_S = 120

#: the controls (``--control``): the same entry at the coarsest lattice,
#: eps = 1 cost unit (n * eps far above 1), or on inputs rounded through
#: bfloat16, the precision below float32; both are judged against the
#: true inputs and must come out not correct
CONTROLS = {"eps1": {"eps": 1.0}, "bf16": {"dtype": "bfloat16"}}


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=sorted(CONTROLS), default=None,
                   help="run a control in the program's place (never part "
                        "of a benchmark run; see PERF.md)")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv=None) -> int:
    args = _args(argv)
    import torch

    try:
        import sparse_linear_assignment_tpu_torch as program
    except ImportError as e:
        return _fail(f"the program is not in this checkout ({e})")
    if Path(program.__file__).resolve().parent.parent != REPO:
        return _fail(f"the program was imported from {program.__file__}, "
                     f"not from this checkout")

    from benchmark import core, plugins

    cell = plugins.cell(args.workload)
    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        return _fail(f"{cell.name} needs {cell.chips} cards, "
                     f"{torch.cuda.device_count()} found")
    control = CONTROLS.get(args.control)
    if control and "dtype" in control:
        control = dict(control, dtype=getattr(torch, control["dtype"]))
    common = dict(t_start=T_START, control=control)
    if cell.chips == 1:
        result = core.run(cell.name, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", **common)
        core.report(result)
        return 0

    # a four-card cell: this process is rank 0 and starts the others
    rank = 0 if args.rank is None else args.rank
    port = args.port
    children, ok = [], False
    if rank == 0:
        port = _free_port()
        base = [sys.executable, str(Path(__file__).resolve()),
                "--workload", args.workload, "--seed", str(args.seed),
                "--seconds", str(args.seconds), "--trace", str(args.trace),
                "--port", str(port)]
        if args.control:
            base += ["--control", args.control]
        children = [subprocess.Popen(base + ["--rank", str(r)],
                                     stdout=sys.stderr)
                    for r in range(1, cell.chips)]
    try:
        import torch.distributed as dist

        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
        dist.init_process_group(
            "nccl", init_method=f"tcp://127.0.0.1:{port}",
            world_size=cell.chips, rank=rank,
            timeout=timedelta(seconds=RANK_WAIT_S))
        group = dist.new_group(backend="gloo")
        result = core.run(cell.name, args.seed, args.seconds,
                          bool(args.trace), device, rank=rank,
                          world=cell.chips, group=group, **common)
        dist.barrier(group=group)
        dist.destroy_process_group()
        ok = True
    finally:
        bad = []
        for ch in children:
            if not ok:
                ch.kill()
            try:
                code = ch.wait(timeout=RANK_WAIT_S)
            except subprocess.TimeoutExpired:
                ch.kill()
                code = ch.wait()
            if code != 0:
                bad.append(code)
    if bad:
        return _fail(f"a rank process failed (exit codes {bad})")
    if rank == 0:
        core.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
