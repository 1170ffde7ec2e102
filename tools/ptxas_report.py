#!/usr/bin/env python3
"""Registers, stack frame and spill bytes of every kernel of ``csrc/``.

    python3 tools/ptxas_report.py [CSRC_DIR ...]

Run from the root of a checkout on a machine with ``nvcc`` (no card is
needed).  Compiles every ``*.cu`` of each directory (default: the
package's ``csrc/``) with the package's ``NVCC_FLAGS`` into a temporary
directory, one ``nvcc`` a source, all started together, and prints one
JSON line a directory: ``{"csrc": dir, "kernels": {source: {kernel:
{"registers", "stack", "spill_stores", "spill_loads", "sass"}}}}``.
``sass`` is a hash of the kernel's machine code (``cuobjdump -sass``)
with the instruction addresses and encodings left out and every
constant-bank offset (a kernel argument's place) written as one symbol:
two kernels with the same hash run the same instructions, whatever
arguments were added around the ones they read.  Give an older
checkout's ``csrc/`` beside this one to compare two versions of the
kernels built by the same compiler; a last line for each older
directory then lists the kernels whose machine code equals this
checkout's, those whose code differs, and the sources only this
checkout has.
"""

from __future__ import annotations

import hashlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from sparse_linear_assignment_tpu_torch.ops import _build  # noqa: E402


def start(csrc: Path, out_dir: Path) -> dict:
    """One ``nvcc`` a source of ``csrc``, started at once."""
    jobs = {}
    for cu in sorted(csrc.glob("*.cu")):
        so = out_dir / f"{cu.stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(so), str(cu)]
        jobs[cu.stem] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return jobs


def sass_hashes(so: Path) -> dict:
    """A hash of each kernel's normalised machine code in ``so``."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, _, body = part.partition("\n")
        code = []
        for line in body.splitlines():
            line = re.sub(r"/\*[0-9a-f]{4}\*/", "", line)   # address
            line = re.sub(r"/\* 0x[0-9a-f]{16} \*/", "", line)  # encoding
            line = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][arg]", line)
            if line.strip():
                code.append(line.strip())
        out[name.strip()] = hashlib.sha1(
            "\n".join(code).encode()).hexdigest()[:16]
    return out


def finish(csrc: Path, jobs: dict) -> dict:
    kernels = {}
    for name, (so, job) in jobs.items():
        out, _ = job.communicate()
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc / name}.cu:\n{out}")
        table = _build.ptxas_table(out)
        for kernel, digest in sass_hashes(so).items():
            if kernel in table:
                table[kernel]["sass"] = digest
        kernels[name] = table
    return kernels


def main(argv) -> int:
    dirs = [Path(a).resolve() for a in argv] or [_build.CSRC]
    with tempfile.TemporaryDirectory() as tmp:
        started = []
        for i, csrc in enumerate(dirs):  # every directory's builds at once
            out_dir = Path(tmp) / str(i)
            out_dir.mkdir()
            started.append((csrc, start(csrc, out_dir)))
        tables = []
        for csrc, jobs in started:
            tables.append(finish(csrc, jobs))
            print(json.dumps({"csrc": str(csrc), "kernels": tables[-1]}),
                  flush=True)
    for csrc, table in zip(dirs[1:], tables[1:]):
        print(json.dumps({"compare": [str(dirs[0]), str(csrc)],
                          **sass_compare(tables[0], table)}), flush=True)
    return 0


def sass_compare(first: dict, other: dict) -> dict:
    """Which kernels of ``other`` run the same machine code as in
    ``first`` (by ``sass`` hash), which differ, and which sources only
    ``first`` has."""
    def plain(kernels):
        # an anonymous namespace's mangled name holds a hash of the
        # source's path: the same kernel built from two directories
        return {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", k): v
                for k, v in kernels.items()}

    same, differ = [], []
    for source, kernels in other.items():
        mine_all = plain(first.get(source, {}))
        for kernel, row in plain(kernels).items():
            mine = mine_all.get(kernel)
            if mine is not None:
                (same if mine.get("sass") == row.get("sass")
                 else differ).append(f"{source}:{kernel}")
    return {"same_sass": same, "different_sass": differ,
            "sources_only_in_first": sorted(set(first) - set(other))}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
