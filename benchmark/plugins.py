"""Finds a cell's files by the names ``BENCHMARK.json`` gives them.

A later change adds a configuration, a cell, a generator, an entry
adapter or a metric by adding its file and its manifest entry; nothing
here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MANIFEST = ROOT.parent / "BENCHMARK.json"


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module ``<root>/<kind>/<name>.py`` (a generator, an entry
    adapter or a metric reader), loaded by its path: metric names hold
    dots."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclasses.dataclass
class Cell:
    """One cell of the manifest with everything its files say."""

    name: str
    chips: int
    spec: dict      # workloads/<cell>.json
    config: dict    # configs/<config>.json
    end_to_end: list
    per_layer: list


def cell(name: str, manifest_path: Path = MANIFEST,
         root: Path | None = None) -> Cell:
    """The cell ``name`` of the manifest, its workload file and its
    configuration's file, both in the folder beside the manifest (or in
    ``root``); raises ``KeyError`` for an unknown cell."""
    root = manifest_path.parent / ROOT.name if root is None else root
    manifest = read_json(manifest_path)
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {manifest_path}")
    config = next(c for c in manifest["configs"]
                  if c["name"] == entry["config"])
    spec = read_json(root / "workloads" / f"{name}.json")
    conf = read_json(manifest_path.parent / config["file"])
    if spec["config"] != entry["config"] or conf["name"] != entry["config"]:
        raise ValueError(f"{name}: the workload file, the manifest and the "
                         "configuration's file name different configurations")
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        spec=spec,
        config=conf,
        end_to_end=[m for m in manifest["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _applies(m, name)],
    )
