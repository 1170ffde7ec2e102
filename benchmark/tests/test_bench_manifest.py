"""``BENCHMARK.json`` against the benchmark's contract, and the cells'
files found by name, new ones included."""

import json
import re
import shutil

import pytest

from benchmark import plugins

MANIFEST = json.loads(plugins.MANIFEST.read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert plugins.MANIFEST.stat().st_size <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= len(MANIFEST["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert MANIFEST["command"][1].startswith(MANIFEST["paths"][0] + "/")
    assert 1 <= len(MANIFEST["configs"]) <= 24
    assert 1 <= len(MANIFEST["workloads"]) <= 24
    assert 1 <= len(MANIFEST["end_to_end"]) <= 16
    assert 1 <= len(MANIFEST["per_layer"]) <= 128


def test_names_units_and_keys():
    names = ([c["name"] for c in MANIFEST["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names)
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(MANIFEST["paths"][0] + "/")
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and _line(m["layer"])
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_every_cell_reports_what_it_must():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        c = plugins.cell(cell)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in names
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(
        1, len(CELLS) // 4)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = plugins.cell(cell)
    assert c.config["reduced"] == next(
        x["reduced"] for x in MANIFEST["configs"] if x["name"] == c.spec[
            "config"])
    assert c.config["chips"] == c.chips
    for kind, key in (("gen", "generator"), ("entries", "entry")):
        mod = plugins.load_module(kind, c.spec[key])
        assert mod is not None
    entry = plugins.load_module("entries", c.spec["entry"])
    nbytes, ops = entry.work(c.spec, c.chips)
    assert nbytes > 0 and ops > 0
    for m in c.per_layer:
        assert callable(plugins.load_module("metrics", m["name"]).read)
    sides = c.config.get("sides", [c.config.get("rows")])
    assert c.spec["rows"] in sides


def test_files_added_by_name_are_picked_up(tmp_path):
    """A configuration, a cell and a metric added as new files with their
    manifest entries, and no existing file edited, are found."""
    root = tmp_path / "benchmark"
    shutil.copytree(plugins.ROOT, root,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    manifest = json.loads(plugins.MANIFEST.read_text())
    conf = json.loads((root / "configs" / "dense-int1000.json").read_text())
    conf.update(name="dense-int100", cost_high=100)
    (root / "configs" / "dense-int100.json").write_text(json.dumps(conf))
    spec = json.loads(
        (root / "workloads" / f"{CELLS[0]}.json").read_text())
    spec.update(config="dense-int100", batch=64)
    (root / "workloads" / "dense-int100.b64-n256.json").write_text(
        json.dumps(spec))
    (root / "metrics" / "calls.count.py").write_text(
        "def read(rec):\n    return len(rec.calls)\n")
    manifest["configs"].append(dict(
        manifest["configs"][0], name="dense-int100",
        file="benchmark/configs/dense-int100.json"))
    manifest["workloads"].append(dict(
        manifest["workloads"][0], name="dense-int100.b64-n256",
        config="dense-int100", traffic="b64-n256"))
    manifest["per_layer"].append(dict(
        manifest["per_layer"][0], name="calls.count", unit="calls",
        workloads=["dense-int100.b64-n256"]))
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(manifest))
    c = plugins.cell("dense-int100.b64-n256", path, root)
    assert c.config["cost_high"] == 100 and c.spec["batch"] == 64
    assert [m["name"] for m in c.per_layer] == ["calls.count"]
    reader = plugins.load_module("metrics", "calls.count", root)
    assert reader.read(type("R", (), {"calls": [1, 2]})) == 2
    with pytest.raises(KeyError):
        plugins.cell("no-such-cell", path, root)
