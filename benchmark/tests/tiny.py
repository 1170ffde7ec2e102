"""Tiny sizes of the cells for the CPU tests, cells of the entries that
no committed cell drives yet, and a manifest that lists a given cell."""

import json
import shutil

from benchmark import plugins

#: tiny sizes of each cell; the dense cells at side 32 on the float
#: route with eps = 1/(n+1) (the integer lattice needs sides of 128,
#: whose straggler rounds run for minutes in plain rounds)
TINY = {
    "dense-int1000.b4096-n256": dict(batch=4, rows=32, cols=32, pool=2,
                                     warm_calls=1,
                                     entry_args={"solver": "fr",
                                                 "eps_denominator": 33}),
    "dense-int1000.b1-n4096": dict(rows=48, cols=48, pool=3, warm_calls=1,
                                   entry_args={"solver": "fr",
                                               "eps_denominator": 49}),
}

#: batched k-sparse arcs (``bench.py``'s uniform recipe) through the
#: staged stream: name, chips, configuration, workload file
SPARSE = ("ksparse-uniform.b4-n32-m128", 1, {
    "name": "ksparse-uniform", "cost_low": 300, "cost_high": 1000,
    "rows": 32, "cols": 128, "arcs": 8, "chips": 1, "reduced": [],
}, {
    "config": "ksparse-uniform", "generator": "ksparse",
    "entry": "stage_sparse_stream", "batch": 4, "rows": 32, "cols": 128,
    "arcs": 8, "pool": 4, "batches_per_call": 2, "warm_calls": 1,
    "entry_args": {"eps_denominator": 128, "window": 2},
    "sample": {"per_call": 4, "max_checked": 4096},
})

#: the sharded entry on a gloo world of one (float costs at this size:
#: the integer lattice needs sides of 128, slow in plain rounds there)
SHARDED = ("dense-x4.b8-n32", 4, {
    "name": "dense-x4", "cost_low": 1, "cost_high": 1000, "sides": [32],
    "chips": 4, "reduced": [],
}, {
    "config": "dense-x4", "generator": "dense",
    "entry": "solve_batch_sharded", "batch": 8, "rows": 32, "cols": 32,
    "pool": 2, "batches_per_call": 1, "warm_calls": 1,
    "entry_args": {"eps_denominator": 33},
    "sample": {"per_call": 16, "max_checked": 4096},
})


def manifest_with(example, tmp_path):
    """A manifest in ``tmp_path`` that lists the example cell beside the
    committed ones, over a copy of this folder that holds its two data
    files: what a later change adds for a cell."""
    name, chips, config, spec = example
    root = tmp_path / plugins.ROOT.name
    shutil.copytree(plugins.ROOT, root, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    (root / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (root / "workloads" / f"{name}.json").write_text(json.dumps(spec))
    m = json.loads(plugins.MANIFEST.read_text())
    m["configs"].append({"name": config["name"], "source": "s",
                         "reduced": [], "why": "w",
                         "file": f"{root.name}/configs/{config['name']}.json"})
    m["workloads"].append({"name": name, "config": config["name"],
                           "traffic": "t", "chips": chips, "why": "w"})
    for metric in m["per_layer"]:
        metric["workloads"].append(name)
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(m))
    return path
