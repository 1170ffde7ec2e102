"""Each entry adapter driven through a whole run at a tiny size on the
CPU (the kernels' plain PyTorch versions), judged correct."""

import pytest

from benchmark import core
from benchmark.tests.tiny import SHARDED, SPARSE, TINY, manifest_with

@pytest.mark.parametrize("cell", sorted(TINY) + [SPARSE[0]])
@pytest.mark.parametrize("trace", [False, True])
def test_entry_runs_correct_on_the_cpu(cell, trace, tmp_path):
    if cell == SPARSE[0]:
        r = core.run(cell, 2**40 + 3, 1.0, trace, "cpu",
                     manifest=manifest_with(SPARSE, tmp_path))
    else:
        r = core.run(cell, 2**40 + 3, 1.0, trace, "cpu", overrides=TINY[cell])
    assert r["correct"] and r["checked"] > 0 and r["attempted"] > 0
    assert all(v["value"] == 0 for v in r["compared"].values())
    assert ("breakdown" in r) == trace


def test_sharded_entry_runs_correct_on_one_gloo_rank(gloo_world, tmp_path):
    r = core.run(SHARDED[0], 11, 0.5, False, "cpu",
                 manifest=manifest_with(SHARDED, tmp_path))
    assert r["correct"] and r["checked"] > 0
