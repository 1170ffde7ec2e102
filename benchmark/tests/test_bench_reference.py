"""The plain reference (``benchmark/reference/certificate.py``) against
brute force on tiny instances."""

import itertools

import numpy as np
import pytest
import torch

from benchmark.reference.certificate import UNASSIGNED, judge


def _answer(p2o, m):
    o2p = np.full(m, UNASSIGNED, np.int64)
    for i, j in enumerate(p2o):
        if 0 <= j < m:
            o2p[j] = i
    return o2p


def _judge_one(costs, p2o, objective=None, num_unassigned=None):
    n, m = costs.shape
    p2o = np.asarray(p2o, np.int64)
    cost = sum(costs[i, j] for i, j in enumerate(p2o) if 0 <= j < m)
    v = judge(torch.from_numpy(costs)[None], p2o[None],
              _answer(p2o, m)[None],
              [int(np.sum(p2o == UNASSIGNED)) if num_unassigned is None
               else num_unassigned],
              [cost if objective is None else objective])
    return {k: x[0].item() for k, x in v.items()}


@pytest.mark.parametrize("n,m,arcs", [(3, 3, None), (4, 4, None),
                                      (5, 5, None), (3, 5, None), (3, 6, 3),
                                      (4, 6, 3)])
@pytest.mark.parametrize("seed", range(3))
def test_every_matching_judged_as_brute_force(n, m, arcs, seed):
    """Every complete matching of a small instance: improvable exactly
    when it costs more than the best one, never invalid, no gap."""
    rng = np.random.default_rng([seed, n, m])
    costs = rng.integers(1, 10, size=(n, m)).astype(np.float64)
    if arcs is not None:
        keep = np.zeros((n, m), bool)
        for i in range(n):
            keep[i, rng.choice(m, arcs, replace=False)] = True
        costs = np.where(keep, costs, np.inf)
    matchings = [p for p in itertools.permutations(range(m), n)
                 if np.isfinite(costs[np.arange(n), list(p)]).all()]
    best = min(costs[np.arange(n), list(p)].sum() for p in matchings)
    for p in matchings:
        v = _judge_one(costs, p)
        assert not v["invalid"] and v["unassigned"] == 0
        assert v["objective_gap"] == 0
        assert v["improvable"] == (costs[np.arange(n), list(p)].sum() > best)


def test_faults_are_invalid():
    costs = np.arange(16, dtype=np.float64).reshape(4, 4)
    assert _judge_one(costs, [0, 1, 2, 3])["invalid"] is False
    # an object taken twice
    assert _judge_one(costs, [0, 0, 2, 3])["invalid"]
    # an index out of range
    assert _judge_one(costs, [0, 1, 2, 7])["invalid"]
    # num_unassigned that disagrees with the matching
    assert _judge_one(costs, [0, 1, 2, 3], num_unassigned=1)["invalid"]
    # the objective of another matching
    assert _judge_one(costs, [0, 1, 2, 3], objective=1.0)["objective_gap"] > 0
    # a person without an object is counted, not judged optimal
    v = _judge_one(costs, [0, 1, 2, UNASSIGNED])
    assert v["unassigned"] == 1 and not v["invalid"]
    # a non-arc taken
    holes = costs.copy()
    holes[0, 0] = np.inf
    assert _judge_one(holes, [0, 1, 2, 3])["invalid"]


def test_object_to_person_must_invert():
    costs = np.ones((3, 3))
    p2o = np.array([[0, 1, 2]])
    o2p = np.array([[1, 0, 2]])
    v = judge(torch.from_numpy(costs)[None], p2o, o2p, [0], [3.0])
    assert bool(v["invalid"][0])


def test_batched_chunks_agree_with_one_at_a_time(monkeypatch):
    """The pass-size chunking gives the same verdicts as instance by
    instance."""
    import benchmark.reference.certificate as cert

    rng = np.random.default_rng(5)
    s, n = 9, 6
    costs = rng.integers(1, 20, size=(s, n, n)).astype(np.float64)
    p2o = np.stack([rng.permutation(n) for _ in range(s)])
    o2p = np.argsort(p2o, axis=1)
    obj = np.take_along_axis(costs, p2o[:, :, None], 2)[:, :, 0].sum(1)
    whole = judge(torch.from_numpy(costs), p2o, o2p, np.zeros(s), obj)
    monkeypatch.setattr(cert, "_PASS_ELEMS", n * n * 2)
    chunked = judge(torch.from_numpy(costs), p2o, o2p, np.zeros(s), obj)
    for k in whole:
        assert torch.equal(whole[k], chunked[k])
