"""The plain reference: judges a batch of assignment answers from the
costs alone.

Plain PyTorch, float64, on whatever device the costs lie.  It imports
nothing of the program and takes nothing the program made except the
answers it judges: each instance's ``person_to_object``,
``object_to_person``, ``num_unassigned`` and ``objective``.

An answer is optimal when no exchange of objects lowers its cost.  Such
an exchange is a cycle of persons, each moving to the next one's object,
or a path of them that ends at a free object, with a negative sum of
cost changes.  Over the objects, the move of person ``i`` from its object
``o(i)`` to object ``j`` is an edge ``o(i) -> j`` of weight
``c[i, j] - c[i, o(i)]``.  Bellman-Ford from all assigned objects at
distance 0 then settles within as many passes as there are objects
exactly when no negative cycle exists, and a free object reached below 0
is an improving path.  Costs are whole numbers here, so every distance
is exact in float64 and the verdict has no tolerance.
"""

from __future__ import annotations

import torch

#: the program's documented sentinel for an unassigned person or object
UNASSIGNED = 2**31 - 1

#: the float64 elements one Bellman-Ford pass may hold at once
_PASS_ELEMS = 1 << 26


def judge(costs, p2o, o2p, num_unassigned, objective) -> dict:
    """Judge ``S`` answers of ``[S, N, M]`` cost matrices (``inf`` where
    no arc, minimised).  The answers are host or device arrays of shapes
    ``[S, N]``, ``[S, M]``, ``[S]`` and ``[S]``.  Returns per-instance
    tensors on the costs' device: ``unassigned`` (persons without an
    object), ``invalid`` (the two maps disagree, an object is taken
    twice, an index is out of range, a non-arc is taken, or
    ``num_unassigned`` is wrong), ``objective_gap`` (the reported
    objective against the cost of the reported matching) and
    ``improvable`` (a valid, complete answer that an exchange makes
    cheaper)."""
    dev = costs.device
    s, n, m = costs.shape
    p2o = torch.as_tensor(p2o, device=dev).to(torch.int64)
    o2p = torch.as_tensor(o2p, device=dev).to(torch.int64)
    num_unassigned = torch.as_tensor(num_unassigned, device=dev)
    objective = torch.as_tensor(objective, device=dev).to(torch.float64)

    assigned = (p2o >= 0) & (p2o < m)
    bad_index = ~assigned & (p2o != UNASSIGNED)
    unassigned = n - assigned.sum(dim=1)
    obj = torch.where(assigned, p2o, 0)
    taken = torch.zeros((s, m), dtype=torch.int64, device=dev)
    taken.scatter_add_(1, obj, assigned.to(torch.int64))
    held = (o2p >= 0) & (o2p < n)
    back = torch.gather(o2p, 1, obj)
    persons = torch.arange(n, device=dev).expand(s, n)
    own = torch.gather(costs, 2, obj[:, :, None])[:, :, 0]
    invalid = (
        bad_index.any(dim=1)
        | (taken > 1).any(dim=1)
        | (assigned & (back != persons)).any(dim=1)
        | (~held & (o2p != UNASSIGNED)).any(dim=1)
        | (held.sum(dim=1) != assigned.sum(dim=1))
        | (assigned & torch.isinf(own)).any(dim=1)
        | (num_unassigned.to(torch.int64) != unassigned)
    )
    cost = torch.where(assigned, own, 0.0).sum(dim=1)
    gap = (objective - cost).abs()
    gap = torch.where(torch.isnan(gap), torch.inf, gap)

    improvable = torch.zeros(s, dtype=torch.bool, device=dev)
    sound = ~invalid & (unassigned == 0)
    if bool(sound.any()):
        rows = sound.nonzero()[:, 0]
        step = max(1, _PASS_ELEMS // (n * m))
        for lo in range(0, rows.numel(), step):
            r = rows[lo:lo + step]
            improvable[r] = _improvable(costs[r], obj[r], own[r])
    return dict(unassigned=unassigned, invalid=invalid, objective_gap=gap,
                improvable=improvable)


def _improvable(costs, p2o, own) -> torch.Tensor:
    """Bellman-Ford over the objects of complete matchings ``p2o`` of
    ``costs [S, N, M]``; ``own[s, i]`` is ``costs[s, i, p2o[s, i]]``.
    True where a negative cycle or a negative path to a free object
    exists."""
    s, n, m = costs.shape
    dist = torch.full((s, m), torch.inf, dtype=torch.float64,
                      device=costs.device)
    dist.scatter_(1, p2o, 0.0)
    changed = torch.ones(s, dtype=torch.bool, device=costs.device)
    for _ in range(m + 1):
        lead = torch.gather(dist, 1, p2o) - own
        reach = (lead[:, :, None] + costs).amin(dim=1)
        better = reach < dist
        changed = better.any(dim=1)
        if not bool(changed.any()):
            break
        dist = torch.where(better, reach, dist)
    free = torch.ones((s, m), dtype=torch.bool, device=costs.device)
    free.scatter_(1, p2o, False)
    return changed | (free & (dist < 0)).any(dim=1)
