"""Guards and collectives of the port's sharded modes, on the CPU.

The entry points raise without a process group, with ``device=None``
on a machine without a card, and when the group's backend does not fit
the device (a CUDA device with a gloo group), before anything is
staged.  On a world of one the collectives return new
tensors, carry bool through int32, count each call and gather several
tensors in one plane; all of it is exact (tolerance 0).  Their results
on two ranks: ``test_torch_sharded_single.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sparse_linear_assignment_tpu_torch import KhoslaSolver
from sparse_linear_assignment_tpu_torch.parallel import collectives, sharded


def entry_calls():
    """One small call of each of the six sharded entry points."""
    solver, _ = KhoslaSolver.new(2, 2, 4)
    solver.init(2, 2)
    for i in range(2):
        solver.extend_from_values(i, range(2), [1.0, 2.0])
    costs = np.ones((2, 4, 4))
    return {
        "khosla": (sharded.solve_sharded_khosla, (solver,)),
        "forward": (sharded.solve_sharded_forward, (solver,)),
        "fr_dense": (sharded.solve_fr_dense_sharded, (costs[0],)),
        "batched": (sharded.solve_batch_sharded, (costs,)),
        "stream": (sharded.solve_batch_sharded_stream,
                   ([torch.ones((2, 4, 4))],)),
        "sparse": (sharded.solve_batch_sparse_sharded,
                   (np.zeros((1, 8, 1), np.int32), np.ones((1, 8, 1)), 128)),
    }


ENTRIES = ["khosla", "forward", "fr_dense", "batched", "stream", "sparse"]


@pytest.mark.parametrize("name", ENTRIES)
def test_no_process_group_raises(name):
    assert not dist.is_initialized()
    fn, args = entry_calls()[name]
    with pytest.raises(ValueError, match="init_process_group"):
        fn(*args, device="cpu")


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A world of one gloo rank in this process."""
    store = tmp_path_factory.mktemp("sharded_guard") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ENTRIES)
def test_device_none_without_card_raises(world1, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, args = entry_calls()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)


@pytest.mark.parametrize("name", ENTRIES)
def test_cuda_device_with_gloo_group_raises(world1, monkeypatch, name):
    """A card that the group's backend cannot serve: ``ValueError``
    before any tensor is made on it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    fn, args = entry_calls()[name]
    with pytest.raises(ValueError, match="need a nccl process group"):
        fn(*args)


def test_rank_device(world1):
    assert collectives.rank_device(None, "cpu") == torch.device("cpu")
    assert collectives.shard_index(None) == (0, 1)


def test_collectives_world_of_one(world1):
    collectives.reset_counts()
    x = torch.tensor([3.0, -1.0, 2.5])
    for op in ("max", "min", "sum"):
        y = collectives.all_reduce(x, op)
        assert y is not x and torch.equal(y, x)
    flags = torch.tensor([True, False])
    out = collectives.all_reduce(flags, "max")
    assert out.dtype == torch.bool and torch.equal(out, flags)
    gathered = collectives.all_gather_tiled(flags)
    assert gathered.dtype == torch.bool and torch.equal(gathered, flags)
    parts = [torch.arange(6, dtype=torch.float64).reshape(3, 2),
             torch.tensor([7, 8, 9], dtype=torch.int32),
             torch.tensor([True, False, True]),
             torch.tensor([0.5, 1.5, -2.0], dtype=torch.float32)]
    for got, want in zip(collectives.all_gather_parts(parts), parts):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert collectives.COUNTS == {"all_gather": 2, "max": 2, "min": 1,
                                  "sum": 1}
