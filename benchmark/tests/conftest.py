"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests`` from the repository's root).

Tests that need a card carry the ``card`` marker and ask for the
``card`` fixture, which skips them where no CUDA device is present; the
look happens inside the fixture, never at import.
"""

import pytest
import torch
import torch.distributed as dist


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def gloo_world(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()
