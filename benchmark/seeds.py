"""Seeds of a run: every input and every sample is drawn from ``--seed``.

A seed may be any whole number, 32 bits or wider; it is
spread with NumPy's ``SeedSequence`` together with the part it seeds, so
that the pool batches and the sample draws never share a stream.
"""

from __future__ import annotations

import numpy as np
import torch

#: the parts of a run that draw from the seed: the pool batches, the
#: instances sampled from each call, and the thinning of that sample
POOL, SAMPLE, THIN = 1, 2, 3


def derive(seed: int, *parts: int) -> int:
    """A 63-bit seed for one part of a run."""
    words = np.random.SeedSequence(
        [int(seed) % (1 << 64), *parts]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def generator(seed: int, k: int, device) -> torch.Generator:
    """The ``torch.Generator`` on ``device`` of pool batch ``k``."""
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, POOL, k))
    return g


def rng(seed: int, *parts: int) -> np.random.Generator:
    """A host generator for one draw of the check (``parts`` start with
    ``SAMPLE`` or ``THIN``)."""
    return np.random.default_rng(derive(seed, *parts))
