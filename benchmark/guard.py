"""The check that no run loads JAX or the JAX package.

Module names are compared by their top-level name, whole: the program's
package, ``sparse_linear_assignment_tpu_torch``, begins with the JAX
package's name and is not forbidden.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset(
    {"jax", "jaxlib", "flax", "sparse_linear_assignment_tpu"})


def forbidden_modules(modules=None) -> list:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
