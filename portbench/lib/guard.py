"""The check that no run loads the JAX package or JAX.

A module's top-level name is the part of its name before the first dot,
compared whole: `mtf_tpu_torch` is the program, `mtf_tpu` the JAX
package beside it."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mtf_tpu"})


def forbidden_loaded(names=None) -> list:
    """The forbidden top-level names among module names `names` (default:
    `sys.modules`), sorted."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names}
                  & FORBIDDEN)
