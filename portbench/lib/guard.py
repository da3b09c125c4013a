"""The import guard: no module of the JAX stack or of the JAX package may be
loaded in a benchmark run. Names are compared by their top-level part (the
part before the first dot), whole: ``adunet_torch`` is the port, ``adunet``
the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "adunet"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level part is forbidden, sorted."""
    return sorted(n for n in set(names) if n.split(".", 1)[0] in FORBIDDEN)


def loaded_forbidden() -> List[str]:
    return forbidden(list(sys.modules))
