"""The check that no JAX is loaded in the process that prints the result.
Module names are compared by their whole top-level name (the part before
the first dot): the port's package name begins with the JAX package's, so
a prefix test would be wrong."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mc_path_tracer_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
