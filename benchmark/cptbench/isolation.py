"""What a run may not load: JAX, its relatives, and the JAX package the port
was made from. Module names are compared by their top-level name, whole: the
port's own name begins with the JAX package's name."""
from __future__ import annotations

import sys
from typing import Iterable, List

BANNED = frozenset({"jax", "jaxlib", "flax", "cuda_path_tracer_ss_tpu"})
PROGRAM = "cuda_path_tracer_ss_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def banned_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules (default: ``sys.modules``) whose top-level name is
    banned, sorted."""
    names = sys.modules.keys() if modules is None else modules
    return sorted(n for n in names if top_level(n) in BANNED)


def program_loaded(modules: Iterable[str] = None) -> List[str]:
    """The loaded modules that belong to the program."""
    names = sys.modules.keys() if modules is None else modules
    return sorted(n for n in names if top_level(n) == PROGRAM)
