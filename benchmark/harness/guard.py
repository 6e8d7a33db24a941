"""The import guard: no module of JAX or of the JAX package in a run.

Names are compared by their top-level part, the text before the first dot,
whole: ``boundmpc_tpu.ocp`` is refused, ``boundmpc_tpu_torch.ocp`` is not.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "boundmpc_tpu"})


def forbidden(names: Iterable[str]) -> List[str]:
    """The names among ``names`` whose top-level part is forbidden."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check(stage: str) -> None:
    """Exit with code 3 and name what was found when ``sys.modules`` holds
    a forbidden module."""
    found = forbidden(list(sys.modules))
    if found:
        print(f"import guard ({stage}): forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr, flush=True)
        raise SystemExit(3)
