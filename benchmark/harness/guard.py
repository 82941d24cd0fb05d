"""The run refuses to report if the JAX side got loaded.

The port's package name begins with the JAX package's (``funcodec_tpu_torch``
and ``funcodec_tpu``), so each loaded module's top-level name, the part
before the first dot, is compared whole.
"""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "funcodec_tpu"})


def forbidden_loaded(modules=None) -> List[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)


def check(when: str) -> None:
    """Exit with code 3, naming what was found, if a forbidden module is loaded."""
    found = forbidden_loaded()
    if found:
        print(f"benchmark: {', '.join(found)} loaded {when}; the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        raise SystemExit(3)
