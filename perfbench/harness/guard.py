"""What the measured process may not hold: JAX, its libraries, or the JAX
package the port was made from (top-level module names compared whole: the
port's name begins with the JAX package's)."""

from __future__ import annotations

import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "diffusionrenderer_tpu")


def forbidden_modules() -> List[str]:
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
