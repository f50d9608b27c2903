"""Re-export shim, as in the JAX package: the layer-spec math lives at the
package root (``structure.py``) so ``ops/`` can depend on it without
importing the models package.
"""

from ..structure import *  # noqa: F401,F403
from ..structure import (  # noqa: F401
    ConvSpec,
    LayerSpec,
    MAX_KERNEL_SIZE,
    OSLayerShapes,
)
