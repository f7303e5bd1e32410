"""No module of the JAX side may be loaded in a run of the port."""

import sys

#: top-level module names a run must not hold, compared whole (the port's
#: own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "mcmcpp_tpu")


def forbidden_loaded(modules=None):
    """Sorted top-level names of ``modules`` (default ``sys.modules``) that
    are in :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in modules} & set(FORBIDDEN))
