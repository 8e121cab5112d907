"""What may not be loaded in a process that measures the port."""

import sys

# whole top-level names: the port's own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "incubator_brpc_tpu")


def forbidden_loaded(modules=None):
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))
