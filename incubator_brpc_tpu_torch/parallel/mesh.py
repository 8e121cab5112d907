"""ICI coordinates over torch devices.

The JAX package's ``parallel/mesh.py`` builds a ``jax.sharding.Mesh``
and names each device ``ici://slice<i>/chip<j>``.  The port maps each
coordinate onto a ``torch.device``: chip ``j`` is
``cuda:(j % device_count)``.  There is no silent CPU default: a caller
that wants the CPU (the tests) passes ``torch.device("cpu")``, and with
no card and no device given the lookup raises.
"""

from __future__ import annotations

import torch


def device_for_chip(chip_id: int, device=None) -> torch.device:
    """The torch device that owns ``ici://slice*/chip<chip_id>``:
    ``device`` itself when given, else ``cuda:(chip_id % count)``."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for ici chip {chip_id}; pass device= "
            f"explicitly (torch.device('cpu') runs the plain versions)"
        )
    return torch.device("cuda", chip_id % torch.cuda.device_count())

