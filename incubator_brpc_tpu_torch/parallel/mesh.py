"""ICI coordinates over torch devices.

The JAX package's ``parallel/mesh.py`` builds a ``jax.sharding.Mesh``
and names each device ``ici://slice<i>/chip<j>``.  The port maps each
coordinate onto a ``torch.device``: chip ``j`` is
``cuda:(j % device_count)``.  There is no silent CPU default: a caller
that wants the CPU (the tests) passes ``torch.device("cpu")``, and with
no card and no device given the lookup raises.

``default_mesh`` and ``ici_endpoints`` serve naming (the ``tpu://mesh``
naming service): a :class:`DeviceMesh` is one slice of chips, its
``devices`` a (1, n) array of ``torch.device``.  The collective mesh
over a process group (``create_mesh``) is ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from incubator_brpc_tpu_torch.unported import unported
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint


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


class DeviceMesh:
    """One slice of chips: ``devices[0][j]`` owns ``ici://slice0/chip<j>``
    (the JAX ``Mesh``'s ("slice", "chip") axis convention)."""

    axis_names = ("slice", "chip")

    def __init__(self, devices: Sequence):
        devs = [torch.device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty((1, len(devs)), dtype=object)
        for j, d in enumerate(devs):
            self.devices[0, j] = d


def create_mesh(*args, **kwargs):
    unported("create_mesh (the collective mesh over a process group)", 5)


_default_mesh: Optional[DeviceMesh] = None


def default_mesh(devices: Optional[Sequence] = None) -> DeviceMesh:
    """The mesh of ``devices``, or of every CUDA device (raises without
    a card)."""
    global _default_mesh
    if devices is not None:
        return DeviceMesh(devices)
    if _default_mesh is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device for the default mesh; pass devices= "
                "explicitly"
            )
        _default_mesh = DeviceMesh([torch.device("cuda", j) for j in range(n)])
    return _default_mesh


def ici_endpoints(mesh: Optional[DeviceMesh] = None) -> List[EndPoint]:
    """Enumerate mesh coordinates as ici:// endpoints (the topology the
    ici:// naming service serves)."""
    if mesh is None:
        mesh = default_mesh()
    out = []
    n_slices, n_chips = mesh.devices.shape
    for s in range(n_slices):
        for c in range(n_chips):
            out.append(EndPoint.ici(s, c))
    return out


def device_of(mesh: DeviceMesh, ep: EndPoint) -> torch.device:
    s, c = ep.coords
    return mesh.devices[s][c]
