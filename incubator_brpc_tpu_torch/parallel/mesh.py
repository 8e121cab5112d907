"""Mesh management + ICI topology naming over torch devices.

Port of the JAX package's ``parallel/mesh.py``: each device of the mesh
is an ``ici://slice<i>/chip<j>`` endpoint, ``create_mesh`` builds the
:class:`Mesh` the collective lowerings (``parallel/collectives.py``)
and the sharded batch kernels (``batching/sharded.py``) run over, and
``ici_endpoints`` enumerates the addressable nodes (the ``tpu://mesh``
naming service and the shard channels consume it).

Axis convention: ("slice", "chip") — "slice" is the DCN-ish outer axis
(cross-slice), "chip" the ICI-ish inner axis.

The mesh is single-controller, as the JAX ``Mesh`` is: one process
drives every device of it, each chip holds its own shard tensors and
computes its own partial, and a collective is torch ops across those
devices.  Chip ``j`` lives on ``cuda:(j % device_count)``
(:func:`device_for_chip`), so a mesh may list one device more than
once: on one card, a (1, 4) mesh is four *virtual chips* on ``cuda:0``,
the counterpart of the virtual host devices the JAX package's tests
build with ``xla_force_host_platform_device_count``.  On a box with
several cards the same mesh spreads its chips over them, and merges
move partials by peer copy.  There is no silent CPU default: a caller
that wants the CPU (the tests) passes ``torch.device("cpu")`` devices,
and with no card and no devices given ``create_mesh`` raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

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


class Mesh:
    """A named grid of devices, the JAX ``Mesh``'s surface: ``devices``
    an object ndarray of ``torch.device`` (one entry per chip, a device
    possibly listed more than once: virtual chips), ``axis_names`` and
    ``shape``, an ordered mapping from axis name to size."""

    def __init__(self, devices, axis_names: Tuple[str, ...] = ("slice", "chip")):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"{arr.ndim}-d device array for axes {tuple(axis_names)}"
            )
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            self.devices[idx] = device_for_chip(idx[-1], arr[idx])
        self.axis_names = tuple(axis_names)
        self.shape = OrderedDict(zip(self.axis_names, arr.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {sorted({str(d) for d in self.devices.flat})})"


def create_mesh(
    shape: Optional[Tuple[int, int]] = None,
    axis_names: Tuple[str, str] = ("slice", "chip"),
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a 2D Mesh over ``devices`` (default: every CUDA device;
    raises without a card).  shape=None picks (1, n_devices) — one
    slice, all chips on ICI."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError(
                "no CUDA device for create_mesh; pass devices= explicitly"
            )
        devices = [torch.device("cuda", j) for j in range(n)]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if shape is None:
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), axis_names)


_default_mesh: Optional[Mesh] = None


def default_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The (1, n) mesh of ``devices``, or of every CUDA device (raises
    without a card)."""
    global _default_mesh
    if devices is not None:
        return create_mesh(devices=devices)
    if _default_mesh is None:
        _default_mesh = create_mesh()
    return _default_mesh


def ici_endpoints(mesh: Optional[Mesh] = None) -> List[EndPoint]:
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


def device_of(mesh: Mesh, ep: EndPoint) -> torch.device:
    s, c = ep.coords
    return mesh.devices[s][c]
