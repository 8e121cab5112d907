"""EndPoint — address value type, extended to TPU coordinates.

Analog of butil::EndPoint (reference endpoint.h:86): the reference's
extended EndPoint carries ip:port, unix-domain paths, and IPv6; the TPU
rebuild additionally carries ICI coordinates (``ici://slice/chip``) so
the naming layer can resolve TPU slice coordinates (north star:
"brpc's naming-service layer resolves TPU slice coordinates").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class EndPoint:
    host: str = ""
    port: int = 0
    scheme: str = "tcp"  # tcp | uds | ici
    # For ici endpoints: (slice_id, chip_id); chip may be a device ordinal.
    coords: Optional[Tuple[int, int]] = None

    @staticmethod
    def tcp(host: str, port: int) -> "EndPoint":
        return EndPoint(host=host, port=port, scheme="tcp")

    @staticmethod
    def uds(path: str) -> "EndPoint":
        return EndPoint(host=path, scheme="uds")

    @staticmethod
    def ici(slice_id: int, chip_id: int) -> "EndPoint":
        return EndPoint(scheme="ici", coords=(slice_id, chip_id))

    def is_ici(self) -> bool:
        return self.scheme == "ici"

    def sockaddr(self):
        if self.scheme == "tcp":
            return (self.host, self.port)
        if self.scheme == "uds":
            return self.host
        raise ValueError(f"no sockaddr for {self}")

    def __str__(self) -> str:
        return endpoint2str(self)

    def __repr__(self) -> str:
        return f"EndPoint({endpoint2str(self)!r})"


def endpoint2str(ep: EndPoint) -> str:
    """Analog of butil::endpoint2str."""
    if ep.scheme == "uds":
        return f"unix:{ep.host}"
    if ep.scheme == "ici":
        s, c = ep.coords
        return f"ici://slice{s}/chip{c}"
    return f"{ep.host}:{ep.port}"


def str2endpoint(s: str) -> EndPoint:
    """Analog of butil::str2endpoint; accepts host:port, unix:path,
    ici://sliceN/chipM."""
    if s.startswith("unix:"):
        return EndPoint.uds(s[len("unix:") :])
    if s.startswith("ici://"):
        rest = s[len("ici://") :]
        parts = rest.strip("/").split("/")
        if len(parts) != 2 or not parts[0].startswith("slice") or not parts[1].startswith("chip"):
            raise ValueError(f"bad ici endpoint: {s}")
        return EndPoint.ici(int(parts[0][5:]), int(parts[1][4:]))
    host, _, port = s.rpartition(":")
    if not host:
        raise ValueError(f"bad endpoint: {s}")
    return EndPoint.tcp(host, int(port))
