"""Compression registry (reference src/brpc/compress.h:43 +
policy/gzip_compress.* / snappy_compress.*).

Handlers operate on IOBuf payloads; registered by type id matching the
reference's CompressType enum (options.proto): 0=none, 1=snappy,
2=gzip, 3=zlib. Snappy is gated on the optional python binding; the
always-available codecs are gzip/zlib via stdlib.
"""

from __future__ import annotations

import gzip as _gzip
import zlib as _zlib
from typing import Callable, Dict, Optional, Tuple

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

COMPRESS_TYPE_NONE = 0
COMPRESS_TYPE_SNAPPY = 1
COMPRESS_TYPE_GZIP = 2
COMPRESS_TYPE_ZLIB = 3

# name → (type id), for ChannelOptions string configs
_BY_NAME = {
    "none": COMPRESS_TYPE_NONE,
    "snappy": COMPRESS_TYPE_SNAPPY,
    "gzip": COMPRESS_TYPE_GZIP,
    "zlib": COMPRESS_TYPE_ZLIB,
}

_handlers: Dict[int, Tuple[Callable, Callable]] = {}


def register_compress_handler(ctype: int, compress: Callable, decompress: Callable):
    """Analog of RegisterCompressHandler (compress.h:43)."""
    _handlers[ctype] = (compress, decompress)


def compress(buf: IOBuf, ctype: int) -> Optional[IOBuf]:
    if ctype == COMPRESS_TYPE_NONE:
        return buf
    h = _handlers.get(ctype)
    if h is None:
        return None
    return h[0](buf)


def decompress(buf: IOBuf, ctype: int) -> Optional[IOBuf]:
    if ctype == COMPRESS_TYPE_NONE:
        return buf
    h = _handlers.get(ctype)
    if h is None:
        return None
    return h[1](buf)


def compress_type_by_name(name: str) -> int:
    return _BY_NAME.get(name.lower(), COMPRESS_TYPE_NONE)


# ---- built-in handlers -----------------------------------------------------

register_compress_handler(
    COMPRESS_TYPE_GZIP,
    lambda b: IOBuf(_gzip.compress(b.to_bytes())),
    lambda b: IOBuf(_gzip.decompress(b.to_bytes())),
)
register_compress_handler(
    COMPRESS_TYPE_ZLIB,
    lambda b: IOBuf(_zlib.compress(b.to_bytes())),
    lambda b: IOBuf(_zlib.decompress(b.to_bytes())),
)

try:  # optional dependency; reference vendors snappy in butil/third_party
    import snappy as _snappy  # type: ignore

    register_compress_handler(
        COMPRESS_TYPE_SNAPPY,
        lambda b: IOBuf(_snappy.compress(b.to_bytes())),
        lambda b: IOBuf(_snappy.decompress(b.to_bytes())),
    )
except ImportError:
    pass
