"""The sanitizer build modes of the port's native code.

``BRPC_NATIVE_SANITIZE`` (asan or tsan) selects the compiler flags that
the native engine (``native/``) and ``utils/murmur3.c`` are built with,
and so a target name of their own.  Loading an ASan/TSan library into a
stock CPython also needs the runtime preloaded: see
``native.sanitizer_preload``.
"""

from __future__ import annotations

import os

SANITIZE = os.environ.get("BRPC_NATIVE_SANITIZE", "").strip().lower()
SAN_FLAGS = {
    "": [],
    # O1 keeps stacks honest; no-recover makes every UBSan hit fatal so
    # the test lane cannot pass over a diagnosed error
    "asan": [
        "-fsanitize=address,undefined",
        "-fno-sanitize-recover=undefined",
        "-fno-omit-frame-pointer",
        "-g",
        "-O1",
    ],
    "tsan": ["-fsanitize=thread", "-fno-omit-frame-pointer", "-g", "-O1"],
}


def check_mode(mode: str) -> str:
    """``mode`` itself when it is a build mode; raises ValueError naming
    the modes otherwise."""
    if mode not in SAN_FLAGS:
        raise ValueError(
            f"BRPC_NATIVE_SANITIZE={mode!r}: expected one of "
            f"{sorted(k for k in SAN_FLAGS if k)} or unset"
        )
    return mode
