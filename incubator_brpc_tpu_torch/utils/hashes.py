"""Hashes & randoms (analog of butil crc32c/murmurhash3/fast_rand).

crc32c (Castagnoli) matches the reference's butil::crc32c used for
framing checksums; murmur3_32 matches butil::MurmurHash32 used by
consistent-hashing load balancers. A C++ native implementation (see
native/) is used when present; these pure-Python versions are the
always-available fallback and the source of truth for test vectors.

murmur3_32 runs natively: ``murmur3.c`` beside this file is built with
the host C compiler (``cc``) on first use into ``_build/`` and bound
with ctypes.  If the build fails, that is logged once and the
pure-Python ``murmur3_32_py`` runs instead; ``murmur3_native()`` says
which one is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import random
import struct
import subprocess
import threading

# ---- crc32c (Castagnoli, poly 0x1EDC6F41 reflected = 0x82F63B78) ----------
_CRC32C_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC32C_TABLE.append(crc)


_build_table()

_native = None


def _load_native():
    global _native
    if _native is None:
        try:
            from incubator_brpc_tpu_torch.native import lib as _nlib

            _native = _nlib
        except Exception:
            _native = False
    return _native


def crc32c(data: bytes, crc: int = 0) -> int:
    n = _load_native()
    if n:
        return n.crc32c(data, crc)
    crc ^= 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


# ---- murmur3 32-bit (butil::MurmurHash32) ---------------------------------
_MURMUR_SRC = pathlib.Path(__file__).resolve().with_name("murmur3.c")
_BUILD_DIR = _MURMUR_SRC.parent / "_build"
_CC_FLAGS = ["-O2", "-shared", "-fPIC"]
_murmur_lock = threading.Lock()
_murmur_c = None  # None: not tried yet; False: the build failed


def _build_murmur3():
    """Build murmur3.c (once per source and flags) and bind it; raises
    OSError or CalledProcessError when it cannot."""
    src = _MURMUR_SRC.read_bytes()
    digest = hashlib.sha256(src + " ".join(_CC_FLAGS).encode()).hexdigest()
    target = _BUILD_DIR / f"libmurmur3-{digest[:16]}.so"
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a per-process temporary, then an atomic rename: concurrent
        # builders (test workers) never see a half-written library
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            ["cc", *_CC_FLAGS, "-o", str(tmp), str(_MURMUR_SRC)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)
    fn = ctypes.CDLL(str(target)).brpc_murmur3_32
    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    fn.restype = ctypes.c_uint32
    return fn


def _murmur3_fn():
    global _murmur_c
    with _murmur_lock:
        if _murmur_c is None:
            try:
                _murmur_c = _build_murmur3()
            except (OSError, subprocess.SubprocessError) as e:
                from incubator_brpc_tpu_torch.utils.logging import log_error

                err = getattr(e, "stderr", None) or b""
                log_error(
                    "native murmur3_32 unavailable, using the Python one: "
                    "%r %s", e, err.decode(errors="replace")[-400:],
                )
                _murmur_c = False
        return _murmur_c


def murmur3_native() -> bool:
    """True when murmur3_32 runs the native build (builds it now if it
    was not tried yet)."""
    return bool(_murmur3_fn())


def murmur3_32(data: bytes, seed: int = 0) -> int:
    fn = _murmur_c if _murmur_c is not None else _murmur3_fn()
    if not fn:
        return murmur3_32_py(data, seed)
    if not isinstance(data, bytes):
        data = bytes(data)
    return fn(data, len(data), seed & 0xFFFFFFFF)


def murmur3_32_py(data: bytes, seed: int = 0) -> int:
    """The pure-Python murmur3_32: the fallback, and the reference the
    native build is tested against."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    nblocks = len(data) // 4
    for i in range(nblocks):
        k = struct.unpack_from("<I", data, i * 4)[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[nblocks * 4 :]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


# ---- fast_rand (butil/fast_rand.h) ----------------------------------------
_rng = random.Random()


def fast_rand() -> int:
    return _rng.getrandbits(64)


def fast_rand_less_than(n: int) -> int:
    return _rng.randrange(n) if n > 0 else 0


def fast_rand_double() -> float:
    return _rng.random()


# ---- fmix64 (counter-mode deterministic hashing) ---------------------------
# Used wherever a decision must be a PURE function of (seed, counter):
# chaos fault schedules (chaos/plan.py) and seeded retry-backoff jitter
# (client/retry.py) — replays reproduce the identical sequence.
_MASK64 = (1 << 64) - 1

# golden-ratio counter stride fed to fmix64 (engine.cpp fault_check
# mirrors it); replay-critical — defined ONCE for all Python users
GOLDEN64 = 0x9E3779B97F4A7C15


def fmix64(x: int) -> int:
    """MurmurHash3's fmix64 finalizer: a high-quality 64-bit mix."""
    x &= _MASK64
    x ^= x >> 33
    x = (x * 0xFF51AFD7ED558CCD) & _MASK64
    x ^= x >> 33
    x = (x * 0xC4CEB9FE1A85EC53) & _MASK64
    x ^= x >> 33
    return x
