"""The port's native murmur3_32 held against the JAX package's.

The port builds ``utils/murmur3.c`` with the host C compiler on first
use and binds it with ctypes; the JAX package hashes in pure Python.
Every value must be identical: ring routing (``cache/channel.py:133``),
shard routing (``client/combo.py``, ``resharding/migration.py:105``) and
the migration's read-back checksum (``migration.py:131``) depend on it.
Inputs are seeded: every length 0-64 (so every 0-3-byte tail after 0-16
blocks), 1 MiB, seeds 0 and 1, and the keys the cache channel routes.
"""

import numpy as np
import pytest

from incubator_brpc_tpu.utils.hashes import murmur3_32 as jax_murmur3_32
from incubator_brpc_tpu_torch.utils import hashes


@pytest.fixture(scope="module", autouse=True)
def native():
    assert hashes.murmur3_native(), "the native murmur3_32 did not build"


def _blob(n, seed):
    return np.random.default_rng(1000 + n + 7 * seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tail", [0, 1, 2, 3])
def test_every_tail_equals_the_jax_hash(seed, tail):
    for blocks in range(17):
        data = _blob(4 * blocks + tail, seed)
        want = jax_murmur3_32(data, seed)
        assert hashes.murmur3_32(data, seed) == want, len(data)
        assert hashes.murmur3_32_py(data, seed) == want, len(data)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_mib_value_equals_the_jax_hash(seed):
    data = _blob(1 << 20, seed)
    assert hashes.murmur3_32(data, seed) == jax_murmur3_32(data, seed)


def test_routed_keys_equal_the_jax_hash():
    # the keys CacheChannel routes (murmur3_32(bytes(key)), seed 0), the
    # shard keys of the PS channels (str(key).encode() under seeds 0, 1)
    # and the ring's virtual nodes (b"<endpoint>-<replica>")
    keys = [b"k%d" % i for i in range(512)]
    keys += [f"key{i}".encode() for i in range(256)]
    keys += [b"ici://slice0/chip%d-%d" % (c, r) for c in range(4) for r in range(100)]
    keys += [bytes(bytearray(b"raw\x00\xff")), b""]
    for seed in (0, 1):
        for k in keys:
            assert hashes.murmur3_32(k, seed) == jax_murmur3_32(k, seed), k


def test_buffer_types_and_wide_seeds():
    data = b"device-value"
    want = jax_murmur3_32(data, 0xDEADBEEF)
    assert hashes.murmur3_32(bytearray(data), 0xDEADBEEF) == want
    assert hashes.murmur3_32(memoryview(data), 0xDEADBEEF) == want
    # seeds wrap to 32 bits as the Python hash masks them
    assert hashes.murmur3_32(data, (1 << 32) + 5) == jax_murmur3_32(data, 5)


def test_a_failed_build_logs_once_and_runs_the_python_hash(monkeypatch, tmp_path):
    from incubator_brpc_tpu_torch.utils import logging as plog

    logged = []
    monkeypatch.setattr(hashes, "_murmur_c", None)
    monkeypatch.setattr(hashes, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(hashes, "_MURMUR_SRC", tmp_path / "missing.c")
    monkeypatch.setattr(plog, "log_error", lambda msg, *a: logged.append(msg % a))
    assert hashes.murmur3_native() is False
    data = _blob(37, 0)
    assert hashes.murmur3_32(data) == jax_murmur3_32(data)
    assert hashes.murmur3_32(b"again") == jax_murmur3_32(b"again")
    assert len(logged) == 1 and "Python" in logged[0]
