"""IOBuf unit tests, carried by hand from ``tests/test_iobuf.py``.

The host cases are the JAX file's with the port's package name.  The
device cases hold a ``DeviceRef`` over a ``torch.Tensor`` (made from a seed
with numpy, on the CPU or on the card) and compare the bytes the port's
IOBuf gives with the JAX package's on the same values.
"""

import socket

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf, IOBufCutter, DEFAULT_BLOCK_SIZE

from torch_carry import torch_device  # noqa: F401  (fixture)


def _jax_bytes(values, *pieces):
    """What the JAX package's IOBuf gives for ``pieces`` (bytes, or None for
    the device segment over ``values``)."""
    import jax.numpy as jnp

    from incubator_brpc_tpu.utils.iobuf import IOBuf as JaxIOBuf

    b = JaxIOBuf()
    for p in pieces:
        if p is None:
            b.append_device(jnp.asarray(values))
        else:
            b.append(p)
    return b


def test_append_and_size():
    b = IOBuf()
    assert b.empty() and len(b) == 0
    b.append(b"hello")
    b.append(" world")
    assert len(b) == 11
    assert b.to_bytes() == b"hello world"
    assert b == b"hello world"


def test_append_spanning_blocks():
    b = IOBuf()
    b.append(b"ab")  # partial first block
    chunk = bytes(range(256)) * 40  # 10240 > remaining space in first block
    b.append(chunk)
    assert len(b) == 2 + len(chunk)
    assert b.to_bytes() == b"ab" + chunk
    assert b.backing_block_count() >= 2


def test_cutn_zero_copy_refs():
    b = IOBuf(b"abcdefghij")
    out = IOBuf()
    assert b.cutn(out, 4) == 4
    assert out.to_bytes() == b"abcd"
    assert b.to_bytes() == b"efghij"
    # cut more than available
    assert b.cutn(out, 100) == 6
    assert out.to_bytes() == b"abcdefghij"
    assert b.empty()


def test_pop_front_back():
    b = IOBuf(b"0123456789")
    b.pop_front(3)
    b.pop_back(2)
    assert b.to_bytes() == b"34567"


def test_append_iobuf_shares_refs():
    a = IOBuf(b"shared-data")
    c = IOBuf()
    c.append(a)
    assert c.to_bytes() == b"shared-data"
    assert len(a) == 11  # source untouched
    # mutating either buffer must not corrupt the other (refs are cloned,
    # blocks shared)
    a.pop_front(3)
    assert c.to_bytes() == b"shared-data" and len(c) == 11
    out = IOBuf()
    c.cutn(out, 11)  # must not raise / desync
    assert out.to_bytes() == b"shared-data"
    assert a.to_bytes() == b"red-data"


def test_device_arrays_raises_on_split_segment(torch_device):
    import pytest as _pytest

    values = np.arange(8, dtype=np.int32)
    b = IOBuf()
    b.append_device(torch.from_numpy(values).to(torch_device))
    b.pop_front(1)  # split the device segment
    assert b.has_device_payload()
    with _pytest.raises(ValueError):
        b.device_arrays()
    assert len(b.device_segments()) == 1
    assert len(b.device_segments()[0].view()) == 31
    if torch_device.type == "cpu":
        ref = _jax_bytes(values, None)
        ref.pop_front(1)
        with _pytest.raises(ValueError):
            ref.device_arrays()
        assert bytes(b.device_segments()[0].view()) == bytes(ref.device_segments()[0].view())


def test_user_data_zero_copy():
    big = bytearray(b"x" * 100000)
    b = IOBuf()
    b.append_user_data(big)
    assert len(b) == 100000
    assert b.backing_block_count() == 1
    big[0:1] = b"y"  # zero copy: change visible
    assert b.copy_to(1) == b"y"


def test_fetch_and_cutter():
    b = IOBuf(b"PRPC\x00\x00\x00\x08payload!")
    cut = IOBufCutter(b)
    assert cut.peek(4) == b"PRPC"
    assert cut.cut_bytes(4) == b"PRPC"
    assert cut.cut_bytes(4) == b"\x00\x00\x00\x08"
    assert cut.cut_buf(8).to_bytes() == b"payload!"
    assert cut.cut_bytes(1) is None


def test_copy_to_with_pos():
    b = IOBuf(b"hello world")
    assert b.copy_to(5, pos=6) == b"world"


def test_socket_io_roundtrip():
    left, right = socket.socketpair()
    left.setblocking(False)
    right.setblocking(False)
    payload = bytes(range(256)) * 100
    out = IOBuf(payload)
    total = 0
    while not out.empty():
        try:
            total += out.cut_into_socket(left)
        except BlockingIOError:
            break
    inbuf = IOBuf()
    got = 0
    while got < total:
        try:
            n = inbuf.append_from_socket(right, 1 << 16)
        except BlockingIOError:
            break
        if n == 0:
            break
        got += n
    assert inbuf.to_bytes() == payload[:total]
    left.close()
    right.close()


def test_device_ref_lazy_materialization(torch_device):
    values = np.arange(16, dtype=np.int32)
    arr = torch.from_numpy(values).to(torch_device)
    b = IOBuf()
    b.append(b"hdr:")
    b.append_device(arr)
    assert len(b) == 4 + 64
    assert b.has_device_payload()
    assert len(b.device_arrays()) == 1
    raw = b.to_bytes()
    assert raw[:4] == b"hdr:"
    assert np.frombuffer(raw[4:], dtype=np.int32).tolist() == list(range(16))
    if torch_device.type == "cpu":
        assert raw == _jax_bytes(values, b"hdr:", None).to_bytes()


def test_device_ref_survives_cut(torch_device):
    values = np.random.default_rng(8).standard_normal(8).astype(np.float32)
    arr = torch.from_numpy(values).to(torch_device)
    b = IOBuf(b"xx")
    b.append_device(arr)
    out = IOBuf()
    b.cutn(out, 2)
    assert out.to_bytes() == b"xx"
    assert len(b.device_arrays()) == 1  # still whole-array ref
    assert b.device_arrays()[0] is arr
    if torch_device.type == "cpu":
        ref = _jax_bytes(values, b"xx", None)
        ref.cutn(type(ref)(), 2)
        assert b.to_bytes() == ref.to_bytes() == values.tobytes()


def test_swap_and_clear():
    a, b = IOBuf(b"aaa"), IOBuf(b"bb")
    a.swap(b)
    assert a.to_bytes() == b"bb" and b.to_bytes() == b"aaa"
    a.clear()
    assert a.empty()
