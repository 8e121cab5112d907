"""Memcache binary-protocol tests, carried by hand from ``tests/test_memcache.py``
(reference pattern: brpc_memcache_unittest.cpp — byte-exact packing + a
wire-faithful in-process memcached).

The host cases are the JAX file's with the port's package name.  The two
device cases give the HBM store, the server port and the channels the
device the case runs on (the CPU, or the card).
"""

import socket as pysocket
import struct
import threading

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.protocols import memcache as M


def test_pack_get_bytes():
    req = M.MemcacheRequest()
    req.get("key")
    wire = req.SerializeToString()
    # magic 0x80, opcode 0x00, keylen 3, extras 0, bodylen 3, then "key"
    assert wire[:24] == struct.pack(">BBHBBHIIQ", 0x80, 0x00, 3, 0, 0, 0, 3, 0, 0)
    assert wire[24:] == b"key"


def test_pack_set_bytes():
    req = M.MemcacheRequest()
    req.set("k", b"vv", flags=0xDEAD, exptime=60)
    wire = req.SerializeToString()
    assert wire[:24] == struct.pack(
        ">BBHBBHIIQ", 0x80, 0x01, 1, 8, 0, 0, 8 + 1 + 2, 0, 0
    )
    assert wire[24:32] == struct.pack(">II", 0xDEAD, 60)
    assert wire[32:] == b"k" + b"vv"


def test_pack_incr_bytes():
    req = M.MemcacheRequest()
    req.incr("n", delta=5, initial=100, exptime=0)
    wire = req.SerializeToString()
    assert wire[1] == M.OP_INCREMENT
    assert wire[24:44] == struct.pack(">QQI", 5, 100, 0)


class MiniMemcached:
    """A wire-faithful in-process memcached (binary protocol subset)."""

    def __init__(self):
        self.store = {}
        self.sock = pysocket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(4)
        self.port = self.sock.getsockname()[1]
        self._stop = False
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(conn,), daemon=True).start()

    def _client(self, conn):
        buf = b""
        try:
            while True:
                while len(buf) < 24:
                    chunk = conn.recv(65536)
                    if not chunk:
                        return
                    buf += chunk
                (magic, op, klen, elen, _dt, _st, blen, opq, cas) = M._HEADER.unpack(
                    buf[:24]
                )
                while len(buf) < 24 + blen:
                    buf += conn.recv(65536)
                body, buf = buf[24 : 24 + blen], buf[24 + blen :]
                extras = body[:elen]
                key = body[elen : elen + klen]
                value = body[elen + klen :]
                conn.sendall(self._respond(op, key, extras, value, opq, cas))
        finally:
            conn.close()

    def _respond(self, op, key, extras, value, opq, cas) -> bytes:
        def resp(status=0, rex=b"", rval=b"", rcas=0):
            return (
                M._HEADER.pack(0x81, op, 0, len(rex), 0, status,
                               len(rex) + len(rval), opq, rcas)
                + rex + rval
            )

        if op == M.OP_GET:
            if key not in self.store:
                return resp(M.STATUS_KEY_NOT_FOUND)
            flags, val = self.store[key]
            return resp(0, struct.pack(">I", flags), val, rcas=42)
        if op in (M.OP_SET, M.OP_ADD, M.OP_REPLACE):
            if op == M.OP_ADD and key in self.store:
                return resp(M.STATUS_KEY_EXISTS)
            if op == M.OP_REPLACE and key not in self.store:
                return resp(M.STATUS_KEY_NOT_FOUND)
            flags = struct.unpack(">I", extras[:4])[0] if len(extras) >= 4 else 0
            self.store[key] = (flags, value)
            return resp(rcas=43)
        if op == M.OP_DELETE:
            if self.store.pop(key, None) is None:
                return resp(M.STATUS_KEY_NOT_FOUND)
            return resp()
        if op in (M.OP_INCREMENT, M.OP_DECREMENT):
            delta, initial, _exp = struct.unpack(">QQI", extras)
            flags, cur = self.store.get(key, (0, None))
            if cur is None:
                n = initial
            else:
                n = int(cur) + (delta if op == M.OP_INCREMENT else -delta)
            self.store[key] = (0, b"%d" % n)
            return resp(rval=struct.pack(">Q", n))
        if op == M.OP_VERSION:
            return resp(rval=b"1.6.0-mini")
        return resp(0x0081)  # unknown command

    def close(self):
        self._stop = True
        self.sock.close()


def test_memcache_client_end_to_end():
    srv = MiniMemcached()
    try:
        ch = Channel(ChannelOptions(protocol="memcache", timeout_ms=5000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0

        req = M.MemcacheRequest()
        req.set("k", b"hello", flags=7, exptime=0)
        req.get("k")
        req.incr("n", delta=3, initial=10)
        req.version()
        resp = M.MemcacheResponse()
        ctrl = Controller()
        ch.call_method(M.memcache_method_spec(), ctrl, req, resp)
        assert not ctrl.failed(), ctrl.error_text()
        assert resp.op_count == 4
        ok, cas = resp.pop_store()
        assert ok and cas == 43
        ok, value, flags, cas = resp.pop_get()
        assert (ok, value, flags, cas) == (True, b"hello", 7, 42)
        ok, n = resp.pop_counter()
        assert (ok, n) == (True, 10)  # initial (key absent)
        ok, ver = resp.pop_version()
        assert ok and ver == "1.6.0-mini"

        # miss path
        req2 = M.MemcacheRequest()
        req2.get("missing")
        resp2 = M.MemcacheResponse()
        ctrl2 = Controller()
        ch.call_method(M.memcache_method_spec(), ctrl2, req2, resp2)
        assert not ctrl2.failed(), ctrl2.error_text()
        ok, value, _, _ = resp2.pop_get()
        assert not ok
    finally:
        srv.close()


def test_memcache_concurrent_pipelining():
    srv = MiniMemcached()
    try:
        ch = Channel(ChannelOptions(protocol="memcache", timeout_ms=8000))
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        n = 12
        results = [None] * n

        def worker(i):
            req = M.MemcacheRequest()
            req.set(f"k{i}", f"v{i}".encode())
            req.get(f"k{i}")
            resp = M.MemcacheResponse()
            ctrl = Controller()
            ch.call_method(M.memcache_method_spec(), ctrl, req, resp)
            ok_s, _ = resp.pop_store()
            ok_g, val, _, _ = resp.pop_get()
            results[i] = (ctrl.failed(), ok_s, ok_g, val)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        for i, r in enumerate(results):
            assert r == (False, True, True, f"v{i}".encode()), (i, r)
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# OUR memcache server (ServerOptions.memcache_service) — protocol parity
# with the redis front of the cache tier
# ---------------------------------------------------------------------------

import pytest

from incubator_brpc_tpu_torch.cache import HBMCacheMemcacheService, HBMCacheService, HBMCacheStore
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.chaos.storm import admission_pressure_plan
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef

from torch_carry import torch_device  # noqa: F401  (fixture)

# process-global fabric: this module owns slices 90+
_slice_counter = [90]


def _fresh_slice():
    _slice_counter[0] += 1
    return _slice_counter[0]


@pytest.fixture(autouse=True)
def always_disarm():
    yield
    injector.disarm()


def _mc_channel(addr, **kw):
    kw.setdefault("timeout_ms", 30000)
    ch = Channel(ChannelOptions(protocol="memcache", **kw))
    assert ch.init(addr) == 0
    return ch


def _mc_call(ch, req):
    resp = M.MemcacheResponse()
    ctrl = Controller()
    ch.call_method(M.memcache_method_spec(), ctrl, req, resp)
    assert not ctrl.failed(), ctrl.error_text()
    return resp


def test_memcache_server_get_set_delete_flush_roundtrip():
    srv = Server(ServerOptions(memcache_service=M.MemcacheService()))
    assert srv.start(0) == 0
    try:
        ch = _mc_channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        req = M.MemcacheRequest()
        req.set("k", b"v1", flags=9)
        req.get("k")
        req.delete("k")
        req.get("k")          # deleted → miss
        req.set("k2", b"v2")
        req.flush_all()
        req.get("k2")         # flushed → miss
        req.version()
        resp = _mc_call(ch, req)
        assert resp.op_count == 8
        ok, cas = resp.pop_store()
        assert ok and cas > 0
        assert resp.pop_get() == (True, b"v1", 9, cas)
        ok, _ = resp.pop_store()  # delete
        assert ok
        assert resp.pop_get()[0] is False
        ok, _ = resp.pop_store()
        assert ok
        ok, _ = resp.pop_store()  # flush
        assert ok
        assert resp.pop_get()[0] is False
        assert resp.pop_version() == (True, "1.6.0-tpu")
    finally:
        srv.stop()


def test_memcache_server_hostile_bytes_corpus():
    """Keys/values that look like protocol structure must round-trip
    byte-exact: fake magics, embedded headers, CRLFs, NULs, the works."""
    srv = Server(ServerOptions(memcache_service=M.MemcacheService()))
    assert srv.start(0) == 0
    corpus = [
        (b"nul\x00key", b"\x00" * 16),
        (b"crlf\r\nkey", b"line1\r\nline2\r\n"),
        (b"\x80\x81magic", b"\x80" + bytes(23)),  # value = fake request header
        (b"hdr", M._HEADER.pack(0x81, 0, 0, 0, 0, 0, 5, 0, 0) + b"xyzzy"),
        (b"empty", b""),
        (b"k" * 250, bytes(range(256)) * 4),
        (b"resp\x0d", b"-ERR not redis\r\n+OK\r\n$5\r\n"),
    ]
    try:
        ch = _mc_channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        req = M.MemcacheRequest()
        for k, v in corpus:
            req.set(k, v)
            req.get(k)
        resp = _mc_call(ch, req)
        assert resp.op_count == 2 * len(corpus)
        for k, v in corpus:
            ok, _ = resp.pop_store()
            assert ok, k
            ok, got, _, _ = resp.pop_get()
            assert ok and got == v, (k, got)
    finally:
        srv.stop()


def test_memcache_device_value_path_over_ici(torch_device):
    """Mirror of the redis device test: an ICI peer's GET serves the
    value as a DeviceRef region (HBM-resident), a TCP client gets exact
    bytes through the store's spill path — same store, same bytes."""
    s = _fresh_slice()
    svc = HBMCacheMemcacheService(device=torch_device)
    srv = Server(ServerOptions(memcache_service=svc))
    assert srv.start_ici(s, 1, device=torch_device) == 0
    try:
        ch = _mc_channel(f"ici://slice{s}/chip1", ici_device=torch_device)
        payload = b"\x07\x09" * 32
        req = M.MemcacheRequest()
        req.set("dev", payload)
        req.get("dev")
        resp = _mc_call(ch, req)
        ok, _ = resp.pop_store()
        assert ok
        op = resp.op(1)
        arr = op.device_array()
        assert arr is not None, "ICI memcache GET materialized to host bytes"
        assert int(arr.nbytes) == len(payload)
        assert op.bytes_value() == payload
        # the value landed in the shared HBM store as a device entry
        got = svc.store.get(b"dev")
        assert got is not None and not isinstance(got, bytes)
    finally:
        srv.stop()
    # same store behind TCP: the host client gets exact bytes
    srv2 = Server(ServerOptions(memcache_service=svc))
    assert srv2.start(0) == 0
    try:
        ch2 = _mc_channel(f"127.0.0.1:{srv2.port}", timeout_ms=5000,
                          connection_group="mc-tcp")
        req = M.MemcacheRequest()
        req.get("dev")
        resp = _mc_call(ch2, req)
        op = resp.op(0)
        assert op.device_array() is None
        assert op.bytes_value() == b"\x07\x09" * 32
        # delete + flush hit the shared store too
        req = M.MemcacheRequest()
        req.delete("dev")
        req.flush_all()
        resp = _mc_call(ch2, req)
        ok, _ = resp.pop_store()
        assert ok
        assert len(svc.store) == 0
    finally:
        srv2.stop()


def test_memcache_and_redis_fronts_share_one_store(torch_device):
    """One HBMCacheStore behind BOTH protocols on one server: a redis
    SET is a memcache GET hit (and vice versa) — the cluster cache is
    protocol-agnostic."""
    from incubator_brpc_tpu_torch.protocols import redis as R

    s = _fresh_slice()
    store = HBMCacheStore(device=torch_device)
    srv = Server(ServerOptions(
        redis_service=HBMCacheService(store=store),
        memcache_service=HBMCacheMemcacheService(store=store),
    ))
    assert srv.start_ici(s, 1, device=torch_device) == 0
    try:
        rch = Channel(ChannelOptions(protocol="redis", timeout_ms=30000,
                                     ici_device=torch_device))
        assert rch.init(f"ici://slice{s}/chip1") == 0
        rreq = R.RedisRequest()
        rreq.add_command("SET", b"shared", b"one-store" * 7)
        rresp = R.RedisResponse()
        rctrl = Controller()
        rch.call_method(R.redis_method_spec(), rctrl, rreq, rresp)
        assert not rctrl.failed(), rctrl.error_text()

        mch = _mc_channel(f"ici://slice{s}/chip1", ici_device=torch_device)
        req = M.MemcacheRequest()
        req.get("shared")
        req.set("back", b"memcache-wrote-this")
        resp = _mc_call(mch, req)
        op = resp.op(0)
        assert op.device_array() is not None
        assert op.bytes_value() == b"one-store" * 7

        rreq = R.RedisRequest()
        rreq.add_command("GET", b"back")
        rresp = R.RedisResponse()
        rctrl = Controller()
        rch.call_method(R.redis_method_spec(), rctrl, rreq, rresp)
        assert not rctrl.failed(), rctrl.error_text()
        arr = rresp.reply(0).device_array()
        assert arr is not None
        assert bytes(DeviceRef(arr).view()) == b"memcache-wrote-this"
    finally:
        srv.stop()


def test_memcache_admission_shed_returns_busy_status():
    srv = Server(ServerOptions(memcache_service=M.MemcacheService()))
    assert srv.start(0) == 0
    try:
        ch = _mc_channel(f"127.0.0.1:{srv.port}", timeout_ms=5000)
        req = M.MemcacheRequest()
        req.set("k", b"v")
        _mc_call(ch, req)
        # shed exactly the GET opcode (admission method "memcache.0x00")
        injector.arm(admission_pressure_plan(
            seed=13, reject_pct=1.0, method="memcache.0x00", max_hits=1,
        ))
        req = M.MemcacheRequest()
        req.get("k")
        resp = _mc_call(ch, req)
        op = resp.op(0)
        assert op.status == 0x0085 and op.bytes_value() == b"Busy"
        injector.disarm()
        req = M.MemcacheRequest()
        req.get("k")
        resp = _mc_call(ch, req)
        assert resp.pop_get()[:2] == (True, b"v")
    finally:
        srv.stop()
