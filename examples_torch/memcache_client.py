"""Memcache client (reference example/memcache_c++): binary-protocol
set/get through a Channel. The demo runs a minimal in-process memcache
responder so the example is self-contained (point init() at a real
memcached in production; add auth=CouchbaseAuthenticator(...) for
couchbase buckets).

    python examples_torch/memcache_client.py
"""

import os
import socket
import struct
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.protocols.memcache import (
    MemcacheRequest,
    MemcacheResponse,
    memcache_method_spec,
)

STORE = {}


def serve(ls):
    conn, _ = ls.accept()
    buf = b""
    while True:
        try:
            chunk = conn.recv(65536)
        except OSError:
            return
        if not chunk:
            return
        buf += chunk
        while len(buf) >= 24:
            magic, op, klen = struct.unpack_from(">BBH", buf, 0)
            extlen = buf[4]
            blen = struct.unpack_from(">I", buf, 8)[0]
            opaque = struct.unpack_from(">I", buf, 12)[0]
            if len(buf) < 24 + blen:
                break
            body = buf[24 : 24 + blen]
            buf = buf[24 + blen :]
            key = body[extlen : extlen + klen]
            if op == 0x01:  # SET
                STORE[key] = body[extlen + klen :]
                resp_body = b""
                status = 0
            else:  # GET
                val = STORE.get(key)
                if val is None:
                    status, resp_body = 1, b""
                else:
                    status, resp_body = 0, struct.pack(">I", 0) + val
            ext = 4 if (op == 0x00 and status == 0) else 0
            conn.sendall(
                struct.pack(
                    ">BBHBBHIIQ", 0x81, op, 0, ext, 0, status,
                    len(resp_body), opaque, 1,
                )
                + resp_body
            )


if __name__ == "__main__":
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    threading.Thread(target=serve, args=(ls,), daemon=True).start()

    ch = Channel(ChannelOptions(timeout_ms=5000, protocol="memcache"))
    assert ch.init(f"127.0.0.1:{ls.getsockname()[1]}") == 0

    req = MemcacheRequest()
    req.set(b"motd", b"memcache over tpu-brpc")
    resp = MemcacheResponse()
    c = Controller()
    ch.call_method(memcache_method_spec(), c, req, resp)
    assert not c.failed(), c.error_text()

    req2 = MemcacheRequest()
    req2.get(b"motd")
    resp2 = MemcacheResponse()
    c2 = Controller()
    ch.call_method(memcache_method_spec(), c2, req2, resp2)
    assert not c2.failed(), c2.error_text()
    ok, val, flags, cas = resp2.pop_get()
    assert ok and val == b"memcache over tpu-brpc", (ok, val)
    print("memcache set/get round trip:", val.decode())
    ch.close()
    ls.close()
