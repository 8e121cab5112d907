"""Protocol fronts for the HBM cache store: redis + memcache.

Port of the JAX package's ``cache/service.py``.  One `HBMCacheStore`
can sit behind both protocols on the same server
(``ServerOptions.redis_service`` and ``.memcache_service``), so any
off-the-shelf redis or binary-memcached client reads the cluster cache.

Reply residency is decided PER CONNECTION: an ICI-peer socket
(``sock.ici_port``) gets the stored tensor as a DeviceRef segment,
which the port's fabric moves device to device through the
copy+checksum kernel (K1, ``ops/csrc/transfer.cu``) with zero pulls,
while a host transport (TCP client) gets exact bytes through the
store's manifested ``cache.host-spill`` choke point.  The redis and
memcache device-value checks are duck-typed on ``nbytes`` + ``dtype``,
which a ``torch.Tensor`` has, so the protocol modules are the JAX
package's unchanged.  A store built here without a ``device`` uses the
card of chip 0 and raises without one.

Redis command surface: GET/SET/DEL/EXISTS/MGET/STRLEN/FLUSHALL/DBSIZE
plus the device-batched DMGET (see `HBMCacheService.dmget`): same-length
hit groups coalesce through the store's fused gather into ONE stacked
bulk, with a lengths header the client unpacks rows from.  DMSET is the
write-side mirror — one round trip ingests a whole key range, so the
resharding coordinator's bulk COPY crosses the wire per DESTINATION,
not per key.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
from incubator_brpc_tpu_torch.protocols.memcache import (
    OP_GET,
    STATUS_KEY_NOT_FOUND,
    STATUS_OK,
    MemcacheService,
)
from incubator_brpc_tpu_torch.protocols.redis import (
    REPLY_STRING,
    RedisReply,
    RedisService,
)
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef


def _is_ici(sock) -> bool:
    return getattr(sock, "ici_port", None) is not None


class HBMCacheService(RedisService):
    """Redis front of the cache tier (connection-aware: the protocol
    routes through ``handle_conn`` so replies know their transport)."""

    def __init__(self, store: Optional[HBMCacheStore] = None, **store_kwargs):
        self.store = store if store is not None else HBMCacheStore(**store_kwargs)
        # the current connection, stashed per worker thread so command
        # methods (fixed handle() signature) can see their transport
        self._tls = threading.local()

    @property
    def _sock(self):
        return getattr(self._tls, "sock", None)

    # protocols.redis.process_request prefers this over handle()
    def handle_conn(self, command: str, args: List, sock) -> RedisReply:
        self._tls.sock = sock
        try:
            cmd = command.upper()
            if cmd == "DEL":  # python keyword, same aliasing as KVRedisService
                return RedisReply.integer(
                    sum(1 for k in args if self.store.delete(k))
                )
            return self.handle(command, args)
        finally:
            self._tls.sock = None

    def _value_reply(self, key: bytes) -> RedisReply:
        if _is_ici(self._sock):
            v = self.store.get(key)
            if v is None:
                return RedisReply.nil()
            return RedisReply(REPLY_STRING, v)  # device or host-mode bytes
        v = self.store.get_host(key)
        if v is None:
            return RedisReply.nil()
        return RedisReply.bulk(v)

    # ---- commands (lower-case name == wire name) ---------------------------
    def get(self, key):
        return self._value_reply(key)

    def set(self, key, value):
        if value is None:
            return RedisReply.error("ERR protocol error: SET value missing")
        if not self.store.set(key, value):
            return RedisReply.error("ERR value exceeds cache HBM budget")
        return RedisReply.status("OK")

    def exists(self, key):
        return 1 if key in self.store else 0

    def strlen(self, key):
        v = self.store.get(key)
        if v is None:
            return 0
        return len(v) if isinstance(v, bytes) else int(v.nbytes)

    def mget(self, *keys):
        # standard redis MGET: per-key bulks, no fusion (redis-cli
        # compatible); the fused device batch is DMGET
        return RedisReply.array([self._value_reply(k) for k in keys])

    def dmget(self, *keys):
        """Device multi-GET → [fused, lengths, payload]:

        fused=1: every hit shares one length; ``payload`` is ONE
        stacked (bucket, L) device bulk — hit i is row i in hit order
        (misses carry length -1 and consume no row).
        fused=0: ``payload`` is a per-key array of bulks like MGET."""
        if not keys:
            return RedisReply.error("ERR wrong number of arguments for 'dmget'")
        values, stacked = self.store.get_many(keys)
        lengths = RedisReply.array([
            RedisReply.integer(
                -1 if v is None
                else (len(v) if isinstance(v, bytes) else int(v.nbytes))
            )
            for v in values
        ])
        if stacked is not None and _is_ici(self._sock):
            return RedisReply.array([
                RedisReply.integer(1),
                lengths,
                RedisReply(REPLY_STRING, stacked),
            ])
        per_key = []
        for k, v in zip(keys, values):
            if v is None:
                per_key.append(RedisReply.nil())
            elif isinstance(v, bytes):
                per_key.append(RedisReply.bulk(v))
            elif _is_ici(self._sock):
                per_key.append(RedisReply(REPLY_STRING, v))
            else:
                per_key.append(RedisReply.bulk(self.store.get_host(k) or b""))
        return RedisReply.array([
            RedisReply.integer(0), lengths, RedisReply.array(per_key),
        ])

    def dmset(self, *kv):
        """Device multi-SET (``DMSET k1 v1 k2 v2 ...``) → integer count
        of values stored.  The ingest counterpart of DMGET: a resharding
        COPY range (or any batched writer) lands on a replica as ONE
        round trip instead of one SET per key — the collective bulk-move
        leg of the Pallas data plane.  Values over the HBM budget are
        skipped (count < pairs tells the client which path to retry)."""
        if not kv or len(kv) % 2:
            return RedisReply.error(
                "ERR wrong number of arguments for 'dmset'"
            )
        stored = 0
        for i in range(0, len(kv), 2):
            if self.store.set(kv[i], kv[i + 1]):
                stored += 1
        return RedisReply.integer(stored)

    def keys(self, *args):
        """Key census for the re-sharding coordinator (argument-free —
        no glob matching; migrations enumerate everything)."""
        return RedisReply.array(
            [RedisReply.bulk(k) for k in self.store.keys()]
        )

    def flushall(self, *args):
        self.store.flush()
        return RedisReply.status("OK")

    def dbsize(self):
        return len(self.store)


class HBMCacheMemcacheService(MemcacheService):
    """Memcache front over the SAME store: GET serves the device array
    to ICI peers (the binary framing ships it as the value region),
    spills to host bytes for everyone else; SET/DELETE/FLUSH hit the
    shared store so both protocols see one cache."""

    def __init__(self, store: Optional[HBMCacheStore] = None, **store_kwargs):
        super().__init__()
        self.store = store if store is not None else HBMCacheStore(**store_kwargs)

    def handle_op(self, op, sock):
        import struct

        code = op.opcode
        if code == OP_GET:
            if _is_ici(sock):
                v = self.store.get(op.key)
            else:
                v = self.store.get_host(op.key)
            if v is None:
                return STATUS_KEY_NOT_FOUND, b"", b"Not found", 0
            return STATUS_OK, struct.pack(">I", 0), v, 0
        if code == 0x01:  # OP_SET
            value = op.value
            if not isinstance(value, (bytes, DeviceRef)):
                value = bytes(value)
            if not self.store.set(op.key, value):
                return 0x0005, b"", b"", 0  # ITEM_NOT_STORED: over budget
            return STATUS_OK, b"", b"", 0
        if code == 0x04:  # OP_DELETE
            ok = self.store.delete(op.key)
            return (STATUS_OK if ok else STATUS_KEY_NOT_FOUND), b"", b"", 0
        if code == 0x08:  # OP_FLUSH
            self.store.flush()
            return STATUS_OK, b"", b"", 0
        return super().handle_op(op, sock)
