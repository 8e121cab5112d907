"""CacheChannel — the cluster cache's client data plane.

A thin typed wrapper over a redis-protocol `Channel` with naming-fed
membership: every key routes by its murmur3 hash (``request_code`` =
``murmur3_32(key)``) through the channel's load balancer — by default
``mesh_locality``, the ConsistentHashingLB ring re-ranked by ICI
locality and shed pressure (client/load_balancer.py).  GETs from an
ICI replica come back as tensors on the channel's device
(``ChannelOptions.ici_device``; DeviceRef bulk segments, zero pulls);
the host-bytes accessors materialize through the manifested scopes
only.

``get_many`` issues one DMGET: the server coalesces same-length hits
through the store's fused gather into ONE stacked device bulk, which
`MGetResult` slices rows out of on the consumer device.  ``set_many``
mirrors it with DMSET — one round trip per routed replica — so bulk
movers (resharding COPY) cross the wire per destination, not per key.

Replication (docs/replication.md): a cache position gains HA by
listing its member CacheChannels in ``replication.
replicated_cache_group`` — the CacheShardStore adapter gives the
replica group quorum writes, fencing, and BULK repair (the DMGET/DMSET
surface above means catching a replica up moves key ranges in
collective steps).  The cache service itself is untouched.

Port of the JAX package's ``cache/channel.py``: values are
``torch.Tensor``s, and the channel's device is
``options.ici_device`` — given, or the CUDA device of the caller's
chip (``local_coords``), raising without a card.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.protocols import redis as _redis
from incubator_brpc_tpu_torch.utils.hashes import murmur3_32
from incubator_brpc_tpu_torch.utils.iobuf import DeviceRef


class CacheError(RuntimeError):
    def __init__(self, code: int, text: str):
        super().__init__(f"cache rpc failed ({code}): {text}")
        self.code = code


class MGetResult:
    """One DMGET's worth of values.

    ``lengths[i]`` is value i's byte length, -1 on miss.  When the
    server fused (``stacked`` is a (bucket, L) uint8 tensor), hit i is
    row ``hit_index(i)`` — a view of the stack, so consumers that feed
    rows straight into device compute never touch host memory."""

    def __init__(self, keys: Sequence[bytes], lengths: List[int],
                 stacked=None, per_key: Optional[List] = None):
        self.keys = list(keys)
        self.lengths = lengths
        self.stacked = stacked
        self._per_key = per_key

    def hit(self, i: int) -> bool:
        return self.lengths[i] >= 0

    def _hit_index(self, i: int) -> int:
        return sum(1 for l in self.lengths[:i] if l >= 0)

    def row(self, i: int):
        """Value i as a tensor (or host bytes on the unfused host path);
        None on miss."""
        if not self.hit(i):
            return None
        if self.stacked is not None:
            return self.stacked[self._hit_index(i)]
        return self._per_key[i]

    def host_bytes(self, i: int) -> Optional[bytes]:
        """Value i as host bytes — device rows MATERIALIZE (manifested
        iobuf.host-view); keep off the hot path."""
        v = self.row(i)
        if v is None or isinstance(v, bytes):
            return v
        return bytes(DeviceRef(v).view())


class CacheChannel:
    """Client of the HBM cache tier.

    ``local_coords`` (the caller's (slice, chip) mesh position) arms the
    locality ranking; without it the ``mesh_locality`` balancer degrades
    to plain deterministic consistent hashing.  ``options.ici_device``
    is the device replies land on; left None, it is the CUDA device of
    the caller's chip (raises without a card)."""

    def __init__(self, naming_url: str = "tpu://fabric",
                 lb: str = "mesh_locality",
                 local_coords=None,
                 options: Optional[ChannelOptions] = None):
        options = options or ChannelOptions(timeout_ms=30000)
        options.protocol = "redis"  # the tier speaks RESP whatever the caller set
        if options.ici_device is None:
            from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip

            chip = local_coords[1] if local_coords is not None else 0
            options.ici_device = device_for_chip(chip if isinstance(chip, int) else 0)
        self._channel = Channel(options)
        rc = self._channel.init(naming_url, lb)
        if rc != 0:
            raise ValueError(f"cache channel init failed ({rc}) for {naming_url!r}")
        if local_coords is not None:
            balancer = self.balancer()
            if hasattr(balancer, "set_local_coords"):
                balancer.set_local_coords(local_coords)

    def balancer(self):
        """The underlying LoadBalancer (e.g. MeshLocalityLB for
        locality stats)."""
        lbn = self._channel._lb
        return lbn._lb if lbn is not None else None

    def locality_fraction(self) -> float:
        b = self.balancer()
        return b.locality_fraction() if hasattr(b, "locality_fraction") else 0.0

    # ---- single-command plumbing ------------------------------------------
    def _call(self, key: bytes, *components) -> _redis.RedisReply:
        req = _redis.RedisRequest()
        req.add_command(*components)
        resp = _redis.RedisResponse()
        ctrl = Controller()
        ctrl.request_code = murmur3_32(bytes(key))
        self._channel.call_method(_redis.redis_method_spec(), ctrl, req, resp)
        if ctrl.failed():
            raise CacheError(ctrl.error_code, ctrl.error_text())
        return resp.reply(0)

    def _call_window(self, calls, total_keys: int) -> List[_redis.RedisReply]:
        """Issue one WINDOW of routed commands concurrently — one call
        per replica group, all in flight together — and wait for every
        completion.  ``calls`` is ``[(route_key, components), ...]``;
        replies return in call order.  Error semantics match the old
        sequential loop: the first failed group (in call order) raises
        CacheError.  The fan-out step log records the window: crossings
        == groups, never keys (client/ring.py fanout_log)."""
        import threading as _threading

        n = len(calls)
        spec = _redis.redis_method_spec()
        ctrls: List[Controller] = []
        resps: List[_redis.RedisResponse] = []
        event = _threading.Event()
        lock = _threading.Lock()
        remaining = [n]

        def _one_done():
            with lock:
                remaining[0] -= 1
                if remaining[0] == 0:
                    event.set()

        max_tmo_ms = 0
        for route_key, components in calls:
            req = _redis.RedisRequest()
            req.add_command(*components)
            resp = _redis.RedisResponse()
            ctrl = Controller()
            ctrl.request_code = murmur3_32(bytes(route_key))
            ctrls.append(ctrl)
            resps.append(resp)
            try:
                self._channel.call_method(spec, ctrl, req, resp,
                                          done=_one_done)
            except Exception as e:  # noqa: BLE001 — a raising leg must
                # not strand the window's shared completion
                if not ctrl.failed():
                    from incubator_brpc_tpu_torch import errors as _errors

                    ctrl.set_failed(
                        _errors.EINTERNAL, f"cache window leg raised: {e}"
                    )
                _one_done()
            tmo = ctrl.timeout_ms or self._channel.options.timeout_ms or 0
            max_tmo_ms = max(max_tmo_ms, tmo)
        # the transport's own timeout sweep completes every leg; the
        # backstop only guards a wedged transport (legs it catches read
        # as failed controllers below)
        event.wait(max_tmo_ms / 1000.0 + 5.0 if max_tmo_ms > 0 else 65.0)
        from incubator_brpc_tpu_torch.client.ring import fanout_log

        fanout_log.record(crossings=n, keys=total_keys)
        for ctrl in ctrls:
            if ctrl.failed():
                raise CacheError(ctrl.error_code, ctrl.error_text())
        return [resp.reply(0) for resp in resps]

    # ---- KV surface --------------------------------------------------------
    def get(self, key):
        """The stored value: a tensor on the channel's device when the
        replica answered over ICI, host bytes otherwise, None on miss."""
        key = key.encode() if isinstance(key, str) else bytes(key)
        r = self._call(key, "GET", key)
        if r.is_nil():
            return None
        if r.is_error():
            raise CacheError(0, str(r.value))
        arr = r.device_array()
        return arr if arr is not None else r.bytes_value()

    def get_host(self, key) -> Optional[bytes]:
        v = self.get(key)
        if v is None or isinstance(v, bytes):
            return v
        return bytes(DeviceRef(v).view())

    def set(self, key, value) -> None:
        """``value``: host bytes, a tensor, or a DeviceRef — device
        values ride the wire as DeviceRef segments (zero-copy over ICI)."""
        key = key.encode() if isinstance(key, str) else bytes(key)
        if isinstance(value, str):
            value = value.encode()
        r = self._call(key, "SET", key, value)
        if r.is_error():
            raise CacheError(0, str(r.value))

    def delete(self, key) -> bool:
        key = key.encode() if isinstance(key, str) else bytes(key)
        r = self._call(key, "DEL", key)
        return bool(r.value)

    def get_many(self, keys: Sequence) -> MGetResult:
        """Batched GET.  Keys are grouped by the replica the balancer
        routes each one to, and every group ships as ONE ``DMGET`` —
        the server coalesces each group's same-length hits through the
        store's fused gather.  A batch that lands on a single replica
        (co-located keys — the hot shape) keeps the one stacked device
        tensor end to end; a batch spanning replicas merges per key."""
        bkeys = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
        balancer = self.balancer()
        groups: dict = {}
        if balancer is None:
            groups[None] = list(range(len(bkeys)))
        else:
            from incubator_brpc_tpu_torch.client.load_balancer import SelectIn

            for i, k in enumerate(bkeys):
                node = balancer.select_server(
                    SelectIn(request_code=murmur3_32(k))
                )
                groups.setdefault(node, []).append(i)
        if len(groups) == 1:
            lengths, vals, stacked = self._dmget(bkeys[0], bkeys)
            if stacked is not None:
                return MGetResult(bkeys, lengths, stacked=stacked)
            return MGetResult(bkeys, lengths, per_key=vals)
        # multi-replica batch: ONE window — every group's DMGET is in
        # flight concurrently (crossings == groups, not keys), replies
        # merge per key in group order
        lengths = [-1] * len(bkeys)
        per_key: List = [None] * len(bkeys)
        group_idxs = list(groups.values())
        calls = []
        for idxs in group_idxs:
            gkeys = [bkeys[i] for i in idxs]
            calls.append((gkeys[0], ("DMGET", *gkeys)))
        replies = self._call_window(calls, total_keys=len(bkeys))
        for idxs, r in zip(group_idxs, replies):
            glens, gvals, _ = self._parse_dmget(r)
            for i, L, v in zip(idxs, glens, gvals):
                lengths[i] = L
                per_key[i] = v
        return MGetResult(bkeys, lengths, per_key=per_key)

    def _dmget(self, route_key: bytes, bkeys: List[bytes]):
        """One DMGET round trip: (lengths, per-key values, stacked).
        Fused replies keep ``stacked`` whole and slice rows lazily —
        device rows never leave HBM here."""
        return self._parse_dmget(self._call(route_key, "DMGET", *bkeys))

    @staticmethod
    def _parse_dmget(r: _redis.RedisReply):
        if r.is_error():
            raise CacheError(0, str(r.value))
        fused, lengths_r, payload = r.value
        lengths = [x.value for x in lengths_r.value]
        if fused.value == 1:
            stacked = payload.device_array()
            vals: List = []
            hi = 0
            for L in lengths:
                if L < 0:
                    vals.append(None)
                else:
                    vals.append(stacked[hi])
                    hi += 1
            return lengths, vals, stacked
        vals = []
        for item in payload.value:
            if item.is_nil():
                vals.append(None)
            else:
                arr = item.device_array()
                vals.append(arr if arr is not None else item.bytes_value())
        return lengths, vals, None

    def set_many(self, items: Sequence) -> int:
        """Batched SET: ``items`` is (key, value) pairs.  Pairs are
        grouped by the replica the balancer routes each key to and every
        group ships as ONE ``DMSET`` — the resharding coordinator's
        bulk COPY moves a whole (src, dst) range in one round trip per
        destination instead of one SET per key.  Returns the stored
        count; raises CacheError when any value was refused (HBM
        budget), so callers fall back to the per-key engine."""
        pairs: List = []
        for k, v in items:
            k = k.encode() if isinstance(k, str) else bytes(k)
            if isinstance(v, str):
                v = v.encode()
            pairs.append((k, v))
        if not pairs:
            return 0
        balancer = self.balancer()
        groups: dict = {}
        if balancer is None:
            groups[None] = list(range(len(pairs)))
        else:
            from incubator_brpc_tpu_torch.client.load_balancer import SelectIn

            for i, (k, _) in enumerate(pairs):
                node = balancer.select_server(
                    SelectIn(request_code=murmur3_32(k))
                )
                groups.setdefault(node, []).append(i)
        # one DMSET per destination replica, ALL in flight as one
        # window (crossings == groups); refusal semantics unchanged —
        # the first failed/refused group in group order raises
        group_idxs = list(groups.values())
        if len(group_idxs) == 1:
            idxs = group_idxs[0]
            flat: List = []
            for i in idxs:
                flat.extend(pairs[i])
            replies = [self._call(pairs[idxs[0]][0], "DMSET", *flat)]
        else:
            calls = []
            for idxs in group_idxs:
                flat = []
                for i in idxs:
                    flat.extend(pairs[i])
                calls.append((pairs[idxs[0]][0], ("DMSET", *flat)))
            replies = self._call_window(calls, total_keys=len(pairs))
        stored = 0
        for r in replies:
            if r.is_error():
                raise CacheError(0, str(r.value))
            stored += int(r.value)
        if stored != len(pairs):
            raise CacheError(
                0, f"DMSET stored {stored}/{len(pairs)} values"
            )
        return stored

    def keys(self) -> List[bytes]:
        """Key census of the replica this channel routes to.  The
        re-sharding coordinator holds one single-member channel per
        shard and reads each shard's census through this; on a
        multi-replica channel it censuses whichever replica the empty
        route key hashes to."""
        r = self._call(b"", "KEYS")
        if r.is_error():
            raise CacheError(0, str(r.value))
        return [item.bytes_value() for item in r.value]

    def flush_all(self) -> None:
        self._call(b"", "FLUSHALL")

    def close(self) -> None:
        self._channel.close()
