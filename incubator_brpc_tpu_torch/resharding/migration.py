"""Live re-sharding — zero-downtime scheme migration for sharded stores.

The sharded PS (docs/sharded_ps.md) and the HBM cache tier
(docs/cache.md) pin a shard count at process start; this module
migrates either store from an N-shard to an M-shard murmur3 scheme
WHILE serving traffic (docs/resharding.md), the sharded-store analog
of the reference DynamicPartitionChannel's scheme coexistence:

  PREPARE     census every old shard's keys; plan the moved set
              (``moved_keys`` — exactly the scheme delta, nothing else)
  DUAL_WRITE  clients (DynamicShardChannel) apply writes to BOTH
              schemes, so keys written mid-migration are already in
              place on their new owner
  COPY        moved keys stream shard→shard in (src, dst) ranges with
              per-key read-back checksums (murmur3 over value bytes);
              a source shard dying mid-COPY completes from the
              dual-written copy on the destination, or the migration
              rolls back — never a stale half-state
  CUTOVER     ONE epoch bump published through naming ("i/N@E" tags);
              in-flight fan-outs finish on the scheme they started on
              (the client snapshots its scheme per call)
  DRAIN       moved keys delete from their source shards (idempotent)
              — post-DRAIN the sources hold zero live migrated keys
  DONE        (or ROLLED_BACK: old scheme stays authoritative, copied
              keys best-effort deleted from the new-only shards)

Chaos sites (docs/chaos.md): ``reshard.copy`` faults individual key
copies (drop = retry next round, corrupt = checksum mismatch →
re-copy, delay_us = wider kill window), ``reshard.cutover`` faults the
epoch-bump publication (drop = rollback).  The acceptance suite
(tests/test_resharding.py) runs ``chaos.storm.reshard_storm_plan``
under RecoveryHarness and kills a source shard mid-COPY.

This module is jax-free at import (METRIC_MODULES contract): metrics
register here, device work stays in the stores.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from incubator_brpc_tpu_torch.metrics.reducer import Adder
from incubator_brpc_tpu_torch.utils.hashes import murmur3_32
from incubator_brpc_tpu_torch.utils.logging import log_error

# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

IDLE = "IDLE"
PREPARE = "PREPARE"
DUAL_WRITE = "DUAL_WRITE"
COPY = "COPY"
CUTOVER = "CUTOVER"
DRAIN = "DRAIN"
DONE = "DONE"
ROLLED_BACK = "ROLLED_BACK"

PHASES = (IDLE, PREPARE, DUAL_WRITE, COPY, CUTOVER, DRAIN, DONE,
          ROLLED_BACK)

# phases during which the client channel treats the migration as live
_MIGRATING = frozenset({PREPARE, DUAL_WRITE, COPY, CUTOVER, DRAIN})
# phases during which writes dual-apply to both schemes
_DUAL = frozenset({DUAL_WRITE, COPY, CUTOVER})

# ---------------------------------------------------------------------------
# metrics (rpc_reshard_*; registered at import — METRIC_MODULES lint)
# ---------------------------------------------------------------------------

reshard_keys_moved = Adder(0).expose("rpc_reshard_keys_moved")
reshard_ranges_copied = Adder(0).expose("rpc_reshard_ranges_copied")
reshard_checksum_failures = Adder(0).expose(
    "rpc_reshard_checksum_failures"
)
reshard_copy_retries = Adder(0).expose("rpc_reshard_copy_retries")
reshard_survivor_completions = Adder(0).expose(
    "rpc_reshard_survivor_completions"
)
reshard_cutovers = Adder(0).expose("rpc_reshard_cutovers")
reshard_rollbacks = Adder(0).expose("rpc_reshard_rollbacks")
reshard_keys_drained = Adder(0).expose("rpc_reshard_keys_drained")
# collective bulk-move (one stacked read + write + verify per
# (src, dst) range instead of per-key RPCs): the step-log proof that
# an N→M COPY moves shards in collective steps is
# collective_steps ≪ keys_moved
reshard_collective_steps = Adder(0).expose(
    "rpc_reshard_collective_steps"
)
reshard_bulk_ranges = Adder(0).expose("rpc_reshard_bulk_ranges")
reshard_bulk_fallbacks = Adder(0).expose("rpc_reshard_bulk_fallbacks")


# ---------------------------------------------------------------------------
# the pure scheme planner
# ---------------------------------------------------------------------------

def shard_of(key, n: int, seed: int = 0) -> int:
    """The ShardRoutedChannel's owner function, importable without a
    channel: murmur3(key) % n.  Golden-pinned in tests — changing this
    silently strands every stored key."""
    return murmur3_32(str(key).encode(), seed=seed) % n


def moved_keys(
    keys: Sequence, old_n: int, new_n: int, seed: int = 0
) -> Dict[str, Tuple[int, int]]:
    """{key: (src_shard, dst_shard)} for exactly the keys whose owner
    CHANGES between the N- and M-shard schemes (shards 0..N-1 keep
    their identity in the new scheme, so same-index keys never move).
    This is the migration's whole work list — and the golden test's
    assertion that no key remaps gratuitously."""
    out: Dict[str, Tuple[int, int]] = {}
    for key in keys:
        k = key.decode("utf-8", "surrogateescape") if isinstance(
            key, (bytes, bytearray)
        ) else str(key)
        src = shard_of(k, old_n, seed)
        dst = shard_of(k, new_n, seed)
        if src != dst:
            out[k] = (src, dst)
    return out


def range_checksum(value: bytes) -> int:
    """Per-range copy checksum: murmur3 over the value bytes (the same
    hash family as the chunk pipeline's chained checksums)."""
    return murmur3_32(bytes(value))


# ---------------------------------------------------------------------------
# epoch-in-tag naming grammar:  "i/N@E"
# ---------------------------------------------------------------------------

def parse_epoch_tag(tag: str) -> Optional[Tuple[int, int, int]]:
    """"i/N@E" → (index, count, epoch); "i/N" → (index, count, 0);
    None when the tag is not a partition tag.  The plain-"i/N" parser
    in client/combo.py returns None for epoch-extended tags, so mixed
    fleets degrade safely (old clients ignore epoch-tagged nodes
    rather than misrouting)."""
    base, _, ep = tag.partition("@")
    try:
        idx_s, _, cnt_s = base.partition("/")
        idx, cnt = int(idx_s), int(cnt_s)
        epoch = int(ep) if ep else 0
    except ValueError:
        return None
    return idx, cnt, epoch


def format_epoch_tag(index: int, count: int, epoch: int) -> str:
    return f"{index}/{count}@{epoch}"


def max_epoch(nodes) -> int:
    """The highest epoch any node's tag advertises — what a naming
    watcher adopts (the CUTOVER bump is exactly this going up by 1)."""
    best = 0
    for node in nodes:
        parsed = parse_epoch_tag(getattr(node, "tag", "") or "")
        if parsed is not None:
            best = max(best, parsed[2])
    return best


# ---------------------------------------------------------------------------
# the client's view of the migration
# ---------------------------------------------------------------------------

class MigrationView:
    """What a DynamicShardChannel reads per call: the migration phase
    and the routing epoch.  The epoch is AUTHORITATIVE for scheme
    choice — phase only widens behavior (dual writes, read fallback).
    Feed it as a naming watcher (``on_servers_changed``) so the
    CUTOVER bump propagates to every client through the naming plane,
    or drive it directly from a co-located coordinator."""

    def __init__(self, epoch: int = 0):
        self._lock = threading.Lock()
        self.phase = IDLE
        self.epoch = int(epoch)
        self._base_epoch = int(epoch)

    # -- predicates the channel calls (one lock-free read each; phase
    # and epoch are single attributes, torn reads impossible) --------------
    def cut_over(self) -> bool:
        return self.epoch > self._base_epoch

    def dual_writing(self) -> bool:
        return self.phase in _DUAL

    def migrating(self) -> bool:
        return self.phase in _MIGRATING

    # -- transitions ---------------------------------------------------------
    def set_phase(self, phase: str) -> None:
        if phase not in PHASES:
            raise ValueError(f"unknown migration phase {phase!r}")
        self.phase = phase

    def bump_epoch(self, epoch: Optional[int] = None) -> int:
        with self._lock:
            self.epoch = int(epoch) if epoch is not None else self.epoch + 1
            return self.epoch

    def rearm(self) -> None:
        """Adopt the current epoch as the new baseline (after DONE /
        ROLLED_BACK, so the next migration starts un-cut-over)."""
        with self._lock:
            self._base_epoch = self.epoch

    # -- naming watcher ------------------------------------------------------
    def on_servers_changed(self, nodes) -> None:
        e = max_epoch(nodes)
        with self._lock:
            if e > self.epoch:
                self.epoch = e


# ---------------------------------------------------------------------------
# per-replica persisted state + the /resharding registry
# ---------------------------------------------------------------------------

_registry_lock = threading.Lock()
_registry: Dict[str, "ReshardingState"] = {}


def register_state(state: "ReshardingState") -> None:
    with _registry_lock:
        _registry[state.name] = state


def states_snapshot() -> Dict[str, dict]:
    """All registered migrations' states (the /resharding builtin)."""
    with _registry_lock:
        return {name: st.to_dict() for name, st in _registry.items()}


class ReshardingState:
    """One migration's durable state on one replica: phase, epoch,
    scheme pair, and the step-log counters the zero-downtime proof
    reads.  ``path`` persists every transition as JSON so a restarted
    replica resumes (``ReshardingState.load``) instead of forgetting a
    half-done migration."""

    def __init__(self, name: str, old_n: int, new_n: int, seed: int = 0,
                 path: Optional[str] = None, epoch: int = 0):
        self.name = name
        self.old_n = int(old_n)
        self.new_n = int(new_n)
        self.seed = int(seed)
        self.path = path
        self.phase = IDLE
        self.epoch = int(epoch)
        self.counters: Dict[str, int] = {
            "keys_total": 0,
            "keys_moved": 0,
            "keys_copied": 0,
            "keys_drained": 0,
            "ranges_copied": 0,
            "checksum_failures": 0,
            "copy_retries": 0,
            "survivor_completions": 0,
            "rollbacks": 0,
            "collective_steps": 0,
            "bulk_ranges": 0,
        }
        self._lock = threading.Lock()
        register_state(self)

    def enter(self, phase: str, epoch: Optional[int] = None) -> None:
        if phase not in PHASES:
            raise ValueError(f"unknown migration phase {phase!r}")
        with self._lock:
            self.phase = phase
            if epoch is not None:
                self.epoch = int(epoch)
        self.save()

    def bump(self, counter: str, delta: int = 1) -> None:
        with self._lock:
            self.counters[counter] = self.counters.get(counter, 0) + delta

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "phase": self.phase,
                "epoch": self.epoch,
                "old_n": self.old_n,
                "new_n": self.new_n,
                "seed": self.seed,
                "counters": dict(self.counters),
            }

    # -- persistence ---------------------------------------------------------
    def save(self) -> None:
        if not self.path:
            return
        try:
            tmp = f"{self.path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(self.to_dict(), f)
            os.replace(tmp, self.path)
        except OSError as e:
            log_error("resharding state save failed: %r", e)

    @classmethod
    def load(cls, path: str) -> Optional["ReshardingState"]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                d = json.load(f)
        except (OSError, ValueError):
            return None
        st = cls(d["name"], d["old_n"], d["new_n"], seed=d.get("seed", 0),
                 path=path, epoch=d.get("epoch", 0))
        st.phase = d.get("phase", IDLE)
        st.counters.update(d.get("counters", {}))
        return st


# ---------------------------------------------------------------------------
# per-shard store adapters (what the coordinator copies through)
# ---------------------------------------------------------------------------

class ShardUnavailable(RuntimeError):
    """A shard did not answer (dead / unreachable) — distinct from a
    clean miss, which reads as None."""


class PsShardStore:
    """One PS shard behind its sub-channel: the coordinator's
    read/write/delete/census surface over the Keys/Get/Put/Delete
    RPCs.  Values move as bytes (device payloads materialize through
    the manifested iobuf spill on read and re-ingest on write — the
    migration is a control-plane copy, not a hot path)."""

    def __init__(self, channel, timeout_ms: int = 10000):
        from incubator_brpc_tpu_torch.models.parameter_server import ps_stub

        self._stub = ps_stub(channel)
        self._timeout_ms = timeout_ms

    def _controller(self):
        from incubator_brpc_tpu_torch.client.controller import Controller

        c = Controller()
        c.timeout_ms = self._timeout_ms
        return c

    def _request(self, key: str = ""):
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

        return EchoRequest(message=key)

    def list_keys(self) -> List[str]:
        c = self._controller()
        self._stub.Keys(c, self._request())
        if c.failed():
            raise ShardUnavailable(f"Keys failed: {c.error_text()}")
        raw = c.response_attachment.to_bytes()
        return raw.decode("utf-8").split("\n") if raw else []

    def read(self, key: str) -> Optional[bytes]:
        from incubator_brpc_tpu_torch import errors

        c = self._controller()
        self._stub.Get(c, self._request(key))
        if c.failed():
            if c.error_code == errors.EREQUEST:
                return None  # clean miss
            raise ShardUnavailable(f"Get({key}) failed: {c.error_text()}")
        return c.response_attachment.to_bytes()

    def write(self, key: str, value: bytes) -> None:
        c = self._controller()
        c.request_attachment.append(bytes(value))
        self._stub.Put(c, self._request(key))
        if c.failed():
            raise ShardUnavailable(f"Put({key}) failed: {c.error_text()}")

    def delete(self, key: str) -> bool:
        c = self._controller()
        resp = self._stub.Delete(c, self._request(key))
        if c.failed():
            raise ShardUnavailable(
                f"Delete({key}) failed: {c.error_text()}"
            )
        return resp.message == "1"


class CacheShardStore:
    """One cache shard behind a (typically single-member) CacheChannel
    — same surface as PsShardStore over GET/SET/DEL/KEYS, plus the
    bulk surface (``read_many``/``write_many`` over DMGET/DMSET) the
    coordinator's collective COPY path probes for: one round trip moves
    a whole (src, dst) key range instead of one RPC per key.
    (PsShardStore stays per-key — its Get/Put protobuf surface has no
    bulk verb — so PS migrations ride the per-key engine unchanged.)"""

    def __init__(self, cache_channel):
        self._cc = cache_channel

    def list_keys(self) -> List[str]:
        from incubator_brpc_tpu_torch.cache.channel import CacheError

        try:
            return [
                k.decode("utf-8", "surrogateescape")
                for k in self._cc.keys()
            ]
        except CacheError as e:
            raise ShardUnavailable(f"KEYS failed: {e}") from e

    def read(self, key: str) -> Optional[bytes]:
        from incubator_brpc_tpu_torch.cache.channel import CacheError

        try:
            return self._cc.get_host(key)
        except CacheError as e:
            raise ShardUnavailable(f"GET({key}) failed: {e}") from e

    def write(self, key: str, value: bytes) -> None:
        from incubator_brpc_tpu_torch.cache.channel import CacheError

        try:
            self._cc.set(key, bytes(value))
        except CacheError as e:
            raise ShardUnavailable(f"SET({key}) failed: {e}") from e

    def delete(self, key: str) -> bool:
        from incubator_brpc_tpu_torch.cache.channel import CacheError

        try:
            return self._cc.delete(key)
        except CacheError as e:
            raise ShardUnavailable(f"DEL({key}) failed: {e}") from e

    # -- bulk surface (collective COPY) --------------------------------------
    def read_many(self, keys: Sequence[str]) -> List[Optional[bytes]]:
        """One DMGET for the whole key list; misses read as None."""
        from incubator_brpc_tpu_torch.cache.channel import CacheError

        keys = list(keys)
        try:
            res = self._cc.get_many(keys)
            return [res.host_bytes(i) for i in range(len(keys))]
        except CacheError as e:
            raise ShardUnavailable(f"DMGET({len(keys)}) failed: {e}") from e

    def write_many(self, items: Sequence[Tuple[str, bytes]]) -> None:
        """One DMSET for the whole (key, value) list."""
        from incubator_brpc_tpu_torch.cache.channel import CacheError

        items = [(k, bytes(v)) for k, v in items]
        try:
            self._cc.set_many(items)
        except CacheError as e:
            raise ShardUnavailable(
                f"DMSET({len(items)}) failed: {e}"
            ) from e


# ---------------------------------------------------------------------------
# the verified move step — shared by resharding COPY and replica repair
# ---------------------------------------------------------------------------

def verified_write(dst_store, key: str, value: bytes) -> Tuple[bool, int]:
    """The one checksum-verified move step: write + read-back + murmur3
    verify against the source bytes.  Returns ``(ok, checksum)`` where
    ``checksum`` is the SOURCE checksum (what a ledger records on
    success).  ShardUnavailable propagates — the caller owns retry
    semantics.  This is the single primitive the resharding COPY engine
    (``_copy_one``) and replication repair (replication/group.py) share:
    one path, one verification discipline."""
    checksum = range_checksum(value)
    dst_store.write(key, value)
    back = dst_store.read(key)
    verify = range_checksum(back) if back is not None else ~checksum
    return verify == checksum, checksum


def verified_write_many(
    dst_store, items: Sequence[Tuple[str, bytes]],
) -> Tuple[List[str], List[str], Dict[str, int]]:
    """Bulk flavor of :func:`verified_write` riding the stacked
    DMSET/DMGET surface (the stacked bulk-move lowering) when the store
    has one: ONE stacked write + ONE stacked read-back verifies the
    whole batch in two collective steps.  Returns ``(ok_keys,
    failed_keys, checksums)``; ``failed_keys`` must be re-moved (the
    per-key engine or the next round).  Callers probe
    ``write_many``/``read_many`` before calling; ShardUnavailable
    propagates."""
    items = [(k, bytes(v)) for k, v in items]
    checksums = {k: range_checksum(v) for k, v in items}
    dst_store.write_many(items)
    back = dst_store.read_many([k for k, _ in items])
    ok_keys: List[str] = []
    failed_keys: List[str] = []
    for (k, _v), b in zip(items, back):
        want = checksums[k]
        verify = range_checksum(b) if b is not None else ~want
        (ok_keys if verify == want else failed_keys).append(k)
    return ok_keys, failed_keys, checksums


# ---------------------------------------------------------------------------
# the coordinator
# ---------------------------------------------------------------------------

class MigrationFailed(RuntimeError):
    """The migration could neither complete nor roll back cleanly."""


class ReshardCoordinator:
    """Drives one N→M migration over per-shard store adapters.

    ``old_parts``/``new_parts`` are the per-shard stores of each
    scheme (shards 0..N-1 of the new scheme are normally the SAME
    stores as the old scheme's — only indices N..M-1 are new
    capacity).  ``view`` is the MigrationView the co-located client
    channel reads; remote clients get the epoch through ``publish``
    (republish naming with ``format_epoch_tag`` tags) and the phase
    through their own naming-fed views.

    ``run()`` executes the whole state machine synchronously and
    returns the step-log report; it either reaches DONE or ROLLED_BACK
    (raising MigrationFailed only when rollback itself cannot restore
    the old scheme's invariants)."""

    def __init__(
        self,
        name: str,
        old_parts: Sequence,
        new_parts: Sequence,
        seed: int = 0,
        view: Optional[MigrationView] = None,
        state: Optional[ReshardingState] = None,
        publish: Optional[Callable[[int, str], None]] = None,
        copy_rounds: int = 8,
        on_copy: Optional[Callable[[str, int, int], None]] = None,
        key_filter: Optional[Callable[[str], bool]] = None,
    ):
        self.name = name
        self.old_parts = list(old_parts)
        self.new_parts = list(new_parts)
        self.seed = int(seed)
        self.view = view if view is not None else MigrationView()
        self.state = state if state is not None else ReshardingState(
            name, len(self.old_parts), len(self.new_parts), seed=seed,
            epoch=self.view.epoch,
        )
        self._publish = publish
        self.copy_rounds = int(copy_rounds)
        # test hook: called before each key's copy attempt with
        # (key, src, dst) — the kill-mid-COPY suite stops a source
        # shard from inside this
        self._on_copy = on_copy
        # census filter: keys it rejects stay OUT of the migration —
        # per-scheme layout keys (scattered parameter slices, which
        # hold DIFFERENT bytes on every shard) must re-scatter through
        # the remesh path, never copy by owner
        self._key_filter = key_filter
        self.moved: Dict[str, Tuple[int, int]] = {}
        self._copied: Dict[str, int] = {}  # key -> checksum

    # -- phase helpers -------------------------------------------------------
    def _span(self, phase: str):
        from incubator_brpc_tpu_torch.observability.span import Span

        span = Span.create_client("resharding", phase)
        if span is not None:
            span.annotate(
                f"migration {self.name}: {len(self.old_parts)}→"
                f"{len(self.new_parts)} shards"
            )
        return span

    def _enter(self, phase: str) -> None:
        self.state.enter(phase, epoch=self.view.epoch)
        self.view.set_phase(phase)

    def _chaos_copy(self, key: str) -> Optional[str]:
        """→ None (proceed), "drop" (skip this attempt), "corrupt"
        (force a checksum mismatch on this attempt)."""
        from incubator_brpc_tpu_torch.chaos import injector as _chaos

        if not _chaos.armed:
            return None
        spec = _chaos.check("reshard.copy", method=key)
        if spec is None:
            return None
        if spec.action == "delay_us":
            _chaos.sleep_us(spec.arg)
            return None
        return spec.action  # "drop" | "corrupt"

    def _chaos_cutover(self) -> bool:
        """True = the cutover publication is dropped (→ rollback)."""
        from incubator_brpc_tpu_torch.chaos import injector as _chaos

        if not _chaos.armed:
            return False
        spec = _chaos.check("reshard.cutover", method=self.name)
        if spec is None:
            return False
        if spec.action == "delay_us":
            _chaos.sleep_us(spec.arg)
            return False
        return spec.action == "drop"

    # -- the state machine ---------------------------------------------------
    def run(self) -> dict:
        span = self._span("migration")
        try:
            result = self._run_inner()
            if span is not None:
                span.annotate(f"finished {self.state.phase}")
                span.end(0 if self.state.phase == DONE else 1)
            return result
        except Exception:
            if span is not None:
                span.end(1)
            raise

    def _run_inner(self) -> dict:
        self._prepare()
        self._enter(DUAL_WRITE)
        self._enter(COPY)
        copied_all = self._copy()
        if not copied_all:
            return self._rollback("COPY could not complete")
        if not self._cutover():
            return self._rollback("CUTOVER publication dropped")
        self._drain()
        self._enter(DONE)
        # NO rearm here: the new scheme stays authoritative
        # (cut_over() True) for the life of this view — a follow-on
        # migration builds a fresh view/channel pair and rearms THAT
        return self.report()

    def _prepare(self) -> None:
        self._enter(PREPARE)
        span = self._span(PREPARE)
        keys: set = set()
        for i, part in enumerate(self.old_parts):
            try:
                shard_keys = part.list_keys()
            except ShardUnavailable as e:
                # a shard we cannot census is a shard we cannot migrate
                if span is not None:
                    span.end(1)
                raise MigrationFailed(
                    f"PREPARE: shard {i} census failed: {e}"
                ) from e
            # census trusts each shard's OWN key list; keys the scheme
            # wouldn't route there (e.g. mid-crash leftovers) still
            # migrate by their canonical owner mapping
            keys.update(shard_keys)
        if self._key_filter is not None:
            keys = {k for k in keys if self._key_filter(k)}
        self.moved = moved_keys(
            sorted(keys), len(self.old_parts), len(self.new_parts),
            self.seed,
        )
        self.state.bump("keys_total", len(keys))
        self.state.bump("keys_moved", len(self.moved))
        if span is not None:
            span.annotate(
                f"census {len(keys)} keys, {len(self.moved)} move"
            )
            span.end(0)

    def _copy(self) -> bool:
        """Copy every moved key src→dst with read-back checksums.
        Ranges whose stores expose the bulk surface move collectively
        (``_copy_range_bulk``: 3 stacked steps per (src, dst) pair);
        the rest — and every chaos/hook run — ride the per-key engine.
        Returns True when every key is in place on its destination."""
        span = self._span(COPY)
        pending = dict(self.moved)
        rounds = 0
        while pending and rounds < self.copy_rounds:
            rounds += 1
            if rounds > 1:
                self.state.bump("copy_retries")
                reshard_copy_retries << 1
            # group into (src, dst) ranges: one range = one src shard
            # streaming its slice of the moved set to one dst shard
            ranges: Dict[Tuple[int, int], List[str]] = {}
            for key, (src, dst) in pending.items():
                ranges.setdefault((src, dst), []).append(key)
            for (src, dst), range_keys in sorted(ranges.items()):
                done_all = self._copy_range_bulk(
                    range_keys, src, dst, pending
                )
                if done_all is None:  # per-key engine (fallback)
                    done_all = True
                    for key in sorted(range_keys):
                        if self._copy_one(key, src, dst):
                            del pending[key]
                        else:
                            done_all = False
                if done_all:
                    self.state.bump("ranges_copied")
                    reshard_ranges_copied << 1
        if span is not None:
            span.annotate(
                f"{len(self.moved) - len(pending)}/{len(self.moved)} "
                f"keys copied in {rounds} rounds"
            )
            span.end(0 if not pending else 1)
        return not pending

    def _copy_range_bulk(
        self, range_keys: List[str], src: int, dst: int,
        pending: Dict[str, Tuple[int, int]],
    ) -> Optional[bool]:
        """Collective move of one (src, dst) range: ONE stacked read,
        ONE stacked write, ONE stacked read-back verify — three
        collective steps for the whole range instead of three RPCs per
        key, the bulk path the Pallas stacked transmit carries at the
        fabric layer.  Completed keys are pruned from ``pending``
        directly.  Returns None to defer the range to the per-key
        engine: stores without a bulk surface (PsShardStore), an armed
        chaos injector or a registered ``_on_copy`` hook (both target
        per-key fault semantics — seeded plans must replay exactly), or
        a shard failure mid-bulk (the per-key engine owns survivor
        completion)."""
        from incubator_brpc_tpu_torch.chaos import injector as _chaos

        src_store = self.old_parts[src]
        dst_store = self.new_parts[dst]
        if (
            len(range_keys) < 2
            or _chaos.armed
            or self._on_copy is not None
            or not callable(getattr(src_store, "read_many", None))
            or not callable(getattr(dst_store, "write_many", None))
            or not callable(getattr(dst_store, "read_many", None))
        ):
            if len(range_keys) >= 2:
                reshard_bulk_fallbacks << 1
            return None
        keys = sorted(range_keys)
        try:
            values = src_store.read_many(keys)
        except ShardUnavailable:
            reshard_bulk_fallbacks << 1
            return None
        present = [(k, v) for k, v in zip(keys, values) if v is not None]
        misses = [k for k, v in zip(keys, values) if v is None]
        steps = 1
        done_all = True
        if present:
            try:
                ok_keys, failed_keys, checksums = verified_write_many(
                    dst_store, present
                )
            except ShardUnavailable:
                reshard_bulk_fallbacks << 1
                return None
            steps = 3
            for _k in failed_keys:  # re-copy next round
                self.state.bump("checksum_failures")
                reshard_checksum_failures << 1
                done_all = False
            for k in ok_keys:
                if k not in self._copied:
                    self._copied[k] = checksums[k]
                    self.state.bump("keys_copied")
                    reshard_keys_moved << 1
                del pending[k]
        self.state.bump("collective_steps", steps)
        reshard_collective_steps << steps
        self.state.bump("bulk_ranges")
        reshard_bulk_ranges << 1
        # source misses (deleted under us / survivor-held) are the rare
        # leg — the per-key engine's survivor-completion logic handles
        # each one
        for k in misses:
            if self._copy_one(k, src, dst):
                pending.pop(k, None)
            else:
                done_all = False
        return done_all

    def _copy_one(self, key: str, src: int, dst: int) -> bool:
        if self._on_copy is not None:
            self._on_copy(key, src, dst)
        chaos = self._chaos_copy(key)
        if chaos == "drop":
            return False  # this attempt lost; the key stays pending
        try:
            value = self.old_parts[src].read(key)
        except ShardUnavailable:
            value = None
            src_dead = True
        else:
            src_dead = False
        if value is None:
            # source miss/dead: the dual-written (or previously copied)
            # destination copy completes this key from the survivor —
            # the "completes from surviving replicas" leg
            try:
                existing = self.new_parts[dst].read(key)
            except ShardUnavailable:
                return False
            if existing is not None:
                if key not in self._copied:
                    self._copied[key] = range_checksum(existing)
                    self.state.bump("keys_copied")
                    self.state.bump("survivor_completions")
                    reshard_keys_moved << 1
                    reshard_survivor_completions << 1
                return True
            if src_dead:
                return False  # unrecoverable this round; retry/rollback
            # clean miss on BOTH sides: the key was deleted under us —
            # nothing to move
            self.moved.pop(key, None)
            self._copied.pop(key, None)
            return True
        try:
            ok, checksum = verified_write(self.new_parts[dst], key, value)
        except ShardUnavailable:
            return False
        if chaos == "corrupt":
            ok = False  # injected wire corruption: checksum trips
        if not ok:
            self.state.bump("checksum_failures")
            reshard_checksum_failures << 1
            return False  # re-copy next round
        if key not in self._copied:
            self._copied[key] = checksum
            self.state.bump("keys_copied")
            reshard_keys_moved << 1
        return True

    def _cutover(self) -> bool:
        span = self._span(CUTOVER)
        if self._chaos_cutover():
            if span is not None:
                span.annotate("publication dropped (chaos)")
                span.end(1)
            return False
        new_epoch = self.view.epoch + 1
        if self._publish is not None:
            try:
                self._publish(new_epoch, CUTOVER)
            except Exception as e:  # noqa: BLE001
                log_error("cutover publish raised: %r", e)
                if span is not None:
                    span.end(1)
                return False
        self.view.bump_epoch(new_epoch)
        self._enter(CUTOVER)
        reshard_cutovers << 1
        if span is not None:
            span.annotate(f"epoch → {new_epoch}")
            span.end(0)
        return True

    def _drain(self) -> None:
        self._enter(DRAIN)
        span = self._span(DRAIN)
        drained = 0
        for key, (src, dst) in sorted(self.moved.items()):
            try:
                if self.old_parts[src].delete(key):
                    drained += 1
            except ShardUnavailable:
                # a source that died mid-COPY holds no LIVE copy (its
                # store died with it); nothing to drain
                continue
        self.state.bump("keys_drained", drained)
        reshard_keys_drained << drained
        if span is not None:
            span.annotate(f"{drained} source copies deleted")
            span.end(0)

    def _rollback(self, reason: str) -> dict:
        span = self._span(ROLLED_BACK)
        # the old scheme never stopped being authoritative (no epoch
        # bump happened / is reverted by republishing the old tags)
        if self._publish is not None:
            try:
                self._publish(self.view.epoch, ROLLED_BACK)
            except Exception as e:  # noqa: BLE001
                log_error("rollback publish raised: %r", e)
        # best-effort: clear copies from NEW-ONLY shards so a later
        # retry starts clean (shards shared with the old scheme keep
        # their store untouched — they ARE the old scheme)
        old_n = len(self.old_parts)
        for key in list(self._copied):
            dst = self.moved.get(key, (0, -1))[1]
            if dst >= old_n:
                try:
                    self.new_parts[dst].delete(key)
                except ShardUnavailable:
                    pass
        self.state.bump("rollbacks")
        reshard_rollbacks << 1
        self._enter(ROLLED_BACK)
        # no epoch was bumped (or the old tags were republished at the
        # same epoch), so cut_over() stays False: old stays authoritative
        if span is not None:
            span.annotate(reason)
            span.end(0)
        return self.report()

    def report(self) -> dict:
        """The step-log report the acceptance suite asserts on —
        counts, never timing."""
        d = self.state.to_dict()
        d["completed"] = self.state.phase == DONE
        d["rolled_back"] = self.state.phase == ROLLED_BACK
        return d
