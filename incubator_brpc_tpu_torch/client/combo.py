"""Combo channels: Parallel / Selective / Partition.

Analogs of the reference's combo channels (SURVEY.md §2.6):
- ParallelChannel (parallel_channel.{h,cpp}): fan one logical RPC out
  to N sub-channels concurrently; CallMapper rewrites per-sub requests
  (parallel_channel.h:64-103), ResponseMerger folds sub-responses, and
  fail_limit bounds tolerated failures; a single shared completion
  closure counts sub-calls (parallel_channel.cpp:46-290).
- SelectiveChannel (selective_channel.h:31-52): load-balances between
  *channels* (server groups) with its own retry layer.
- PartitionChannel / DynamicPartitionChannel (partition_channel.h:
  54-110): sub-channels derived from NS tags "i/N"; the dynamic variant
  re-partitions live as the NS changes schemes.

Lowering note: when sub-responses are mesh-sharded tensors the
merge lowers to one collective (parallel/collectives.py); these classes
are the host-side control plane with per-sub-call failure semantics
(fail_limit, partial merges) that collectives don't have.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.utils.logging import log_error

# CallMapper(sub_index, total, request) -> request for that sub-channel
CallMapper = Callable[[int, int, object], object]
# ResponseMerger(response, sub_response, sub_index) -> None (folds in place)
ResponseMerger = Callable[[object, object, int], None]


def _default_merger(response, sub_response, _idx):
    if hasattr(response, "MergeFrom"):
        response.MergeFrom(sub_response)


def _note_fanout(method_spec, sub_ctrls) -> None:
    """Feed the completed fan-out's per-leg timings to the straggler
    tracker (/cluster/stragglers).  Per-leg server_time_us rides back in
    the response meta; the tracker splits each leg into server time vs
    wire+queue residual.  Best-effort: observability never fails an
    RPC."""
    try:
        legs = [
            (
                str(sc.remote_side or "") or f"sub{i}",
                sc.latency_us,
                sc.server_time_us,
                sc.failed(),
            )
            for i, sc in enumerate(sub_ctrls)
            if sc is not None
        ]
        if len(legs) < 2:
            return
        from incubator_brpc_tpu_torch.observability import cluster

        cluster.note_fanout(
            f"{method_spec.service_name}.{method_spec.method_name}", legs
        )
    except Exception as e:  # noqa: BLE001
        log_error("fan-out straggler tracking raised: %r", e)


@dataclass
class ParallelChannelOptions:
    fail_limit: int = 0  # tolerated sub-failures; 0 = none
    timeout_ms: int = 1000


class ParallelChannel:
    """Duck-types Channel.call_method, so ServiceStub works on it."""

    def __init__(self, options: Optional[ParallelChannelOptions] = None):
        self.options = options or ParallelChannelOptions()
        self._subs: List[tuple] = []  # (channel, mapper, merger)

    def add_channel(
        self,
        channel,
        call_mapper: Optional[CallMapper] = None,
        response_merger: Optional[ResponseMerger] = None,
    ) -> int:
        self._subs.append((channel, call_mapper, response_merger or _default_merger))
        return 0

    def channel_count(self) -> int:
        return len(self._subs)

    def call_method(self, method_spec, controller, request, response, done=None):
        from incubator_brpc_tpu_torch.observability.span import (
            Span,
            swap_current_span,
        )

        subs = list(self._subs)
        n = len(subs)
        if n == 0:
            controller.set_failed(errors.EINTERNAL, "ParallelChannel has no sub channels")
            if done:
                done()
            return
        start_ns = time.monotonic_ns()
        # rpcz fan-out span: the trace root every sub-call (and the
        # collective legs those sub-calls cross) parents under, so one
        # logical RPC reads as ONE trace in /rpcz?trace=
        fanout_span = Span.create_client(
            method_spec.service_name, method_spec.method_name
        )
        if fanout_span is not None:
            fanout_span.annotate(f"parallel fan-out over {n} sub channels")
        state = _FanoutState(n, self.options.fail_limit)

        sub_ctrls: List[Controller] = []
        sub_resps: List[object] = []
        sub_reqs: List[object] = []

        def finish():
            fails = 0
            skips = 0
            for i, sc in enumerate(sub_ctrls):
                if sc is None:
                    skips += 1
                    continue
                if sc.failed():
                    fails += 1
                else:
                    merger = subs[i][2]
                    try:
                        merger(response, sub_resps[i], i)
                    except Exception as e:  # noqa: BLE001
                        log_error("response merger raised: %r", e)
            if skips == n:
                controller.set_failed(
                    errors.EREQUEST, "CallMapper skipped every sub channel"
                )
            elif fails > self.options.fail_limit:
                first_err = next(
                    (sc for sc in sub_ctrls if sc is not None and sc.failed()), None
                )
                controller.set_failed(
                    errors.ETOOMANYFAILS,
                    f"{fails}/{n} sub calls failed"
                    + (f" (first: {first_err.error_text()})" if first_err else ""),
                )
            controller.latency_us = (time.monotonic_ns() - start_ns) // 1000
            _note_fanout(method_spec, sub_ctrls)
            if fanout_span is not None:
                fanout_span.end(controller.error_code)
            if done is not None:
                try:
                    done()
                except Exception as e:  # noqa: BLE001
                    log_error("ParallelChannel done raised: %r", e)

        # finish must be installed BEFORE any on_skip can bring the
        # remaining count to zero — an all-skip mapper otherwise fires
        # the completion with _finish still None.
        state.set_finish(finish)

        for i, (channel, mapper, merger) in enumerate(subs):
            sub_req = mapper(i, n, request) if mapper else request
            sub_reqs.append(sub_req)
            if sub_req is None:  # mapper may skip a sub-channel (SkipCall)
                sub_ctrls.append(None)
                sub_resps.append(None)
                state.on_skip()
                continue
            sc = Controller()
            sc.timeout_ms = (
                controller.timeout_ms
                if controller.timeout_ms is not None
                else self.options.timeout_ms
            )
            sub_ctrls.append(sc)
            sub_resps.append(method_spec.response_class())

        # issue sub-calls with the fan-out span installed as the
        # task-local parent: each sub Controller's client span (created
        # inside call_method → _start_call) joins this trace under it.
        # The whole issue loop runs inside one fabric delivery burst:
        # sub-calls crossing the ICI fabric enqueue their frames but
        # each destination port's completion queue wakes ONCE when the
        # loop ends (amortized window/credit bookkeeping — the
        # engine.cpp flush_pending_burst analog).  Sub-calls are async
        # (done callbacks), so nothing blocks inside the burst; TCP
        # sub-channels are unaffected.
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric

        prev_span = (
            swap_current_span(fanout_span)
            if fanout_span is not None
            else None
        )
        try:
            with get_fabric().delivery_burst():
                for i, (channel, mapper, merger) in enumerate(subs):
                    sc = sub_ctrls[i]
                    if sc is None:
                        continue
                    leg_done = state.make_done()
                    try:
                        channel.call_method(
                            method_spec, sc, sub_reqs[i], sub_resps[i],
                            done=leg_done,
                        )
                    except Exception as e:  # noqa: BLE001
                        # a raising sub-channel must not orphan its leg:
                        # the shared completion would otherwise never
                        # reach zero and the fan-out hangs until the
                        # wait() timeout.  leg_done is once-guarded, so
                        # a channel that raised AFTER scheduling its
                        # done cannot double-decrement either.
                        log_error("sub-channel call_method raised: %r", e)
                        if not sc.failed():
                            sc.set_failed(
                                errors.EINTERNAL, f"sub call raised: {e}"
                            )
                        leg_done()
        finally:
            if fanout_span is not None:
                swap_current_span(prev_span)
        if done is None:
            state.wait()
            # finish ran on the last completion; nothing else to do

    def call_many(self, method_spec, requests, timeout_ms=None,
                  controllers=None):
        """Windowed fan-out: N same-method requests fan to every
        sub-channel as ONE submission-ring sub-window per leg, so the
        Python↔C boundary is crossed once per LEG (shard), not once per
        (leg × request).  Per-request results come back in order:
        serialized merged response bytes per success, a
        ring.RingFailure per failure — the Channel.call_many contract.
        Merging/fail_limit semantics per request are exactly
        call_method's: each request's sub-responses fold through the
        leg's ResponseMerger and fails > fail_limit maps to
        ETOOMANYFAILS.

        Caller-provided controllers, or a sub-channel without a ring
        surface, degrade per call through ``call_method`` — byte-
        identical ERPC semantics, counted in the fan-out step log."""
        from incubator_brpc_tpu_torch.client import ring as _ring

        subs = list(self._subs)
        n = len(requests)
        if controllers is not None and len(controllers) != n:
            raise ValueError("controllers must match requests 1:1")
        if n == 0:
            return []
        if not subs:
            return [
                _ring.RingFailure(
                    errors.EINTERNAL, "ParallelChannel has no sub channels"
                )
                for _ in requests
            ]
        if controllers is not None and any(
            c is not None for c in controllers
        ) or any(
            not (hasattr(ch, "_submission_ring") and hasattr(ch, "_ring_lock"))
            for ch, _, _ in subs
        ):
            return self._call_many_percall(
                method_spec, requests, timeout_ms, controllers
            )
        nsubs = len(subs)
        # map per-leg requests up front; a mapper returning None skips
        # that (leg, request) pair, same as call_method's SkipCall
        leg_rows = []  # parallel to subs: [((leg, j), mapped_req), ...]
        for i, (ch, mapper, merger) in enumerate(subs):
            rows = []
            for j, req in enumerate(requests):
                sub_req = mapper(i, nsubs, req) if mapper else req
                if sub_req is not None:
                    rows.append(((i, j), sub_req))
            leg_rows.append(rows)
        locked = []
        try:
            legs = []
            for i, (ch, mapper, merger) in enumerate(subs):
                if not leg_rows[i]:
                    continue
                ch._ring_lock.acquire()
                locked.append(ch._ring_lock)
                legs.append((ch._submission_ring(), leg_rows[i]))
            resolved = (
                _ring.call_many_grouped(legs, method_spec, timeout_ms)
                if legs
                else {}
            )
        finally:
            for lock in locked:
                lock.release()
        results = []
        for j in range(n):
            response = method_spec.response_class()
            fails = 0
            skips = 0
            first_err = None
            for i, (ch, mapper, merger) in enumerate(subs):
                leg = resolved.get((i, j))
                if leg is None:
                    skips += 1
                    continue
                if isinstance(leg, _ring.RingFailure):
                    fails += 1
                    if first_err is None:
                        first_err = leg
                    continue
                sub_resp = method_spec.response_class()
                try:
                    sub_resp.ParseFromString(leg)
                    merger(response, sub_resp, i)
                except Exception as e:  # noqa: BLE001
                    log_error("response merger raised: %r", e)
            if skips == nsubs:
                results.append(_ring.RingFailure(
                    errors.EREQUEST, "CallMapper skipped every sub channel"
                ))
            elif fails > self.options.fail_limit:
                results.append(_ring.RingFailure(
                    errors.ETOOMANYFAILS,
                    f"{fails}/{nsubs} sub calls failed"
                    + (
                        f" (first: {first_err.error_text})"
                        if first_err
                        else ""
                    ),
                ))
            else:
                results.append(response.SerializeToString())
        return results

    def _call_many_percall(self, method_spec, requests, timeout_ms,
                           controllers):
        """Whole-window degradation: every request runs through the
        existing call_method fan-out — byte-identical semantics."""
        from incubator_brpc_tpu_torch.client import ring as _ring

        results = []
        for i, req in enumerate(requests):
            ctrl = controllers[i] if controllers is not None else None
            owned = ctrl is None
            if owned:
                ctrl = Controller()
            if timeout_ms is not None and ctrl.timeout_ms is None:
                ctrl.timeout_ms = timeout_ms
            resp = method_spec.response_class()
            self.call_method(method_spec, ctrl, req, resp)
            if ctrl.error_code:
                results.append(
                    _ring.RingFailure(ctrl.error_code, ctrl.error_text())
                )
            else:
                results.append(resp.SerializeToString())
        _ring.fanout_log.record(
            crossings=len(requests) * max(1, self.channel_count()),
            keys=len(requests),
            fallback_calls=len(requests),
        )
        return results


class _FanoutState:
    """Shared completion closure (analog ParallelChannelDone)."""

    def __init__(self, total: int, fail_limit: int):
        self._remaining = total
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._finish = None

    def set_finish(self, fn):
        self._finish = fn

    def on_skip(self):
        self._dec()

    def make_done(self):
        """One once-guarded completion closure per leg: a leg whose
        channel both raises (caller runs the fallback done) AND fires
        its async done later must decrement exactly once — a double
        decrement would make the real last leg miss zero and hang the
        fan-out for the full wait() timeout."""
        fired = [False]
        guard = threading.Lock()

        def _done():
            with guard:
                if fired[0]:
                    return
                fired[0] = True
            self._dec()

        return _done

    def _dec(self):
        with self._lock:
            self._remaining -= 1
            last = self._remaining == 0
        if last:
            try:
                self._finish()
            finally:
                self._event.set()

    def wait(self, timeout: float = 60.0):
        self._event.wait(timeout)


@dataclass
class SelectiveChannelOptions:
    max_retry: int = 1
    timeout_ms: int = 1000


class _GroupStats:
    """Per-sub-channel health for SelectiveChannel's LB: failure-rate
    EMA + live inflight count (a locality-aware-lite signal; reference
    runs a real LB over SubChannels, selective_channel.h:31-52)."""

    __slots__ = ("error_ema", "inflight", "lock")

    _ALPHA = 0.3
    UNHEALTHY = 0.6  # EMA above this → deprioritized

    def __init__(self):
        self.error_ema = 0.0
        self.inflight = 0
        self.lock = threading.Lock()

    def on_start(self):
        with self.lock:
            self.inflight += 1

    def on_done(self, failed: bool):
        with self.lock:
            self.inflight -= 1
            self.error_ema = (
                self._ALPHA * (1.0 if failed else 0.0)
                + (1 - self._ALPHA) * self.error_ema
            )


class SelectiveChannel:
    """LB across channels (server groups) with its own retry layer:
    selection prefers healthy groups (failure-EMA feedback) with the
    lowest inflight, and an RPC's retries never re-pick a group that
    already failed it (reference SelectiveChannel's LB + retry layer)."""

    def __init__(self, options: Optional[SelectiveChannelOptions] = None):
        self.options = options or SelectiveChannelOptions()
        self._channels: List[object] = []
        self._stats: List[_GroupStats] = []
        self._counter = itertools.count()

    def add_channel(self, channel) -> int:
        """Returns a channel handle (its index)."""
        # stats BEFORE channel: a concurrent _select indexes _stats for
        # every index it sees in _channels
        self._stats.append(_GroupStats())
        self._channels.append(channel)
        return len(self._channels) - 1

    def remove_and_destroy_channel(self, handle: int):
        if 0 <= handle < len(self._channels):
            self._channels[handle] = None

    def _select(self, excluded: set) -> Optional[int]:
        """Healthy-first, least-inflight, round-robin tiebreak."""
        live = [
            i for i, c in enumerate(self._channels)
            if c is not None and i not in excluded
        ]
        if not live:
            return None
        healthy = [i for i in live if self._stats[i].error_ema < _GroupStats.UNHEALTHY]
        pool = healthy or live  # all sick: let traffic probe them
        rr = next(self._counter)
        # tiebreak rotates by POSITION in the pool (raw indices can be
        # congruent mod len(pool) and would pin traffic to one group)
        return min(
            enumerate(pool),
            key=lambda kv: (self._stats[kv[1]].inflight, (kv[0] - rr) % len(pool)),
        )[1]

    def call_method(self, method_spec, controller, request, response, done=None):
        if not any(c is not None for c in self._channels):
            controller.set_failed(errors.EINTERNAL, "SelectiveChannel is empty")
            if done:
                done()
            return
        attempts = 1 + max(0, self.options.max_retry)
        start_ns = time.monotonic_ns()

        def run_sync():
            last_ctrl = None
            excluded: set = set()
            for _k in range(attempts):
                idx = self._select(excluded)
                if idx is None:
                    excluded.clear()  # every group tried: allow repeats
                    idx = self._select(excluded)
                    if idx is None:
                        break
                ch = self._channels[idx]
                if ch is None:  # raced remove_and_destroy_channel
                    excluded.add(idx)
                    continue
                stats = self._stats[idx]
                sc = Controller()
                sc.timeout_ms = (
                    controller.timeout_ms
                    if controller.timeout_ms is not None
                    else self.options.timeout_ms
                )
                sub_resp = method_spec.response_class()
                stats.on_start()
                try:
                    ch.call_method(method_spec, sc, request, sub_resp, None)
                finally:
                    stats.on_done(sc.failed())
                last_ctrl = sc
                if not sc.failed():
                    response.CopyFrom(sub_resp)
                    controller.latency_us = (time.monotonic_ns() - start_ns) // 1000
                    return
                excluded.add(idx)
            controller.set_failed(
                last_ctrl.error_code if last_ctrl else errors.EINTERNAL,
                f"all {attempts} group attempts failed: "
                + (last_ctrl.error_text() if last_ctrl else ""),
            )
            controller.latency_us = (time.monotonic_ns() - start_ns) // 1000

        if done is None:
            run_sync()
        else:
            from incubator_brpc_tpu_torch.runtime import scheduler

            def run_async():
                run_sync()
                done()

            scheduler.spawn(run_async)


class PartitionParser:
    """Parse NS tags like "2/5" → (index, count) (reference
    PartitionParser, partition_channel.h)."""

    def parse(self, tag: str):
        try:
            idx, _, cnt = tag.partition("/")
            return int(idx), int(cnt)
        except ValueError:
            return None


class PartitionChannel:
    """ParallelChannel whose sub-channels are the partitions discovered
    from NS tags; DynamicPartitionChannel (dynamic=True) re-partitions
    live as the naming data changes schemes."""

    def __init__(
        self,
        options: Optional[ParallelChannelOptions] = None,
        parser: Optional[PartitionParser] = None,
        dynamic: bool = True,
    ):
        self.options = options or ParallelChannelOptions()
        self._parser = parser or PartitionParser()
        self._dynamic = dynamic
        self._lock = threading.Lock()
        self._partitions: List[object] = []  # index -> sub Channel-like
        self._ns_thread = None
        self._sub_options = None
        self._lb_name = "rr"  # init() overrides; manual feeders
        # (on_servers_changed without init) get a working default

    def init(self, naming_url: str, lb_name: str = "rr", sub_options=None) -> int:
        from incubator_brpc_tpu_torch.client.naming_service import NamingServiceThread

        self._sub_options = sub_options
        self._lb_name = lb_name
        self._ns_thread = NamingServiceThread.get(naming_url)
        if self._ns_thread is None:
            return errors.EREQUEST
        self._ns_thread.add_watcher(self)
        return 0

    def on_servers_changed(self, nodes):
        """Group nodes by partition tag i/N and (re)build sub channels."""
        groups = {}
        max_count = 0
        for node in nodes:
            parsed = self._parser.parse(node.tag)
            if parsed is None:
                continue
            idx, cnt = parsed
            max_count = max(max_count, cnt)
            groups.setdefault(idx, []).append(node)
        with self._lock:
            if not self._dynamic and self._partitions:
                # static variant keeps its first scheme AND its channel
                # objects: a fan-out burst snapshots the partition list
                # at issue time, so rebuilding fresh channels here would
                # leave in-flight legs on orphaned channels (whose late
                # completions nobody owns) while the next call fans out
                # over cold ones — refresh membership in place instead
                # (exactly-once per shard across a membership flap)
                for i, part in enumerate(self._partitions):
                    if isinstance(part, _ManualClusterChannel):
                        part.set_nodes(groups.get(i, []))
                return
            new_parts = []
            for i in range(max_count):
                part = _ManualClusterChannel(self._lb_name, self._sub_options)
                part.set_nodes(groups.get(i, []))
                new_parts.append(part)
            self._partitions = new_parts

    def partition_count(self) -> int:
        return len(self._partitions)

    def call_method(self, method_spec, controller, request, response, done=None):
        with self._lock:
            parts = list(self._partitions)
        pc = ParallelChannel(
            ParallelChannelOptions(
                fail_limit=self.options.fail_limit,
                timeout_ms=self.options.timeout_ms,
            )
        )
        for part in parts:
            pc.add_channel(part)
        pc.call_method(method_spec, controller, request, response, done)


class DynamicPartitionChannel(PartitionChannel):
    """Partition channel where MULTIPLE partition schemes coexist while
    naming data migrates (reference DynamicPartitionChannel +
    DynPartLoadBalancer, policy/dynpart_load_balancer.cpp:44-162).

    Servers tagged 0/3,1/3,2/3 and 0/4..3/4 form TWO schemes; every
    request picks one scheme with probability proportional to its LIVE
    server count (the dynpart weighting), then fans out across that
    scheme's partitions.  Rolling a fleet from 3-partition to
    4-partition therefore shifts traffic gradually with capacity —
    no flag flip, no thundering cutover."""

    class _SchemeEntry:
        """One selectable partition scheme, fed to DynPartLB with a
        LIVE weight callable (the schan sub-channel + GetSubChannelWeight
        pairing of the reference)."""

        __slots__ = ("count", "parts", "live")

        def __init__(self, count, parts, live):
            self.count = count
            self.parts = parts
            self.live = live

        def dynpart_weight(self):
            return self.live

    def __init__(
        self,
        options: Optional[ParallelChannelOptions] = None,
        parser: Optional[PartitionParser] = None,
    ):
        from incubator_brpc_tpu_torch.client.load_balancer import DynPartLB

        super().__init__(options=options, parser=parser, dynamic=True)
        # scheme_count -> (parts, live_server_total, complete)
        self._schemes = {}
        # selection among complete schemes runs through the DynPart LB
        self._dynpart_lb = DynPartLB()

    def on_servers_changed(self, nodes):
        groups = {}  # N -> {idx: [nodes]}
        for node in nodes:
            parsed = self._parser.parse(node.tag)
            if parsed is None:
                continue
            idx, cnt = parsed
            if cnt <= 0 or idx < 0 or idx >= cnt:
                continue
            groups.setdefault(cnt, {}).setdefault(idx, []).append(node)
        new_schemes = {}
        for cnt, idxmap in groups.items():
            parts = []
            for i in range(cnt):
                part = _ManualClusterChannel(self._lb_name, self._sub_options)
                part.set_nodes(idxmap.get(i, []))
                parts.append(part)
            live = sum(len(v) for v in idxmap.values())
            complete = all(i in idxmap for i in range(cnt))
            new_schemes[cnt] = (parts, live, complete)
        with self._lock:
            self._schemes = new_schemes
            # the LB selects among COMPLETE schemes, each weighted by
            # its live server count (weight callables read `entry.live`)
            self._dynpart_lb.reset_servers(
                [
                    self._SchemeEntry(c, parts, live)
                    for c, (parts, live, ok) in new_schemes.items()
                    if ok and live > 0
                ]
            )
            # keep the base-class view pointing at the largest complete
            # scheme so partition_count() stays meaningful
            best = max(
                (c for c, (_, _, ok) in new_schemes.items() if ok),
                default=0,
            )
            self._partitions = new_schemes.get(best, ([], 0, False))[0]

    def scheme_counts(self):
        """{partition_count: live_server_total} for complete schemes."""
        with self._lock:
            return {
                c: live
                for c, (_, live, ok) in self._schemes.items()
                if ok
            }

    def call_method(self, method_spec, controller, request, response, done=None):
        from incubator_brpc_tpu_torch.client.load_balancer import SelectIn

        entry = self._dynpart_lb.select_server(SelectIn())
        if entry is None:
            controller.set_failed(
                errors.EFAILEDSOCKET, "no complete partition scheme"
            )
            if done:
                done()
            return
        parts = entry.parts
        pc = ParallelChannel(
            ParallelChannelOptions(
                fail_limit=self.options.fail_limit,
                timeout_ms=self.options.timeout_ms,
            )
        )
        for part in parts:
            pc.add_channel(part)
        pc.call_method(method_spec, controller, request, response, done)


class ShardRoutedChannel(PartitionChannel):
    """The shard-aware PartitionChannel of the pod-scale parameter
    server (docs/sharded_ps.md): partitions are SHARDS that own a slice
    of the keyspace/parameter rows, and the channel routes by contract:

    * **routed methods** (the default — Get/Put and anything else):
      one RPC to the key's owning shard, nothing to the others.  The
      shard index is a pure function of (seed, key, shard count) —
      murmur3 — so the same key maps to the same shard across channel
      rebuilds and process restarts.
    * **fan-out methods** (``set_fanout``): ONE fan-out across every
      shard, issued inside a single fabric delivery burst (each
      destination port's completion queue wakes once for the whole
      fan-out), with per-leg rpcz client spans joined under one
      fan-out root span.  ``prepare_leg`` stamps each leg's sub
      controller (e.g. slicing the request attachment by shard rows);
      ``merge`` folds the per-shard partial results — for tensor
      partials, one fused device op (ops/merge), the host-side analog
      of the collective merge the in-mesh lowering uses.

    Failure semantics are the combo-channel contract: a dead
    shard fails only its leg; ``fail_limit`` bounds tolerated leg
    failures, beyond it the parent fails ``ETOOMANYFAILS`` — always
    ERPC codes, never hangs.

    Shards come from ``set_partitions`` (explicit channels),
    ``from_endpoints`` (e.g. ``ici_endpoints()`` — the mesh topology as
    the shard map), or the inherited naming-layer ``init`` (NS tags
    "i/N" define shard identity).
    """

    def __init__(
        self,
        options: Optional[ParallelChannelOptions] = None,
        parser: Optional[PartitionParser] = None,
        key_fn: Optional[Callable[[object], str]] = None,
        seed: int = 0,
    ):
        super().__init__(options=options, parser=parser, dynamic=False)
        self._key_fn = key_fn or (
            lambda req: str(getattr(req, "message", "") or "")
        )
        self._seed = int(seed)
        # method_name -> (prepare_leg, merge); see set_fanout
        self._fanout: dict = {}

    @classmethod
    def from_endpoints(
        cls,
        endpoints,
        options: Optional[ParallelChannelOptions] = None,
        channel_options=None,
        **kw,
    ) -> "ShardRoutedChannel":
        """One sub-channel per endpoint, in endpoint order — pass
        ``parallel.mesh.ici_endpoints(mesh)`` to shard across the mesh
        coordinates (chip-major within each slice: consecutive shards
        ride the ICI axis first, per the mesh convention)."""
        from incubator_brpc_tpu_torch.client.channel import Channel

        ch = cls(options=options, **kw)
        subs = []
        for ep in endpoints:
            sub = Channel(channel_options)
            rc = sub.init(str(ep))
            if rc != 0:
                raise ValueError(f"cannot init shard channel to {ep}")
            subs.append(sub)
        ch.set_partitions(subs)
        return ch

    def set_partitions(self, channels) -> None:
        with self._lock:
            self._partitions = list(channels)

    def partitions(self) -> List[object]:
        with self._lock:
            return list(self._partitions)

    def set_fanout(self, method_name: str, prepare_leg=None, merge=None):
        """Mark `method_name` as a fan-out method.

        prepare_leg(i, n, request, parent_ctrl, sub_ctrl) -> sub request
          (or None to skip that shard); it may stamp sub_ctrl (slice the
          parent's request attachment, set request_code, ...).  Raising
          fails the parent EREQUEST before any leg is issued.
        merge(parent_ctrl, parent_resp, sub_ctrls, sub_resps) -> None
          folds successful legs (failed legs arrive as failed
          controllers; with fail_limit > 0 the merge sees a partial
          set — the degraded-mode contract).
        """
        self._fanout[method_name] = (prepare_leg, merge)

    def shard_of(self, key: str, n: Optional[int] = None) -> int:
        """Owning shard of `key` — pure in (seed, key, n), so the
        mapping survives restarts as long as the shard count and
        ordering do (endpoint order / NS tag index)."""
        from incubator_brpc_tpu_torch.utils.hashes import murmur3_32

        if n is None:
            n = self.partition_count()
        if n <= 0:
            raise ValueError("ShardRoutedChannel has no shards")
        return murmur3_32(str(key).encode(), seed=self._seed) % n

    def call_method(self, method_spec, controller, request, response, done=None):
        with self._lock:
            parts = list(self._partitions)
        if not parts:
            controller.set_failed(
                errors.EINTERNAL, "ShardRoutedChannel has no shards"
            )
            if done:
                done()
            return
        fan = self._fanout.get(method_spec.method_name)
        if fan is not None and len(parts) > 1:
            return self._call_fanout(
                parts, fan, method_spec, controller, request, response, done
            )
        # routed: exactly one RPC, to the owning shard (single-shard
        # deployments route everything — a fan-out over one shard is
        # the same call with extra steps)
        idx = self.shard_of(self._key_fn(request), len(parts)) if len(parts) > 1 else 0
        controller.shard_index = idx
        parts[idx].call_method(method_spec, controller, request, response, done)

    def call_many(self, method_spec, requests, timeout_ms=None,
                  controllers=None):
        """Windowed shard fan-out: route each request to its owning
        shard (same murmur3 contract as call_method) and submit every
        shard's group as ONE sub-window through that shard channel's
        submission ring — a 64-key window crosses the C boundary once
        per SHARD, not once per key.  All shard sub-windows are flushed
        before any is harvested, so they are in flight concurrently.
        Results return in request order: response bytes per success, a
        ring.RingFailure per failure (the Channel.call_many contract).

        Caller-provided controllers degrade THAT call to the routed
        per-call path (its controller keeps every per-call override);
        shard channels without a ring surface degrade their group per
        call — byte-identical ERPC semantics either way, recorded as
        fan-out fallback_calls in the step log."""
        from incubator_brpc_tpu_torch.client import ring as _ring

        n = len(requests)
        if controllers is not None and len(controllers) != n:
            raise ValueError("controllers must match requests 1:1")
        if n == 0:
            return []
        with self._lock:
            parts = list(self._partitions)
        if not parts:
            return [
                _ring.RingFailure(
                    errors.EINTERNAL, "ShardRoutedChannel has no shards"
                )
                for _ in requests
            ]
        results = [None] * n
        percall = []   # (orig idx, request, controller)
        grouped = {}   # shard idx -> [(orig idx, request), ...]
        nparts = len(parts)
        for i, req in enumerate(requests):
            ctrl = controllers[i] if controllers is not None else None
            if ctrl is not None:
                percall.append((i, req, ctrl))
                continue
            idx = (
                self.shard_of(self._key_fn(req), nparts)
                if nparts > 1
                else 0
            )
            grouped.setdefault(idx, []).append((i, req))
        ring_legs = []   # (sub channel, rows) with a ring surface
        plain_rows = []  # (sub channel, rows) without one
        for idx in sorted(grouped):
            sub = parts[idx]
            rows = grouped[idx]
            if hasattr(sub, "_submission_ring") and hasattr(sub, "_ring_lock"):
                ring_legs.append((sub, rows))
            else:
                plain_rows.append((sub, rows))
        if ring_legs:
            # locks taken in shard-index order (deterministic, so two
            # concurrent fan-outs over overlapping shards cannot
            # deadlock), held until every leg drained: the sub-windows
            # share the channels' call_many rings
            locked = []
            try:
                legs = []
                for sub, rows in ring_legs:
                    sub._ring_lock.acquire()
                    locked.append(sub._ring_lock)
                    legs.append((sub._submission_ring(), rows))
                for orig, res in _ring.call_many_grouped(
                    legs, method_spec, timeout_ms
                ).items():
                    results[orig] = res
            finally:
                for lock in locked:
                    lock.release()
        fallback_calls = 0
        for sub, rows in plain_rows:
            fallback_calls += len(rows)
            for orig, req in rows:
                ctrl = Controller()
                if timeout_ms is not None:
                    ctrl.timeout_ms = timeout_ms
                resp = method_spec.response_class()
                sub.call_method(method_spec, ctrl, req, resp)
                results[orig] = (
                    _ring.RingFailure(ctrl.error_code, ctrl.error_text())
                    if ctrl.error_code
                    else resp.SerializeToString()
                )
        for orig, req, ctrl in percall:
            fallback_calls += 1
            resp = method_spec.response_class()
            self.call_method(method_spec, ctrl, req, resp)
            results[orig] = (
                _ring.RingFailure(ctrl.error_code, ctrl.error_text())
                if ctrl.error_code
                else resp.SerializeToString()
            )
        if plain_rows or percall:
            _ring.fanout_log.record(
                crossings=fallback_calls,
                keys=fallback_calls,
                fallback_calls=fallback_calls,
            )
        return results

    def _call_fanout(
        self, parts, fan, method_spec, controller, request, response, done
    ):
        from incubator_brpc_tpu_torch.observability.span import (
            Span,
            swap_current_span,
        )

        prepare_leg, merge = fan
        n = len(parts)
        start_ns = time.monotonic_ns()
        fanout_span = Span.create_client(
            method_spec.service_name, method_spec.method_name
        )
        if fanout_span is not None:
            fanout_span.annotate(f"shard fan-out over {n} shards")
        state = _FanoutState(n, self.options.fail_limit)
        sub_ctrls: List[Optional[Controller]] = []
        sub_resps: List[object] = []
        sub_reqs: List[object] = []

        def finish():
            fails = sum(
                1 for sc in sub_ctrls if sc is not None and sc.failed()
            )
            skips = sum(1 for sc in sub_ctrls if sc is None)
            if skips == n:
                controller.set_failed(
                    errors.EREQUEST, "prepare_leg skipped every shard"
                )
            elif fails > self.options.fail_limit:
                first_err = next(
                    (sc for sc in sub_ctrls if sc is not None and sc.failed()),
                    None,
                )
                controller.set_failed(
                    errors.ETOOMANYFAILS,
                    f"{fails}/{n} shard legs failed"
                    + (
                        f" (first: {first_err.error_text()})"
                        if first_err
                        else ""
                    ),
                )
            else:
                try:
                    if merge is not None:
                        merge(controller, response, sub_ctrls, sub_resps)
                    else:
                        for i, sc in enumerate(sub_ctrls):
                            if sc is not None and not sc.failed():
                                _default_merger(response, sub_resps[i], i)
                except Exception as e:  # noqa: BLE001
                    log_error("shard merge raised: %r", e)
                    controller.set_failed(
                        errors.EINTERNAL, f"shard merge failed: {e}"
                    )
            controller.latency_us = (time.monotonic_ns() - start_ns) // 1000
            _note_fanout(method_spec, sub_ctrls)
            if fanout_span is not None:
                fanout_span.end(controller.error_code)
            if done is not None:
                try:
                    done()
                except Exception as e:  # noqa: BLE001
                    log_error("ShardRoutedChannel done raised: %r", e)

        state.set_finish(finish)
        for i in range(n):
            sc = Controller()
            sc.timeout_ms = (
                controller.timeout_ms
                if controller.timeout_ms is not None
                else self.options.timeout_ms
            )
            try:
                sub_req = (
                    prepare_leg(i, n, request, controller, sc)
                    if prepare_leg is not None
                    else request
                )
            except Exception as e:  # noqa: BLE001
                controller.set_failed(
                    errors.EREQUEST, f"prepare_leg failed: {e}"
                )
                if fanout_span is not None:
                    fanout_span.end(controller.error_code)
                if done:
                    done()
                return
            sub_reqs.append(sub_req)
            if sub_req is None:
                sub_ctrls.append(None)
                sub_resps.append(None)
                continue
            sub_ctrls.append(sc)
            sub_resps.append(method_spec.response_class())
        # one burst, one trace: every leg issues inside a single fabric
        # delivery burst (per-port CQ wakes once for the whole fan-out)
        # with the fan-out span as task-local parent, so per-leg client
        # spans — and the collective legs under them — join one trace
        from incubator_brpc_tpu_torch.parallel.ici import (
            get_fabric,
            ici_pallas_stacked_segments,
        )

        prev_span = (
            swap_current_span(fanout_span) if fanout_span is not None else None
        )
        fabric = get_fabric()
        # on the Pallas data plane, same-shape device payloads of a
        # fan-out burst coalesce into stacked kernel dispatches at the
        # fabric layer — count the coalesced segments so the trace
        # proves the collective lowering fired (or didn't)
        stacked_before = (
            int(ici_pallas_stacked_segments.get_value())
            if fabric.chunk_mode == "pallas" and fanout_span is not None
            else None
        )
        try:
            with fabric.delivery_burst():
                for i in range(n):
                    sc = sub_ctrls[i]
                    if sc is None:
                        state.on_skip()
                        continue
                    leg_done = state.make_done()
                    try:
                        parts[i].call_method(
                            method_spec, sc, sub_reqs[i], sub_resps[i],
                            done=leg_done,
                        )
                    except Exception as e:  # noqa: BLE001
                        # exactly-once per shard even when a leg's
                        # channel raises (e.g. membership flapped and
                        # the partition lost its servers mid-burst):
                        # fail THIS leg and complete it — never orphan
                        # the shared completion, never re-issue.
                        log_error("shard leg call_method raised: %r", e)
                        if not sc.failed():
                            sc.set_failed(
                                errors.EINTERNAL, f"shard leg raised: {e}"
                            )
                        leg_done()
        finally:
            if stacked_before is not None:
                stacked = (
                    int(ici_pallas_stacked_segments.get_value())
                    - stacked_before
                )
                if stacked:
                    fanout_span.annotate(
                        f"pallas stacked fan-out: {stacked} segments "
                        f"coalesced"
                    )
            if fanout_span is not None:
                swap_current_span(prev_span)
        if done is None:
            state.wait()


class DynamicShardChannel:
    """Two `ShardRoutedChannel`s (the OLD N-shard and the NEW M-shard
    scheme) behind one Channel duck-type, routed per-call by the live
    re-sharding migration's phase/epoch (resharding/migration.py,
    docs/resharding.md) — the sharded-store analog of
    DynamicPartitionChannel's scheme coexistence:

    * the **authoritative** scheme is OLD until the migration's epoch
      bump (CUTOVER published through naming), NEW after it.  Every
      call snapshots (authoritative, other) ONCE at entry, so an
      in-flight fan-out finishes on the scheme it started on even if
      the epoch bumps under it — no mixed-scheme fan-out, no
      stale-route EINTERNALs.
    * **fan-out methods** (e.g. Forward) go to the authoritative
      scheme only: every shard of one scheme holds a complete row
      partition, so one scheme is always sufficient and dual fan-out
      would double device work.
    * **writes** (``write_methods``) dual-apply while the migration is
      between DUAL_WRITE and CUTOVER: the authoritative leg decides
      the caller-visible result; the other scheme's leg is best-effort
      (counted, never failing the parent) so keys written mid-COPY are
      already in place on their new owner at cutover.
    * **reads** try the authoritative scheme and, while a migration is
      in flight, fall back to the other scheme on failure — a source
      shard that died mid-COPY serves reads from the dual-written/
      copied replica on the other scheme (counted in
      ``reads_fell_back``).
    """

    WRITE_METHODS = frozenset({"Put", "Set", "Delete"})

    def __init__(self, old_channel, new_channel, view, write_methods=None):
        self._old = old_channel
        self._new = new_channel
        self._view = view
        self._write = (
            frozenset(write_methods)
            if write_methods is not None
            else self.WRITE_METHODS
        )
        # step-log counters (the zero-downtime proof reads these)
        self.reads_fell_back = 0
        self.dual_writes = 0
        self.dual_write_misses = 0  # best-effort leg failed (counted only)
        self._stat_lock = threading.Lock()

    # -- scheme snapshot ----------------------------------------------------
    def channels(self):
        """(authoritative, other) at THIS instant — call once per RPC."""
        if self._view.cut_over():
            return self._new, self._old
        return self._old, self._new

    def epoch(self) -> int:
        return self._view.epoch

    def shard_of(self, key: str) -> int:
        auth, _ = self.channels()
        return auth.shard_of(key)

    def partition_count(self) -> int:
        auth, _ = self.channels()
        return auth.partition_count()

    def set_fanout(self, method_name: str, prepare_leg=None, merge=None):
        """Fan-out config applies to BOTH schemes (each leg count n is
        passed to prepare_leg, so the same slicer serves N and M)."""
        self._old.set_fanout(method_name, prepare_leg, merge)
        self._new.set_fanout(method_name, prepare_leg, merge)

    # -- the routed/dual/fallback call plane --------------------------------
    def call_method(self, method_spec, controller, request, response, done=None):
        primary, other = self.channels()
        m = method_spec.method_name
        if m in getattr(primary, "_fanout", {}):
            # one scheme, snapshot at issue: in-flight fan-outs finish
            # on the scheme they started on across a cutover
            return primary.call_method(
                method_spec, controller, request, response, done
            )
        migrating = self._view.migrating()
        if m in self._write and migrating and self._view.dual_writing():
            return self._call_dual_write(
                primary, other, method_spec, controller, request, response,
                done,
            )
        if migrating:
            return self._call_with_fallback(
                primary, other, method_spec, controller, request, response,
                done,
            )
        return primary.call_method(
            method_spec, controller, request, response, done
        )

    @staticmethod
    def _sub_controller(controller) -> Controller:
        sc = Controller()
        sc.timeout_ms = controller.timeout_ms
        return sc

    @staticmethod
    def _adopt(controller, response, sc, sub_resp):
        """Fold a successful sub-attempt into the parent call."""
        if hasattr(response, "CopyFrom"):
            response.CopyFrom(sub_resp)
        if not sc.response_attachment.empty():
            controller.response_attachment = sc.response_attachment
        controller.latency_us = sc.latency_us
        controller.shard_index = getattr(sc, "shard_index", None)

    def _call_dual_write(
        self, primary, other, method_spec, controller, request, response, done
    ):
        # the request attachment is consumed by the first send: snapshot
        # it up front so the best-effort leg carries its own copy
        attach = (
            controller.request_attachment.to_bytes()
            if not controller.request_attachment.empty()
            else None
        )

        def run_sync():
            primary.call_method(method_spec, controller, request, response)
            sc = self._sub_controller(controller)
            if attach is not None:
                sc.request_attachment.append(attach)
            sub_resp = method_spec.response_class()
            try:
                other.call_method(method_spec, sc, request, sub_resp)
            except Exception as e:  # noqa: BLE001
                log_error("dual-write secondary leg raised: %r", e)
                sc.set_failed(errors.EINTERNAL, str(e))
            with self._stat_lock:
                self.dual_writes += 1
                if sc.failed():
                    self.dual_write_misses += 1

        if done is None:
            run_sync()
        else:
            from incubator_brpc_tpu_torch.runtime import scheduler

            def run_async():
                run_sync()
                done()

            scheduler.spawn(run_async)

    def _call_with_fallback(
        self, primary, other, method_spec, controller, request, response, done
    ):
        attach = (
            controller.request_attachment.to_bytes()
            if not controller.request_attachment.empty()
            else None
        )

        def run_sync():
            sc = self._sub_controller(controller)
            if attach is not None:
                sc.request_attachment.append(attach)
            sub_resp = method_spec.response_class()
            try:
                primary.call_method(method_spec, sc, request, sub_resp)
            except Exception as e:  # noqa: BLE001
                log_error("primary scheme read raised: %r", e)
                sc.set_failed(errors.EINTERNAL, str(e))
            if not sc.failed():
                self._adopt(controller, response, sc, sub_resp)
                return
            sc2 = self._sub_controller(controller)
            if attach is not None:
                sc2.request_attachment.append(attach)
            sub_resp2 = method_spec.response_class()
            try:
                other.call_method(method_spec, sc2, request, sub_resp2)
            except Exception as e:  # noqa: BLE001
                log_error("fallback scheme read raised: %r", e)
                sc2.set_failed(errors.EINTERNAL, str(e))
            if not sc2.failed():
                self._adopt(controller, response, sc2, sub_resp2)
                with self._stat_lock:
                    self.reads_fell_back += 1
                return
            # both schemes failed: surface the AUTHORITATIVE error
            controller.set_failed(
                sc.error_code,
                f"both schemes failed (authoritative: {sc.error_text()}; "
                f"fallback: {sc2.error_text()})",
            )

        if done is None:
            run_sync()
        else:
            from incubator_brpc_tpu_torch.runtime import scheduler

            def run_async():
                run_sync()
                done()

            scheduler.spawn(run_async)


class ManualClusterChannel:
    """A Channel over a manually-fed node set (one partition): no
    naming thread — ``set_nodes`` IS the membership feed.  The
    replication tier's building block: per-group read channels (hedged,
    mesh-locality) and leader channels are ManualClusterChannels whose
    node sets the ReplicatedShardChannel refreshes off the group's
    ``members_version``."""

    def __init__(self, lb_name: str, options=None):
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.client.lb_with_naming import LoadBalancerWithNaming
        from incubator_brpc_tpu_torch.client.load_balancer import create_load_balancer

        self._channel = Channel(options)
        self._channel.protocol = None
        lb = LoadBalancerWithNaming()
        lb._lb = create_load_balancer(lb_name)
        self._lbwn = lb
        # bind manually: no NS thread; set_nodes feeds membership
        from incubator_brpc_tpu_torch.global_init import global_init
        from incubator_brpc_tpu_torch.protocols import find_protocol

        global_init()
        self._channel.protocol = find_protocol(self._channel.options.protocol)
        self._channel._lb = lb
        self._channel._init_done = True

    def set_nodes(self, nodes):
        self._lbwn.on_servers_changed(list(nodes))

    def call_method(self, method_spec, controller, request, response, done=None):
        self._channel.call_method(method_spec, controller, request, response, done)


#: pre-PR-18 private name — kept for in-tree callers
_ManualClusterChannel = ManualClusterChannel


def session_channel(prefill, replicas, coords=None):
    """Factory for the serving tier's combo plane: a
    ``serving/router.SessionChannel`` routing a session's prefill to
    the prefill tier and its decode legs across ``replicas`` with
    live migration (docs/serving.md).  Lives behind a factory so
    importing combo.py stays jax-free; the class is also importable
    lazily as ``combo.SessionChannel``."""
    from incubator_brpc_tpu_torch.serving.router import SessionChannel

    return SessionChannel(prefill, replicas, coords=coords)


def __getattr__(name):
    if name == "SessionChannel":
        from incubator_brpc_tpu_torch.serving.router import SessionChannel

        return SessionChannel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
