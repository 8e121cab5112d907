"""The faults the carried JAX suites found in code the port shares with the
JAX package, each fixed in the port and pinned here by a case that fails on a
copy with the fix reverted (ROADMAP queue 3, "Fixed in the port").

``metrics/window.py``: the windowed extremum counts the second under way.
``LatencyRecorder.max_latency()`` reads a ``Window`` over a ``Maxer``.  The
1 Hz sampler resets the reducer into the window's samples; in the JAX
package a value recorded after the last tick is invisible until the next
one, so a tick that lands between a recorder's creation and its first
updates makes ``max_latency()`` read 0 after 1000 updates (the race behind
``tests/test_metrics.py::test_latency_recorder_percentiles`` failing about
one run in three).  The port's window adds the reducer's live value when it
holds one, and reads it before the window's samples: a tick between the two
reads would otherwise move it out of the reducer into a sample the read had
already copied (``test_max_latency_sees_updates_after_a_tick`` read 0 about
one run in 12 with twelve runs of this file at once on a loaded host).
Here the ticks are forced, so the cases are deterministic.

``client/naming_service.py``, ``client/lb_with_naming.py``: a channel on a
naming-service URL waits for the service's first server list, as the
reference does (``WaitForFirstBatchOfServers``).  In the JAX package
``Channel.init`` returns before the naming thread ran, so a first call made
at once can find no server ("failed to select/connect server"; the carried
``tests/test_overload_storm.py::test_cancel_frame_with_unknown_cid_is_ignored``
failed so under load).  Here the naming thread is made late on purpose.

``client/combo.py``: ``ShardRoutedChannel.call_many`` keeps each reply's
attachment on its per-call fallback.  A shard channel without a ring surface
(a combo of combos) runs its group through ``call_method``; in the JAX
package the slot then holds the message alone and the value a ``Get``
returned as its attachment is lost.  The port returns it as a
``ring.RingReply``, as ``Channel.call_many`` does.

``metrics/latency_recorder.py``, ``observability/latency_breakdown.py``: a
``/metrics`` page reads each phase recorder once.  The JAX package reads
count, average, p50 and p99 of each recorder one call at a time, and each
call folds the recorder's batched writes first: five folds a recorder a
page, so the page slows with the number of (method, phase) keys a process
has seen.  The port reads them through ``LatencyRecorder.stats()``, one fold
a recorder, and prints the same values.  ``mergeable_snapshot()`` (the state
``/cluster/export`` sends) folds once too, where the JAX package folds four
times, and exports the same state.

``metrics/latency_recorder.py``, ``metrics/window.py``: a read of a window
sees a tick whole.  The 1 Hz tick moves a recorder's live second into its
window in two steps (the buckets into ``Percentile``'s ring, the sum into
``_win_sum``), and in the JAX package each step runs partly outside the lock
that guards the live value: ``bucket_totals()`` copies the ring and then
reads the live buckets, ``mergeable_snapshot()`` copies ``_win_sum`` and
then reads the live sum, so a tick between the two reads drops the live
second (five samples in the ring and seven live read 12, then 5, then 12).
The port's tick and its readers share the recorder's ``_window_lock``, and
``Percentile`` keeps a running total of its ring under its own lock, so
``bucket_totals()`` is one pass over the buckets.  The windowed extremum's
tick resets the reducer and appends the value under the sampler's lock, and
its read of the samples takes that lock: a read between the reset and the
append found neither.  Here the ticks are forced between the reads, and a
tick loop runs beside four readers.

``transport/acceptor.py``: a server counts a connection from its accept on.
The acceptor adds a new connection to its set only after ``Socket.create``
returns, and ``Socket.create`` has already handed the socket to the event
dispatcher, so the connection's first request can reach its handler while
``Server.connection_count()`` still leaves it out (the carried
``tests/test_connection_types.py::test_http_defaults_to_pooled_and_uses_distinct_connections``
counted 3 connections for 4 parked requests about one loaded run in 20, in
both packages).  The port counts a connection while its socket is being
created.  Here the acceptor is held inside ``Socket.create`` until the first
request is in its handler.

``streaming/stream.py``: a stream writes only to the life of the socket it
was established on.  ``Socket`` objects are pooled: once a connection fails
and is recycled, its object serves the next socket created, a connection or
a new server's listener.  A stream kept the object, and a late frame (the
FEEDBACK its consumer sends after delivering a batch) went out on that next
life; on a listener the write failed and failed the socket, closing the new
server's listening fd (the carried
``tests/test_streaming_subsystem.py::test_oversized_single_frame_admitted_when_window_empty``
got "Connection refused" on all 4 connects to a server it had just started,
about one loaded run in 200, in both packages).  The port's stream keeps the
``SocketId`` of the life it is bound to and holds the object across each
write.  Here the object is recycled and reused on purpose.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.client import naming_service
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.combo import ShardRoutedChannel
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder, Percentile
from incubator_brpc_tpu_torch.metrics.reducer import Maxer, Miner
from incubator_brpc_tpu_torch.metrics.window import Window, _sampler_thread
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.server.service import rpc_method
from incubator_brpc_tpu_torch.transport.socket import Socket


def test_max_latency_sees_updates_after_a_tick():
    lr = LatencyRecorder()
    lr._max_window._sampler.take_sample()  # a tick before any update
    for us in range(1, 1001):
        lr.update(us)
    assert lr.max_latency() == 1000
    assert lr.count() == 1000


def test_extremum_window_combines_ticks_and_the_live_second():
    hi, lo = Maxer(), Miner()
    whi, wlo = Window(hi, 10), Window(lo, 10)
    for v in (5, 9):
        hi << v
        lo << v
    whi._sampler.take_sample()
    wlo._sampler.take_sample()
    # nothing recorded since the tick: the sampled extremum
    assert (whi.get_value(), wlo.get_value()) == (9, 5)
    # a lesser value under way leaves it alone, a greater one wins
    hi << 3
    lo << 7
    assert (whi.get_value(), wlo.get_value()) == (9, 5)
    hi << 12
    lo << 2
    assert (whi.get_value(), wlo.get_value()) == (12, 2)


def test_extremum_window_sees_the_live_second_across_a_tick(monkeypatch):
    from incubator_brpc_tpu_torch.metrics import window

    hi = Maxer()
    w = Window(hi, 10)
    w._sampler.take_sample()  # a tick before any update
    hi << 1000
    live_read = window.Reducer.get_value
    ticked = []

    def tick_then_read(var):
        if not ticked:  # the sampler's tick lands between the two reads
            ticked.append(True)
            w._sampler.take_sample()
        return live_read(var)

    monkeypatch.setattr(window.Reducer, "get_value", tick_then_read)
    assert w.get_value() == 1000 and ticked


def test_first_call_waits_for_the_naming_services_first_list(monkeypatch):
    run = naming_service.ListNamingService.run

    def late_run(self, url, watcher, stop_event):
        time.sleep(0.2)  # the naming thread is scheduled late
        return run(self, url, watcher, stop_event)

    monkeypatch.setattr(naming_service.ListNamingService, "run", late_run)
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_group="first-list"))
    try:
        assert ch.init(f"list://127.0.0.1:{srv.port}", "rr") == 0
        c = Controller()
        r = echo_stub(ch).Echo(c, EchoRequest(message="first"))
        assert not c.failed(), c.error_text()
        assert r.message == "first"
    finally:
        ch.close()
        srv.stop()


def test_a_failing_periodic_service_delivers_an_empty_first_list():
    class Failing(naming_service.PeriodicNamingService):
        name = "failing-first"
        interval_s = 60.0

        def get_servers(self, path):
            raise OSError("unreachable")

    class Watcher(naming_service.NamingServiceWatcher):
        def __init__(self):
            self.lists = []

        def on_servers_changed(self, nodes):
            self.lists.append(list(nodes))

    stop, w = threading.Event(), Watcher()
    t = threading.Thread(target=Failing().run, args=("failing-first://x", w, stop))
    t.start()
    try:
        deadline = time.monotonic() + 5
        while not w.lists and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.lists == [[]]
    finally:
        stop.set()
        t.join(5)
    assert not t.is_alive()


def test_shard_call_many_fallback_keeps_each_reply_attachment():
    """A ShardRoutedChannel over two ShardRoutedChannels, each over one PS
    server: the outer window degrades to per-call Gets (no ring surface
    below it), and each slot still carries the value as its attachment."""
    servers, inner = [], []
    for _ in range(2):
        srv = Server()
        srv.add_service(PsService(device=torch.device("cpu")))
        assert srv.start(0) == 0
        servers.append(srv)
        shard = ShardRoutedChannel()
        sub = Channel(ChannelOptions(timeout_ms=10000))
        assert sub.init(f"127.0.0.1:{srv.port}") == 0
        shard.set_partitions([sub])
        inner.append(shard)
    outer = ShardRoutedChannel()
    outer.set_partitions(inner)
    try:
        stub = ps_stub(outer)
        rng = np.random.RandomState(16)
        keys = [f"k{i}" for i in range(12)]
        assert {outer.shard_of(k, 2) for k in keys} == {0, 1}
        vals = {k: rng.randn(2, 4 + i).astype(np.float32).tobytes()
                for i, k in enumerate(keys)}
        for k in keys:
            c = Controller()
            c.request_attachment.append(vals[k])
            stub.Put(c, EchoRequest(message=k))
            assert not c.failed(), c.error_text()
        res = stub.call_many("Get", [EchoRequest(message=k) for k in keys])
        for k, r in zip(keys, res):
            assert type(r).__name__ == "RingReply", (k, type(r))
            assert r.attachment.to_bytes() == vals[k]
            c = Controller()
            per_call = stub.Get(c, EchoRequest(message=k))
            assert r.message == per_call.SerializeToString()
    finally:
        for srv in servers:
            srv.stop()


def _seeded_phase_recorders(lb, tag):
    """Three phase recorders of one method, fed the same seeded latencies
    (batched and direct writes), then folded into their window by one tick:
    later ticks of the 1 Hz sampler only add empty seconds, which change
    no value read here for the window's 10 s."""
    rng = np.random.RandomState(16)
    recs = []
    for phase in ("parse", "queue", "callback"):
        rec = lb.recorder(f"Repairs.{tag}", phase)
        for us in rng.lognormal(6, 1.5, 400).astype(np.int64):
            rec.update_batched(int(us))
        for us in rng.randint(1, 50000, 100):
            rec.update(int(us))
        for us in rng.lognormal(4, 1, 50).astype(np.int64):
            rec.update_batched(int(us))
        rec._psampler.take_sample()
        recs.append(rec)
    return recs


def test_metrics_page_folds_each_phase_recorder_once(monkeypatch):
    from incubator_brpc_tpu_torch.builtin import metrics_page
    from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
    from incubator_brpc_tpu_torch.observability import latency_breakdown as lb

    _seeded_phase_recorders(lb, "folds")
    me, folds = threading.current_thread(), {}
    flush = LatencyRecorder._flush_batches

    def counted(rec):
        if threading.current_thread() is me:  # not the 1 Hz sampler's ticks
            folds[id(rec)] = folds.get(id(rec), 0) + 1
        return flush(rec)

    monkeypatch.setattr(LatencyRecorder, "_flush_batches", counted)
    with lb._lock:
        recs = list(lb._recorders.values())
    status, body, _ = metrics_page(None, None)
    assert status == 200 and 'method="Repairs.folds"' in body
    assert {folds.get(id(r), 0) for r in recs} == {1}
    # the exported state (/cluster/export) folds each recorder once too
    folds.clear()
    assert "Repairs.folds" in lb.mergeable_snapshot()
    assert {folds.get(id(r), 0) for r in recs} == {1}


def test_phase_stats_print_the_reference_values_for_a_seeded_recorder():
    """The port's page lines, /latency_breakdown snapshot and exported
    state for three seeded recorders equal the JAX package's (whose reads
    the port's were, before stats())."""
    from incubator_brpc_tpu.builtin import metrics_page as jax_metrics_page
    from incubator_brpc_tpu.observability import latency_breakdown as jax_lb
    from incubator_brpc_tpu_torch.builtin import metrics_page
    from incubator_brpc_tpu_torch.observability import latency_breakdown as lb

    recs = _seeded_phase_recorders(lb, "values")
    jax_recs = _seeded_phase_recorders(jax_lb, "values")

    def lines(page):
        return sorted(l for l in page(None, None)[1].splitlines()
                      if 'method="Repairs.values"' in l)

    assert len(lines(metrics_page)) == 12
    assert lines(metrics_page) == lines(jax_metrics_page)
    assert lb.snapshot()["Repairs.values"] == jax_lb.snapshot()["Repairs.values"]

    def state(mod):  # qps is a rate over the sampler's ticks: it moves between reads
        return {phase: {k: v for k, v in snap.items() if k != "qps"}
                for phase, snap in mod.mergeable_snapshot()["Repairs.values"].items()}

    assert state(lb) == state(jax_lb)
    for rec in recs + jax_recs:
        assert rec.count() == 550
    for rec in recs:
        assert rec.stats((0.5, 0.9, 0.99)) == (
            rec.count(), rec.latency(),
            [rec.latency_percentile(r) for r in (0.5, 0.9, 0.99)])


def _unsampled(rec: LatencyRecorder) -> LatencyRecorder:
    """rec with its ticks left to the test: off the 1 Hz sampler thread."""
    _sampler_thread.remove(rec._psampler)
    return rec


class _TickOnEnter:
    """A lock that runs ``tick`` on another thread the first time the
    reader thread enters it, and lets it run for up to 0.2 s first (it
    finishes unless the reader holds a lock it needs)."""

    def __init__(self, lock, tick):
        self._lock, self._tick, self.ticks = lock, tick, []
        self._reader = threading.current_thread()

    def __enter__(self):
        if not self.ticks and threading.current_thread() is self._reader:
            self.ticks.append(_tick_meanwhile(self._tick))
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def _tick_meanwhile(tick) -> threading.Thread:
    t = threading.Thread(target=tick)
    t.start()
    t.join(0.2)
    return t


def test_a_tick_between_bucket_totals_reads_loses_no_sample():
    p = Percentile(10)
    for us in range(5):
        p.update(us)
    p.take_sample()  # five samples in the ring
    for us in range(100, 107):
        p.update(us)  # seven in the second under way
    assert sum(p.bucket_totals()) == 12
    hook = p._lock = _TickOnEnter(p._lock, p.take_sample)
    assert sum(p.bucket_totals()) == 12
    hook.ticks[0].join(5)
    assert len(p._ring) == 2 and sum(p.bucket_totals()) == 12


_RECORDER_READS = {
    "latency": lambda rec: rec.latency(),
    "stats": lambda rec: rec.stats((0.5, 0.99)),
    # qps is a rate over the ticks: it moves with a tick by design
    "mergeable_snapshot": lambda rec: {k: v for k, v in rec.mergeable_snapshot().items()
                                       if k != "qps"},
}


# with ticks in the window, latency() and stats() average the ticks' sums
# alone (in both packages), so only the state export reads the live sum then
@pytest.mark.parametrize("read, ticks_before", [
    ("latency", 0), ("stats", 0), ("mergeable_snapshot", 0), ("mergeable_snapshot", 3)])
def test_a_tick_between_a_recorders_window_reads_loses_no_sample(read, ticks_before):
    """The tick lands where the JAX package reads the live sum, after its
    read of the ticks' sums (and of the buckets): the value read is the
    window before the tick or after it, never a window without the live
    second."""
    rng = np.random.RandomState(17)
    rec = _unsampled(LatencyRecorder())
    for _ in range(ticks_before):
        for us in rng.randint(1, 5000, 5):
            rec.update(int(us))
        rec._psampler.take_sample()
    for us in rng.randint(1, 5000, 7):
        rec.update(int(us))
    reader = _RECORDER_READS[read]
    before = reader(rec)
    ticks = []

    def tick_then(orig):
        def hooked():
            if not ticks:
                ticks.append(_tick_meanwhile(rec._psampler.take_sample))
            return orig()
        return hooked

    live = rec._latency
    live.sum_num, live.get_value = tick_then(live.sum_num), tick_then(live.get_value)
    got = reader(rec)
    ticks[0].join(5)
    del live.sum_num, live.get_value
    after = reader(rec)
    assert got in (before, after), (got, before, after)
    snap = rec.mergeable_snapshot()
    assert sum(snap["buckets"].values()) == snap["latency_num"] == 5 * ticks_before + 7


def test_the_running_window_total_is_the_sum_of_the_ring():
    rng = np.random.RandomState(18)
    p = Percentile(4)
    for tick in range(15):  # evictions from the fifth tick on
        for us in rng.lognormal(5, 2, rng.randint(0, 40)).astype(np.int64):
            p.update(int(us))
        live = list(p._buckets)
        p.take_sample()
        assert len(p._ring) == min(tick + 1, 4)
        assert p._window == [sum(col) for col in zip(*p._ring)]
        assert p.bucket_totals() == p._window
        p.update(3)
        assert p.bucket_totals() == [w + (i == 3) for i, w in enumerate(p._window)]
        p._buckets[3] -= 1
        assert p._ring[-1] == live


@pytest.mark.parametrize("ticks_before", [0, 1])
def test_an_extremum_read_between_a_ticks_reset_and_append_sees_the_value(ticks_before):
    hi = Maxer()
    w = Window(hi, 10)
    _sampler_thread.remove(w._sampler)
    for _ in range(ticks_before):
        w._sampler.take_sample()
    hi << 1000
    reset, seen, readers = hi.reset, [], []

    def reset_then_read():
        v = reset()
        readers.append(threading.Thread(target=lambda: seen.append(w.get_value())))
        readers[0].start()
        readers[0].join(0.2)  # before the tick appends what it reset
        return v

    hi.reset = reset_then_read
    w._sampler.take_sample()
    readers[0].join(5)
    assert seen == [1000] and w.get_value() == 1000


def test_window_reads_beside_a_tick_loop_are_never_torn():
    """One thread writes and ticks a recorder for 2.5 s, four read its
    exported window.  Writes of values under 16 us land in the bucket of
    their value, so a whole window has as many bucket counts as writes
    and its latency sum is the counts weighted by their bucket.  The test's
    own locks keep writes out of a read (each reader holds its own, the
    writer all four), never ticks."""
    rec = _unsampled(LatencyRecorder(window_size=4))
    stop, torn, reads, ticks = threading.Event(), [], [0] * 4, [0]
    held = [threading.Lock() for _ in reads]

    def ticker():
        rng = np.random.RandomState(19)
        while not stop.is_set():
            for lock in held:
                lock.acquire()
            for us in rng.randint(0, 16, rng.randint(1, 9)):
                rec.update(int(us))
            for lock in held:
                lock.release()
            for _ in range(3):  # the later ticks evict a second apiece
                rec._psampler.take_sample()
                ticks[0] += 1

    def reader(k):
        while not stop.is_set():
            with held[k]:
                snap = rec.mergeable_snapshot()
            counts = {int(i): c for i, c in snap["buckets"].items()}
            reads[k] += 1
            time.sleep(1e-4)  # the writer takes the readers' locks meanwhile
            if (sum(counts.values()) != snap["latency_num"]
                    or sum(i * c for i, c in counts.items()) != snap["latency_sum"]):
                torn.append(snap)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # hand the GIL over between the reads
    threads = [threading.Thread(target=ticker)]
    threads += [threading.Thread(target=reader, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(2.5)
    finally:
        stop.set()
        for t in threads:
            t.join(10)
        sys.setswitchinterval(switch)
    assert min(reads) > 0 and ticks[0] > 100 and not torn, (reads, ticks, torn[:2])


def test_a_connection_counts_before_its_first_request_is_handled(monkeypatch):
    in_handler, counted = threading.Event(), []
    srv = Server()

    class Counting(EchoService):
        SERVICE_NAME = "EchoService"

        def native_fastpaths(self):
            return {}

        @rpc_method(EchoRequest, EchoResponse)
        def Echo(self, controller, request, response, done):
            counted.append(srv.connection_count())
            in_handler.set()
            response.message = request.message
            done()

    create = Socket.create.__func__

    def held_create(cls, options):
        sid = create(cls, options)
        if options.server is srv:
            in_handler.wait(5)  # the socket is live: its request is handled first
        return sid

    srv.add_service(Counting())
    assert srv.start(0) == 0
    monkeypatch.setattr(Socket, "create", classmethod(held_create))
    ch = Channel(ChannelOptions(timeout_ms=8000, connection_group="counted-early"))
    try:
        assert ch.init(f"127.0.0.1:{srv.port}") == 0
        c = Controller()
        assert echo_stub(ch).Echo(c, EchoRequest(message="early")).message == "early"
        assert not c.failed(), c.error_text()
        assert in_handler.is_set() and counted == [1]
        assert srv.connection_count() == 1
    finally:
        ch.close()
        srv.stop()


def test_a_stream_never_writes_to_the_next_life_of_its_socket():
    import socket as pysocket

    from incubator_brpc_tpu_torch import errors
    from incubator_brpc_tpu_torch.protocols import streaming as wire
    from incubator_brpc_tpu_torch.streaming.stream import Stream
    from incubator_brpc_tpu_torch.transport.socket import SocketOptions
    from incubator_brpc_tpu_torch.utils.endpoint import EndPoint
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    def make():
        a, b = pysocket.socketpair()
        sid = Socket.create(SocketOptions(fd=a, remote=EndPoint.tcp("127.0.0.1", 1)))
        return sid, Socket.address(sid), b

    sid, old, old_peer = make()
    stream = Stream.create(Controller(), None)
    stream.establish(old, 7)
    old.set_failed(errors.EFAILEDSOCKET, "peer gone")
    old.recycle()
    made = []
    try:
        for _ in range(16):  # the pool hands the freed object out again
            made.append(make())
            if made[-1][1] is old:
                break
        new_sid, new, new_peer = made[-1]
        assert new is old and new_sid != sid and not new.failed
        # a late FEEDBACK of the stream: refused, and the new life untouched
        rc = stream._send_raw(wire.FRAME_FEEDBACK, IOBuf((64).to_bytes(8, "big")))
        assert rc == errors.EFAILEDSOCKET
        assert not new.failed
        new_peer.setblocking(False)
        try:
            got = new_peer.recv(64)
        except BlockingIOError:
            got = b""
        assert got == b""
    finally:
        stream.close()
        for s_id, sock, peer in made:
            sock.set_failed(errors.EFAILEDSOCKET, "test over")
            sock.recycle()
            peer.close()
        old_peer.close()
