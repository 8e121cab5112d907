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
holds one.  Here the tick is forced, so the case is deterministic.

``client/naming_service.py``, ``client/lb_with_naming.py``: a channel on a
naming-service URL waits for the service's first server list, as the
reference does (``WaitForFirstBatchOfServers``).  In the JAX package
``Channel.init`` returns before the naming thread ran, so a first call made
at once can find no server ("failed to select/connect server"; the carried
``tests/test_overload_storm.py::test_cancel_frame_with_unknown_cid_is_ignored``
failed so under load).  Here the naming thread is made late on purpose.
"""

import threading
import time

from incubator_brpc_tpu_torch.client import naming_service
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from incubator_brpc_tpu_torch.metrics.reducer import Maxer, Miner
from incubator_brpc_tpu_torch.metrics.window import Window
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server


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
