"""The port's call phases: the stamps an ICI leg and a batched server row
add to their rpcz spans, the queue's split into the micro-batcher's wait
and the dispatch, the micro-batcher's wait counter, the runtime's handoff
total, the variables that show both, and the shared clock of spans and a
``torch.profiler`` trace.  All on the CPU device."""

import threading
import time

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch.batching.batcher import Batcher, _Row
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.metrics.variable import describe_exposed
from incubator_brpc_tpu_torch.observability import latency_breakdown
from incubator_brpc_tpu_torch.observability.span import (
    PHASE_DELTAS,
    PHASE_FIELDS,
    Span,
    span_db,
)
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.runtime import scheduler
from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue
from incubator_brpc_tpu_torch.runtime.timer_thread import get_timer_thread
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions
from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag

CPU = torch.device("cpu")
ECHO_CHIP = 41
PS_CHIP = 42


@pytest.fixture
def rpcz_every_call():
    prev = (get_flag("rpcz_enabled"), get_flag("rpcz_max_spans_per_second"))
    set_flag("rpcz_enabled", True)
    set_flag("rpcz_max_spans_per_second", 1_000_000)
    yield
    set_flag("rpcz_enabled", prev[0])
    set_flag("rpcz_max_spans_per_second", prev[1])


def _wait_spans(trace_ids, kinds, timeout_s=8.0):
    """The collected spans of ``trace_ids`` once each kind is there."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = [s for s in span_db().recent(2048) if s.trace_id in trace_ids]
        by_kind = {k: [s for s in got if s.kind == k] for k in kinds}
        if all(len(v) >= n for v, n in zip(by_kind.values(), kinds.values())) \
                or time.monotonic() > deadline:
            return by_kind
        time.sleep(0.05)


# each kind's stamps in the order a call reaches them (start_us and end_us
# are the span's own; a client span's received_us is the reply's arrival)
ORDER = {
    "client": ("start_us", "response_write_us", "received_us", "end_us"),
    "collective": ("start_us", "placed_us", "end_us"),
    "server": ("received_us", "parse_done_us", "enqueued_us", "batch_flush_us",
               "callback_start_us", "callback_done_us", "response_write_us", "sent_us"),
}


def _stamps(span):
    """The span's set stamps, in call order."""
    return [(f, span.phase(f)) for f in ORDER[span.kind] if span.phase(f)]


def _in_order(span):
    """Each stamp at or after the one before it; a device window lies
    inside the callback."""
    values = [v for _, v in _stamps(span)]
    inside = not span.phase("device_start_us") or (
        span.callback_start_us <= span.device_start_us <= span.device_done_us
        <= span.callback_done_us)
    return inside and values == sorted(values)


@pytest.fixture
def echo_channel():
    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService())
    assert srv.start_ici(0, ECHO_CHIP, device=CPU) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, ici_device=CPU))
    assert ch.init(f"ici://slice0/chip{ECHO_CHIP}") == 0
    yield echo_stub(ch)
    ch.close()
    srv.stop()


def _echo(stub):
    c = Controller()
    c.request_attachment.append_device(torch.arange(1024, dtype=torch.float32))
    stub.Echo(c, EchoRequest(message="phases"))
    assert not c.failed(), c.error_text()
    return c


def test_echo_spans_carry_every_phase_in_order(rpcz_every_call, echo_channel):
    tids = {_echo(echo_channel)._span.trace_id for _ in range(4)}
    spans = _wait_spans(tids, {"client": 4, "server": 4, "collective": 8})
    assert len(spans["client"]) == 4 and len(spans["server"]) == 4
    for s in spans["client"]:
        assert [f for f, _ in _stamps(s)] == list(ORDER["client"])
        assert _in_order(s)
    for s in spans["collective"]:
        assert [f for f, _ in _stamps(s)] == list(ORDER["collective"])
        assert _in_order(s)
    for s in spans["server"]:
        # unbatched: no flush stamp, the dispatch is the whole queue phase
        assert s.phase("batch_flush_us") == 0
        assert _in_order(s)
        deltas = dict(s.phase_deltas())
        assert "batch_wait" not in deltas
        assert {"parse", "dispatch", "callback", "write", "send"} <= set(deltas)
        assert deltas["dispatch"] == deltas["queue"]
    # a request leg hangs under the client span, the reply leg under the server's
    client_ids = {s.span_id for s in spans["client"]}
    server_ids = {s.span_id for s in spans["server"]}
    parents = [s.parent_span_id for s in spans["collective"]]
    assert sum(p in client_ids for p in parents) == 4
    assert sum(p in server_ids for p in parents) == 4


@pytest.fixture
def ps_channel():
    svc = PsService(device=CPU)
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start_ici(0, PS_CHIP, device=CPU) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000, ici_device=CPU))
    assert ch.init(f"ici://slice0/chip{PS_CHIP}") == 0
    w = torch.from_numpy(np.random.RandomState(5).rand(64, 64).astype(np.float32))
    c = Controller()
    c.request_attachment.append_device(w)
    ps_stub(ch).Put(c, EchoRequest(message="w"))
    assert not c.failed(), c.error_text()
    yield ps_stub(ch), srv.batcher("PsService.Forward")
    ch.close()
    srv.stop()


def _forward(stub):
    c = Controller()
    c.request_attachment.append_user_data(np.ones(64, np.float32).tobytes())
    stub.Forward(c, EchoRequest(message="w"))
    assert not c.failed(), c.error_text()
    return c


def test_batched_forward_spans_split_the_queue_at_the_flush(rpcz_every_call, ps_channel):
    stub, batcher = ps_channel
    tids = {_forward(stub)._span.trace_id for _ in range(3)}
    spans = _wait_spans(tids, {"client": 3, "server": 3, "collective": 3})
    for s in spans["server"]:
        assert s.enqueued_us <= s.batch_flush_us <= s.callback_start_us
        assert _in_order(s)
        deltas = dict(s.phase_deltas())
        assert [p for p, _ in s.phase_deltas()][:4] == ["parse", "batch_wait", "queue", "dispatch"]
        assert deltas["batch_wait"] + deltas["dispatch"] == deltas["queue"]
        # a lone row waits out the flush timer (max_wait_us) in the batcher
        assert deltas["batch_wait"] >= batcher.policy.max_wait_us * 0.9
    for s in spans["client"]:
        assert [f for f, _ in _stamps(s)] == list(ORDER["client"])
    assert all(s.placed_us for s in spans["collective"])
    snap = latency_breakdown.snapshot().get("PsService.Forward", {})
    assert {"batch_wait", "dispatch"} <= set(snap)
    # /latency_breakdown lists the split right after the queue it splits
    block = next(b for b in latency_breakdown.render().split("\n\n")
                 if b.startswith("PsService.Forward:"))
    rows = [ln.split()[0] for ln in block.splitlines()[1:]]
    assert rows.index("queue") + 1 == rows.index("batch_wait") == rows.index("dispatch") - 1


def test_calls_without_rpcz_carry_no_span_and_no_stamp(echo_channel, ps_channel):
    prev = get_flag("rpcz_enabled")
    set_flag("rpcz_enabled", False)
    try:
        made = []
        orig = Span.__init__

        def counting_init(self, *a, **k):
            made.append(a[0] if a else k.get("kind"))
            orig(self, *a, **k)

        Span.__init__ = counting_init
        try:
            controllers = [_echo(echo_channel), _forward(ps_channel[0])]
        finally:
            Span.__init__ = orig
        assert made == []
        assert all(c._span is None for c in controllers)
    finally:
        set_flag("rpcz_enabled", prev)


class _Rows:
    def __init__(self):
        self.batches = []

    def __call__(self, controllers, requests, responses, done):
        self.batches.append(len(controllers))
        done()


def _row(enqueue_ns, span=True):
    ctrl = Controller()
    if span:
        ctrl._span = Span("server", "T", "M")
    return _Row(ctrl, "req", "resp", lambda: None, enqueue_ns, 0)


def test_batcher_wait_is_the_rows_own_flush_minus_enqueue():
    b = Batcher("T.Wait", _Rows(), BatchPolicy(max_batch_size=4, max_wait_us=50_000), inline=True)
    try:
        taken = time.monotonic_ns()
        rows = [_row(taken - d) for d in (3_000, 250_000, 1_000_000)]
        b._flush(rows, taken)
        assert b.wait_ns == 3_000 + 250_000 + 1_000_000
        assert b.describe()["wait_ns"] == b.wait_ns
        for r in rows:  # the flush stamp: the wall clock of the take
            s = r.controller._span
            assert 0 <= s.callback_start_us - s.batch_flush_us < 1_000_000
        more = [_row(taken + 10_000), _row(taken + 20_000, span=False)]
        b._flush(more, taken + 50_000)
        assert b.wait_ns == 1_253_000 + 40_000 + 30_000
        assert b.rows == 5
    finally:
        b.stop()


def test_batcher_wait_counts_the_timer_and_only_live_rows():
    handler = _Rows()
    b = Batcher("T.Timer", handler, BatchPolicy(max_batch_size=8, max_wait_us=20_000), inline=True)
    try:
        before = time.monotonic_ns()
        for _ in range(2):
            ctrl = Controller()
            assert b.submit(ctrl, "req", "resp", lambda: None)
        deadline = time.monotonic() + 5
        while not handler.batches and time.monotonic() < deadline:
            time.sleep(0.005)
        after = time.monotonic_ns()
        assert handler.batches == [2]
        # each row waited the timer out, and no longer than the whole test
        assert 2 * 20_000_000 * 0.9 <= b.wait_ns <= 2 * (after - before)
    finally:
        b.stop()


def test_handoffs_count_spawned_tasks_and_timers_not_inline_runs():
    scheduler.spawn(lambda: None).join(5)  # the workers exist
    time.sleep(0.2)
    h0 = scheduler.handoffs_total()
    tasks = [scheduler.spawn(lambda: None) for _ in range(5)]
    assert all(t.join(5) for t in tasks)
    fired = threading.Event()
    get_timer_thread().schedule(fired.set, 0.001)
    assert fired.wait(5)
    ran = []
    q = ExecutionQueue(lambda batch: ran.extend(batch))
    assert q.execute_or_inline("in place")
    h1 = scheduler.handoffs_total()
    assert ran == ["in place"]
    # background timers of other parts may fire meanwhile: at least the
    # five tasks and the timer, and never the inline run
    assert h1 - h0 >= 6
    h2 = scheduler.handoffs_total()
    for _ in range(50):
        assert q.execute_or_inline("again")
    assert scheduler.handoffs_total() - h2 < 50


def test_batcher_wait_shows_as_a_variable_until_the_batcher_stops():
    b = Batcher("T.Shown", _Rows(), BatchPolicy(max_batch_size=4, max_wait_us=50_000), inline=True)
    name = "rpc_batch_wait_ns_t_shown"
    try:
        taken = time.monotonic_ns()
        b._flush([_row(taken - 7_000), _row(taken - 5_000)], taken)
        assert describe_exposed(name) == "12000"
    finally:
        b.stop()
    assert describe_exposed(name) is None


def test_handoffs_show_as_a_runtime_variable():
    scheduler.spawn(lambda: None).join(5)
    assert int(describe_exposed("runtime_handoffs")) <= scheduler.handoffs_total()
    before = scheduler.handoffs_total()
    assert all(t.join(5) for t in [scheduler.spawn(lambda: None) for _ in range(3)])
    assert int(describe_exposed("runtime_handoffs")) >= before + 3


def test_new_stamps_are_phase_fields_and_split_the_queue():
    fields = set(PHASE_FIELDS)
    assert {"placed_us", "batch_flush_us"} <= fields
    for name, frm, to in PHASE_DELTAS:
        for f in (frm if isinstance(frm, tuple) else (frm,)) + (to,):
            assert f in fields, (name, f)
    assert [p for p, _, _ in PHASE_DELTAS][:4] == ["parse", "batch_wait", "queue", "dispatch"]
    # a stamp a span never reached reads 0, and no phase is made of it
    s = Span("server", "T", "M")
    s.enqueued_us, s.callback_start_us = 100, 130
    assert s.phase("batch_flush_us") == 0
    assert dict(s.phase_deltas()) == {"queue": 30, "dispatch": 30}
    s.batch_flush_us = 120
    assert dict(s.phase_deltas()) == {"queue": 30, "batch_wait": 20, "dispatch": 10}


def test_record_function_range_and_wall_stamps_share_a_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    stamps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for k in range(20):
            with record_function(f"anchor.{k}"):
                stamps.append(time.time_ns())
    ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("anchor.")}
    assert len(ranges) == 20
    for k, wall in enumerate(stamps):
        lo, hi = ranges[f"anchor.{k}"]
        assert lo - 200_000 <= wall <= hi + 200_000, (k, wall - lo, hi - lo)
