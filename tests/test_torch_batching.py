"""The port's micro-batched parameter server held against the JAX
package's, plus the scenarios of tests/test_batching.py (all but the
/batching builtin page, which waits for the port's builtin pages),
tests/test_ici.py's PS over ICI and tests/test_profiling.py's device
phase rerun against ``incubator_brpc_tpu_torch``.

Everything runs on the CPU: the port's ``PsService`` and ICI ports are
given ``torch.device("cpu")``.  The port's registries (metrics, chaos
injector, span database, flags) are its own: these tests arm and read
the port's.  Every server is stopped in ``finally`` so no batcher timer
or scheduler work leaks into the next test of the worker.

Tolerances: Forward rows against the JAX package within
|Δ| <= 1e-5 * (|x| @ |W|) + 1e-6 elementwise (float32 products summed
in another order); stacks and merges of integer-valued float32 inputs
are exact, so equal.
"""

import threading
import time

import numpy as np
import pytest
import torch

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.batching.batcher import Batcher
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

CPU = torch.device("cpu")
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6

_coords_counter = [700]


def fresh_coords():
    _coords_counter[0] += 1
    return (13, _coords_counter[0])


def make_channel(port, **opts):
    opts.setdefault("timeout_ms", 5000)
    ch = Channel(ChannelOptions(**opts))
    assert ch.init(f"127.0.0.1:{port}") == 0
    return ch


def ps():
    return PsService(device=CPU)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def test_policy_buckets_and_validation():
    p = BatchPolicy(max_batch_size=8, padding_buckets=(1, 2, 4, 8))
    assert p.enabled
    assert p.bucket_for(1) == 1
    assert p.bucket_for(3) == 4
    assert p.bucket_for(8) == 8
    assert BatchPolicy(max_batch_size=1).enabled is False
    assert BatchPolicy(max_batch_size=0).enabled is False
    assert BatchPolicy(max_batch_size=4).bucket_for(3) == 3
    with pytest.raises(ValueError):
        BatchPolicy(padding_buckets=(4, 2))
    with pytest.raises(ValueError):
        BatchPolicy(padding_buckets=(0, 2))
    with pytest.raises(ValueError):
        BatchPolicy(max_batch_size=32, padding_buckets=(1, 2, 4))
    with pytest.raises(ValueError):
        BatchPolicy(max_wait_us=-1)
    with pytest.raises(ValueError):
        BatchPolicy.from_dict({"max_batch_sized": 3})
    rt = BatchPolicy.from_dict(p.to_dict())
    assert rt.to_dict() == p.to_dict()


def test_off_policy_builds_no_batcher():
    srv = Server(ServerOptions(enable_batching=True,
                               batch_policies={"PsService.Get": None}))
    srv.add_service(ps())
    assert srv.start(0) == 0
    try:
        assert srv.batcher("PsService.Get") is None
        assert srv.batcher("PsService.Put") is not None
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# dispatch paths over real TCP
# ---------------------------------------------------------------------------


def test_single_request_fallback_without_batching():
    srv = Server()
    srv.add_service(ps())
    assert srv.start(0) == 0
    try:
        assert not srv._batchers
        stub = ps_stub(make_channel(srv.port))
        c = Controller()
        c.request_attachment.append(b"payload")
        stub.Put(c, EchoRequest(message="k"))
        assert not c.failed(), c.error_text()
        c2 = Controller()
        stub.Get(c2, EchoRequest(message="k"))
        assert not c2.failed(), c2.error_text()
        assert c2.response_attachment.to_bytes() == b"payload"
        c3 = Controller()
        stub.Get(c3, EchoRequest(message="missing"))
        assert c3.failed() and c3.error_code == errors.EREQUEST
    finally:
        srv.stop()


def test_batched_execution_counts_requests_not_batches():
    srv = Server(ServerOptions(
        enable_batching=True,
        batch_policies={
            # generous wait so a thread barrier reliably coalesces
            "PsService.Get": BatchPolicy(
                max_batch_size=8, max_wait_us=100_000,
                padding_buckets=(1, 2, 4, 8),
            ),
        },
    ))
    svc = ps()
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc._store["k"] = b"v"
    nthreads, per_thread = 8, 2
    total = nthreads * per_thread
    results = []
    lock = threading.Lock()
    barrier = threading.Barrier(nthreads, timeout=20)
    try:
        def worker(i):
            ch = make_channel(srv.port)
            stub = ps_stub(ch)
            barrier.wait()
            mine = []
            for j in range(per_thread):
                c = Controller()
                key = "k" if (i + j) % 2 == 0 else "nope"
                stub.Get(c, EchoRequest(message=key))
                mine.append((key, c.error_code))
            ch.close()
            with lock:
                results.extend(mine)

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(nthreads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert len(results) == total
        for key, code in results:
            if key == "k":
                assert code == 0, f"hit failed with {code}"
            else:
                assert code == errors.EREQUEST, f"miss returned {code}"
        batcher = srv.batcher("PsService.Get")
        assert batcher.rows == total
        assert batcher.batches < total, "nothing coalesced"
        assert batcher.max_batch_seen >= 2, "batcher silently disabled"
        status = srv.method_status("PsService.Get")
        hits = sum(1 for k, c in results if c == 0)
        assert status.latency_rec.count() == hits
        assert status.errors.get_value() == total - hits
        from incubator_brpc_tpu_torch.metrics.variable import _registry

        size_var = _registry.get("rpc_batch_size_psservice_get")
        occ_var = _registry.get("rpc_batch_occupancy_psservice_get")
        assert size_var is not None and occ_var is not None
        s, n = size_var.sum_num()
        assert n == batcher.batches and s == batcher.rows
        assert 0.0 < occ_var.get_value() <= 1.0
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# deadline guard
# ---------------------------------------------------------------------------


class _RecordingHandler:
    def __init__(self):
        self.batches = []

    def __call__(self, controllers, requests, responses, done):
        self.batches.append(list(controllers))
        done()


def _row(deadline_ns=0):
    from incubator_brpc_tpu_torch.observability.span import Span

    ctrl = Controller()
    if deadline_ns:
        ctrl._batch_deadline_ns = deadline_ns
    ctrl._span = Span("server", "T", "M")
    calls = []
    return ctrl, calls, (lambda: calls.append(1))


def test_mixed_batch_sheds_expired_row_and_executes_survivors():
    from incubator_brpc_tpu_torch.batching.batcher import _Row

    handler = _RecordingHandler()
    b = Batcher("T.M", handler,
                BatchPolicy(max_batch_size=2, max_wait_us=50_000), inline=True)
    try:
        now = time.monotonic_ns()
        dead_ctrl, dead_calls, dead_done = _row()
        live_ctrl, live_calls, live_done = _row()
        b._flush([
            _Row(dead_ctrl, "r1", "s1", dead_done, now - 5_000_000,
                 now - 1_000_000),
            _Row(live_ctrl, "r2", "s2", live_done, now, 0),
        ])
        assert handler.batches == [[live_ctrl]]
        assert live_calls == [1] and not live_ctrl.failed()
        assert dead_calls == [1]
        assert dead_ctrl.error_code == errors.ELIMIT
        assert "batch_shed" in dead_ctrl._span.describe()
        assert b.shed.get_value() == 1
        assert b.rows == 1 and b.batches == 1
    finally:
        b.stop()


def test_row_already_past_deadline_at_submit_never_reaches_user_code():
    handler = _RecordingHandler()
    b = Batcher("T.M", handler,
                BatchPolicy(max_batch_size=8, max_wait_us=1_000_000), inline=True)
    try:
        dead_ctrl, dead_calls, dead_done = _row(
            deadline_ns=time.monotonic_ns() - 1_000_000
        )
        assert b.submit(dead_ctrl, "r1", "s1", dead_done)
        assert dead_calls == [1]
        assert dead_ctrl.error_code == errors.ELIMIT
        assert handler.batches == [], "user code ran for an expired row"
        assert b.pending() == 0
    finally:
        b.stop()


def test_deadline_guard_flushes_before_budget_exhausted():
    handler = _RecordingHandler()
    done_ev = threading.Event()
    b = Batcher("T.M", handler, BatchPolicy(
        max_batch_size=8, max_wait_us=2_000_000, deadline_us=100_000,
        expected_service_us=20_000,
    ))
    try:
        ctrl = Controller()
        t0 = time.monotonic()
        assert b.submit(ctrl, "r", "s", done_ev.set)
        assert done_ev.wait(1.5), "flush never fired"
        elapsed = time.monotonic() - t0
        assert elapsed < 0.5, f"flush waited {elapsed:.2f}s (deadline guard dead)"
        assert handler.batches and handler.batches[0][0] is ctrl
        assert not ctrl.failed(), "row shed instead of executed"
    finally:
        b.stop()


def test_deadline_shed_over_tcp_closes_span():
    from incubator_brpc_tpu_torch.chaos.harness import wait_until
    from incubator_brpc_tpu_torch.observability.span import span_db
    from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag

    prev = get_flag("rpcz_enabled", True)
    set_flag("rpcz_enabled", True)
    srv = Server(ServerOptions(
        enable_batching=True,
        batch_policies={
            "PsService.Get": BatchPolicy(
                max_batch_size=8, max_wait_us=30_000, deadline_us=1,
            ),
        },
    ))
    svc = ps()
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc._store["k"] = b"v"
    try:
        stub = ps_stub(make_channel(srv.port))
        c = Controller()
        stub.Get(c, EchoRequest(message="k"))
        assert c.failed() and c.error_code == errors.ELIMIT, c.error_text()
        assert srv.batcher("PsService.Get").shed.get_value() >= 1
        assert wait_until(
            lambda: any(
                s.kind == "server" and "batch_shed" in s.describe()
                for s in span_db().recent(200)
            ),
            timeout_s=3.0,
        ), "no server span with the shed stamp reached the SpanDB"
    finally:
        srv.stop()
        set_flag("rpcz_enabled", prev)


def test_queue_cap_sheds_overflow_instead_of_growing_unbounded():
    release = threading.Event()

    def blocking_handler(controllers, requests, responses, done):
        release.wait(10)
        done()

    b = Batcher("T.M", blocking_handler, BatchPolicy(
        max_batch_size=2, max_wait_us=1_000_000, max_queue_rows=4,
    ))
    try:
        rows = [_row() for _ in range(8)]
        for ctrl, _, done in rows:
            assert b.submit(ctrl, "r", "s", done)
        time.sleep(0.3)  # first window (2 rows) is now in flight, blocked
        assert b.pending() == 4, b.pending()
        shed = [r for r in rows if r[0].failed()]
        assert len(shed) == 2
        for ctrl, calls, _ in shed:
            assert ctrl.error_code == errors.EOVERCROWDED
            assert calls == [1], "shed row completed more than once"
            assert "batch_shed" in ctrl._span.describe()
        assert b.shed.get_value() == 2
        release.set()
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(calls == [1] for _, calls, _ in rows):
                break
            time.sleep(0.01)
        assert all(calls == [1] for _, calls, _ in rows)
        assert not any(r[0].failed() for r in rows if r not in shed)
    finally:
        release.set()
        b.stop()


# ---------------------------------------------------------------------------
# padding buckets bound the traces
# ---------------------------------------------------------------------------


def test_padding_buckets_bound_jit_retraces():
    from incubator_brpc_tpu_torch.batching import fused
    from incubator_brpc_tpu_torch.parallel.ici import StagingRing

    policy = BatchPolicy(max_batch_size=8, padding_buckets=(1, 2, 4, 8))
    ring = StagingRing(depth=8, max_keys=4)
    row = torch.arange(16, dtype=torch.float32) + 0.5  # a shape no other test stacks
    before = fused.trace_count()
    for n in range(1, 9):
        outs = fused.fused_stack_rows([row] * n, policy.bucket_for(n), freelist=ring)
        assert len(outs) == n
        for o in outs:
            assert o.shape == row.shape and torch.equal(o, row)
    retraces = fused.trace_count() - before
    assert retraces <= len(policy.padding_buckets), (
        f"{retraces} retraces for 8 batch sizes; buckets must bound it "
        f"at {len(policy.padding_buckets)}"
    )
    total_slots = sum(len(q) for q in ring._slots.values())
    assert total_slots <= ring.depth


def test_forward_kernel_traces_once_per_bucket_and_reports_families():
    from incubator_brpc_tpu_torch.analysis import device_witness
    from incubator_brpc_tpu_torch.batching.fused import FusedKernel

    k = FusedKernel(lambda w, x: x @ w, label="test.fwd", batch_buckets=(1, 2, 4))
    w = torch.ones((8, 8))
    for n in (1, 2, 3, 4, 1, 2, 4):
        k(w, torch.ones((BatchPolicy(max_batch_size=4, padding_buckets=(1, 2, 4))
                         .bucket_for(n), 8)))
    assert k.trace_count() == 3
    assert not [c for c in device_witness.retrace_contradictions()
                if c["kernel"] == "test.fwd"]
    for b in (8, 16):  # two shapes past the bound: a contradiction
        k(w, torch.ones((b, 8)))
    bad = [c for c in device_witness.retrace_contradictions()
           if c["kernel"] == "test.fwd"]
    assert len(bad) == 1 and bad[0]["count"] == 5 and bad[0]["bound"] == 3


# ---------------------------------------------------------------------------
# chaos: batch.flush
# ---------------------------------------------------------------------------


def _flush_n_times(batcher, n):
    for _ in range(n):
        c1, _, d1 = _row()
        c2, _, d2 = _row()
        batcher.submit(c1, "a", "x", d1)
        batcher.submit(c2, "b", "y", d2)


def test_chaos_batch_flush_replay_fires_identical_traversals():
    from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec
    from incubator_brpc_tpu_torch.chaos import injector

    plan = FaultPlan(
        [FaultSpec(site="batch.flush", action="delay_us", arg=1, every_nth=3)],
        seed=42, name="flush-replay",
    )
    handler = _RecordingHandler()

    def one_run():
        b = Batcher("T.M", handler,
                    BatchPolicy(max_batch_size=2, max_wait_us=100_000),
                    inline=True)
        injector.arm(plan)
        try:
            _flush_n_times(b, 9)
            return injector.hit_log()
        finally:
            injector.disarm()
            b.stop()

    log1 = one_run()
    log2 = one_run()
    assert log1 == log2, "replay diverged"
    assert [n for (_, _, n) in log1] == [2, 5, 8]
    assert all(site == "batch.flush" for (site, _, _) in log1)


def test_chaos_flush_drop_sheds_cleanly_under_recovery_harness():
    from incubator_brpc_tpu_torch.chaos import FaultPlan, FaultSpec, RecoveryHarness

    srv = Server(ServerOptions(
        enable_batching=True,
        batch_policies={
            "PsService.Get": BatchPolicy(
                max_batch_size=4, max_wait_us=20_000, padding_buckets=(1, 2, 4),
            ),
        },
    ))
    svc = ps()
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc._store["k"] = b"v"
    batcher = srv.batcher("PsService.Get")
    plan = FaultPlan(
        [FaultSpec(site="batch.flush", action="drop", every_nth=2,
                   max_hits=2, match={"method": "PsService.Get"})],
        seed=7, name="flush-drop",
    )

    def freelist_slots():
        return sum(len(q) for q in batcher.pad_freelist._slots.values())

    harness = RecoveryHarness(
        plan,
        wall_clock_s=20.0,
        baseline_probes=[
            ("batch_queue_depth", batcher.pending),
            ("pad_freelist_slots", freelist_slots),
        ],
    )
    total = [0]

    def workload(h):
        lock = threading.Lock()

        def worker():
            ch = make_channel(srv.port)
            stub = ps_stub(ch)
            for _ in range(4):
                c = Controller()
                stub.Get(c, EchoRequest(message="k"))
                h.record_error(c.error_code)
                with lock:
                    total[0] += 1
            ch.close()

        ts = [threading.Thread(target=worker) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    try:
        report = harness.run_or_raise(workload)
        assert len(report.error_codes) == total[0] == 16
        dropped = [c for c in report.error_codes if c != 0]
        hits = report.hits.get("batch.flush", {}).get("drop", 0)
        assert hits >= 1, "the drop never fired"
        assert dropped, "a dropped flush produced no shed completions"
        assert all(c == errors.EOVERCROWDED for c in dropped), dropped
        assert batcher.shed.get_value() == len(dropped)
    finally:
        srv.stop()


def test_disable_method_batching_restores_direct_path():
    srv = Server(ServerOptions(enable_batching=True))
    svc = ps()
    srv.add_service(svc)
    assert srv.start(0) == 0
    svc._store["k"] = b"v"
    try:
        assert srv.batcher("PsService.Get") is not None
        srv.disable_method_batching("PsService.Get")
        assert srv.batcher("PsService.Get") is None
        stub = ps_stub(make_channel(srv.port))
        c = Controller()
        stub.Get(c, EchoRequest(message="k"))
        assert not c.failed(), c.error_text()
        assert c.response_attachment.to_bytes() == b"v"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the parameter server over ICI (tests/test_ici.py) at the 151 MB W's ratio
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batching", [False, True])
def test_parameter_server_over_ici(batching):
    """Put and Get of a device W over ici://.  (768, 768) float32 rows
    are 3 KB, so 1 MB chunks hold 341.3 rows: the ratio of the chip
    run's (6144, 6144) W at 8 MB chunks.  The fused transmit must cover
    every row, and the Get response carries the whole-frame checksum."""
    from incubator_brpc_tpu_torch.ops import transfer as TT
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric

    fab = get_fabric()
    saved = (fab.chunk_mode, fab.chunk_bytes)
    fab.chunk_mode, fab.chunk_bytes = "fused", 1 << 20
    srv = Server(ServerOptions(enable_batching=batching))
    svc = ps()
    srv.add_service(svc)
    s, c = fresh_coords()
    assert srv.start_ici(s, c, device=CPU) == 0
    try:
        assert (srv.batcher("PsService.Put") is not None) == batching
        ch = Channel(ChannelOptions(timeout_ms=30000, ici_device=CPU))
        assert ch.init(f"ici://slice{s}/chip{c}") == 0
        stub = ps_stub(ch)
        w = torch.from_numpy(np.random.RandomState(4).randn(768, 768).astype(np.float32))
        ctrl = Controller()
        ctrl.request_attachment.append_device(w)
        stub.Put(ctrl, EchoRequest(message="layer0/w"))
        assert not ctrl.failed(), ctrl.error_text()
        stored = svc._store["layer0/w"]
        assert stored.data_ptr() != w.data_ptr() and torch.equal(stored, w)

        ctrl2 = Controller()
        stub.Get(ctrl2, EchoRequest(message="layer0/w"))
        assert not ctrl2.failed(), ctrl2.error_text()
        segs = ctrl2.response_attachment.device_segments()
        assert len(segs) == 1
        got = segs[0].array
        assert got.shape == (768, 768) and torch.equal(got, w)
        assert got.data_ptr() not in (w.data_ptr(), stored.data_ptr())
        assert torch.equal(segs[0].csum, TT.device_copy_with_checksum(w)[1])

        ctrl3 = Controller()
        stub.Get(ctrl3, EchoRequest(message="missing"))
        assert ctrl3.failed() and ctrl3.error_code == errors.EREQUEST
    finally:
        srv.stop()
        fab.chunk_mode, fab.chunk_bytes = saved


def test_chunk_plan_covers_the_full_width_w():
    """The chip run's W: (6144, 6144) float32 at 8 MB chunks — 341.3
    rows a chunk.  The plan must cover every row, as the JAX package's."""
    from incubator_brpc_tpu.utils.segmentation import plan_row_chunks
    from incubator_brpc_tpu_torch.ops import transfer as TT

    w = torch.empty((6144, 6144), dtype=torch.float32, device="meta")
    v, br, chunks = TT.chunk_plan_for(w, 8 << 20)
    assert v is w and br == 256
    assert list(chunks) == list(plan_row_chunks(6144, 6144 * 4, 8 << 20, 256))
    assert chunks[0][0] == 0 and sum(r for _, r in chunks) == 6144
    assert all(off % br == 0 for off, _ in chunks)
    assert all(a + ra == b for (a, ra), (b, _) in zip(chunks, chunks[1:]))


# ---------------------------------------------------------------------------
# Forward: parity with the JAX package, the device phase, validation
# ---------------------------------------------------------------------------


def _concurrent_forwards(port, xs):
    """Send each x as a concurrent Forward (a barrier lines them up);
    returns the y rows in order."""
    out = [None] * len(xs)
    errs = []
    barrier = threading.Barrier(len(xs), timeout=20)

    def worker(i):
        from incubator_brpc_tpu_torch.client.controller import Controller as C

        ch = make_channel(port)
        stub = ps_stub(ch)
        barrier.wait()
        c = C()
        c.timeout_ms = 20000
        c.request_attachment.append_user_data(xs[i].tobytes())
        stub.Forward(c, EchoRequest(message="w"))
        if c.failed():
            errs.append(c.error_text())
        else:
            out[i] = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
        ch.close()

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(xs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs, errs
    return out


def _jax_forwards(w_np, xs, policy):
    from incubator_brpc_tpu.batching.policy import BatchPolicy as JPolicy
    from incubator_brpc_tpu.client.channel import Channel as JChannel
    from incubator_brpc_tpu.client.channel import ChannelOptions as JOptions
    from incubator_brpc_tpu.client.controller import Controller as JController
    from incubator_brpc_tpu.models.parameter_server import PsService as JPs
    from incubator_brpc_tpu.models.parameter_server import ps_stub as jps_stub
    from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JRequest
    from incubator_brpc_tpu.server.server import Server as JServer
    from incubator_brpc_tpu.server.server import ServerOptions as JOpts

    srv = JServer(JOpts(enable_batching=True,
                        batch_policies={"PsService.Forward":
                                        JPolicy.from_dict(policy.to_dict())}))
    svc = JPs()
    svc.put_param("w", w_np)
    srv.add_service(svc)
    assert srv.start(0) == 0
    out = [None] * len(xs)
    barrier = threading.Barrier(len(xs), timeout=20)
    try:
        def worker(i):
            ch = JChannel(JOptions(timeout_ms=20000))
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            barrier.wait()
            c = JController()
            c.request_attachment.append_user_data(xs[i].tobytes())
            jps_stub(ch).Forward(c, JRequest(message="w"))
            assert not c.failed(), c.error_text()
            out[i] = np.frombuffer(c.response_attachment.to_bytes(), np.float32)
            ch.close()

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(len(xs))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert srv.batcher("PsService.Forward").max_batch_seen >= 2
        return out
    finally:
        srv.stop()


def test_batched_forward_matches_the_jax_parameter_server():
    from incubator_brpc_tpu_torch.convert import params_from_reference

    rng = np.random.RandomState(1234)
    w_np = (rng.randn(256, 256) / 16.0).astype(np.float32)
    xs = [rng.randn(256).astype(np.float32) for _ in range(8)]
    policy = BatchPolicy(max_batch_size=8, max_wait_us=100_000,
                         padding_buckets=(1, 2, 4, 8))
    want = _jax_forwards(w_np, xs, policy)

    params = params_from_reference({"w": w_np}, CPU)
    assert params["w"].numpy().tobytes() == w_np.tobytes()
    srv = Server(ServerOptions(enable_batching=True,
                               batch_policies={"PsService.Forward": policy}))
    svc = ps()
    svc.put_param("w", params["w"])
    srv.add_service(svc)
    assert srv.start(0) == 0
    try:
        got = _concurrent_forwards(srv.port, xs)
        batcher = srv.batcher("PsService.Forward")
        assert batcher.rows == 8 and batcher.max_batch_seen >= 2
        assert batcher.batches < 8, "nothing coalesced"
    finally:
        srv.stop()
    for x, y, ref in zip(xs, got, want):
        scale = np.abs(x) @ np.abs(w_np)
        assert y.shape == (256,)
        assert np.all(np.abs(y - ref) <= FWD_RTOL * scale + FWD_ATOL)
        np.testing.assert_allclose(y, x.astype(np.float64) @ w_np.astype(np.float64),
                                   rtol=0, atol=float(FWD_RTOL * scale.max() + FWD_ATOL))


def test_forward_rows_fail_alone_and_numpy_w_is_placed_once():
    svc = ps()
    w_np = np.arange(64 * 64, dtype=np.float32).reshape(64, 64) / 4096.0
    svc.put_param("w", w_np)
    assert isinstance(svc._store["w"], torch.Tensor)
    assert svc._store["w"].device == CPU
    svc._store["blob"] = b"not a matrix"
    w16 = torch.from_numpy(w_np).to(torch.bfloat16)
    svc.put_param("w16", w16)  # mixed operand types promote, as jnp does
    srv = Server(ServerOptions(enable_batching=True, batch_policies={
        "PsService.Forward": BatchPolicy(max_batch_size=4, max_wait_us=100_000,
                                         padding_buckets=(1, 2, 4)),
    }))
    srv.add_service(svc)
    assert srv.start(0) == 0
    try:
        stub = ps_stub(make_channel(srv.port))
        results = {}

        def call(name, key, payload):
            c = Controller()
            c.request_attachment.append_user_data(payload)
            stub.Forward(c, EchoRequest(message=key), done=lambda: results.setdefault(name, c))

        x = np.ones(64, np.float32)
        call("ok", "w", x.tobytes())
        call("short", "w", x[:10].tobytes())
        call("blob", "blob", x.tobytes())
        call("missing", "nope", x.tobytes())
        call("half", "w16", x.tobytes())
        deadline = time.monotonic() + 10
        while len(results) < 5 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert set(results) == {"ok", "short", "blob", "missing", "half"}
        for name, w in [("ok", w_np), ("half", w16.float().numpy())]:
            assert not results[name].failed(), results[name].error_text()
            y = np.frombuffer(results[name].response_attachment.to_bytes(), np.float32)
            np.testing.assert_allclose(y, x @ w, rtol=1e-6)
        for name in ("short", "blob", "missing"):
            assert results[name].error_code == errors.EREQUEST, name
    finally:
        srv.stop()


def test_batched_forward_stamps_device_phase():
    """tests/test_profiling.py's device phase on a batched Forward, read
    off the span and the breakdown recorders (the port has no
    /latency_breakdown page yet)."""
    from incubator_brpc_tpu_torch.chaos.harness import wait_until
    from incubator_brpc_tpu_torch.observability import latency_breakdown, profiling
    from incubator_brpc_tpu_torch.observability.span import span_db
    from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag

    prev = (get_flag("rpcz_enabled", True), get_flag("rpcz_max_spans_per_second", 500))
    set_flag("rpcz_enabled", True)
    set_flag("rpcz_max_spans_per_second", 1_000_000)
    svc = ps()
    svc.put_param("w", np.random.RandomState(2).rand(64, 64).astype(np.float32))
    srv = Server(ServerOptions(enable_batching=True))
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = make_channel(srv.port, timeout_ms=30000)
    x = np.random.RandomState(3).rand(64).astype(np.float32)
    execs0 = profiling.kernel_snapshot().get("ps.forward", {}).get("executions", 0)
    try:
        for _ in range(3):
            c = Controller()
            c.request_attachment.append_user_data(x.tobytes())
            ps_stub(ch).Forward(c, EchoRequest(message="w"))
            assert not c.failed(), c.error_text()
        tid = c._span.trace_id

        def device_spans():
            return [
                s for s in span_db().recent(300)
                if s.trace_id == tid and s.kind == "server"
                and dict(s.phase_deltas()).get("device")
            ]

        assert wait_until(lambda: bool(device_spans()), timeout_s=8.0), \
            "no server span with a device phase"
        deltas = dict(device_spans()[-1].phase_deltas())
        assert deltas["device"] > 0
        assert deltas["device"] <= deltas["callback"] + 1
        assert "device" in latency_breakdown.snapshot().get("PsService.Forward", {})
        assert profiling.kernel_snapshot()["ps.forward"]["executions"] >= execs0 + 3
    finally:
        set_flag("rpcz_enabled", prev[0])
        set_flag("rpcz_max_spans_per_second", prev[1])
        srv.stop()
        ch.close()


# ---------------------------------------------------------------------------
# fused_stack_rows and ops/merge against the JAX package
# ---------------------------------------------------------------------------


def test_fused_stack_rows_matches_jax():
    import jax.numpy as jnp

    from incubator_brpc_tpu.batching import fused as jfused
    from incubator_brpc_tpu.parallel.ici import StagingRing as JRing
    from incubator_brpc_tpu_torch.batching import fused
    from incubator_brpc_tpu_torch.parallel.ici import StagingRing

    rng = np.random.RandomState(6)
    rows = [rng.randn(3, 128).astype(np.float32) for _ in range(5)]
    jout = jfused.fused_stack_rows([jnp.asarray(r) for r in rows], 8, freelist=JRing())
    ring = StagingRing()
    tout = fused.fused_stack_rows([torch.from_numpy(r) for r in rows], 8, freelist=ring)
    assert len(tout) == len(jout) == 5
    for t, j in zip(tout, jout):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    # the three pads went back to the ring, and the next stack reuses them
    assert ring.misses == 3 and sum(len(q) for q in ring._slots.values()) == 3
    fused.fused_stack_rows([torch.from_numpy(r) for r in rows], 8, freelist=ring)
    assert ring.hits == 3


def _merge_inputs(name, rng):
    if name == "first_valid":
        return (rng.randint(-50, 50, (4, 6)).astype(np.float32),
                np.array([False, False, True, True]))
    if name in ("concat", "partial_sum"):
        return ([rng.randint(-50, 50, (3, 6)).astype(np.float32) for _ in range(4)],)
    return (rng.randint(-50, 50, (4, 3, 6)).astype(np.float32),)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "concat", "first_valid",
                                  "partial_sum"])
def test_merge_ops_match_jax(name):
    from incubator_brpc_tpu.ops import merge as JM
    from incubator_brpc_tpu_torch.ops import merge as TM

    args = _merge_inputs(name, np.random.RandomState(hash(name) % 1000))
    jfn, tfn = getattr(JM, f"merge_{name}"), getattr(TM, f"merge_{name}")
    want = np.asarray(jfn(*args))
    got = tfn(*args)
    assert isinstance(got, torch.Tensor)
    assert got.numpy().dtype == want.dtype and got.numpy().shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_ps_forward_merge_sums_partials_like_jax():
    from incubator_brpc_tpu.models.parameter_server import ps_forward_merge as jmerge
    from incubator_brpc_tpu.client.controller import Controller as JC
    from incubator_brpc_tpu.protos.echo_pb2 import EchoResponse as JResp
    from incubator_brpc_tpu_torch.models.parameter_server import (
        ps_forward_merge,
        ps_forward_prepare_leg,
    )
    from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoResponse

    rng = np.random.RandomState(8)
    parts = [rng.randint(-9, 9, 32).astype(np.float32) for _ in range(3)]

    def run(C, R, merge):
        subs, resps = [], []
        for p in parts:
            c = C()
            c.response_attachment.append_user_data(p.tobytes())
            subs.append(c)
            resps.append(R(message="w"))
        parent, presp = C(), R()
        merge(parent, presp, subs + [None], resps + [None])
        return parent.response_attachment.to_bytes(), presp.message

    assert run(Controller, EchoResponse, ps_forward_merge) == run(JC, JResp, jmerge)
    parent = Controller()
    parent.request_attachment.append_user_data(np.arange(32, dtype=np.float32).tobytes())
    legs = []
    for i in range(4):
        sub = Controller()
        ps_forward_prepare_leg(i, 4, None, parent, sub)
        legs.append(np.frombuffer(sub.request_attachment.to_bytes(), np.float32))
    np.testing.assert_array_equal(np.concatenate(legs), np.arange(32, dtype=np.float32))


# ---------------------------------------------------------------------------
# the mesh branches and the device default
# ---------------------------------------------------------------------------


def test_ps_unported_branches_and_device_default(monkeypatch):
    """The branches that raised before the mesh was ported now run: a
    mesh over more than one chip gets the sharded kernel and shards an
    eligible W; ``remesh`` to one chip drops it and assembles W; the
    training step builds and steps.  The shard-per-server channel
    refuses a scatter over no shard, and without a card and a device
    the service raises."""
    from incubator_brpc_tpu_torch.models import parameter_server as P
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    svc = P.PsService(mesh=create_mesh((1, 4), devices=[CPU] * 4))
    assert svc.shard_kernel is not None and svc.shard_kernel.n_shards() == 4
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    assert svc.put_param("w", w) is True
    assert [tuple(s.shape) for s in svc._store["w"].shards] == [(2, 8)] * 4
    one = P.PsService(mesh=create_mesh((1, 1), devices=[CPU]), device=CPU)
    assert one.shard_kernel is None and one.remesh(None) == 0
    assert svc.remesh(None) == 0 and svc.shard_kernel is None
    assert isinstance(svc._store["w"], torch.Tensor)
    assert np.array_equal(svc._store["w"].numpy(), w)
    empty = P.sharded_ps_channel(endpoints=[])
    assert empty.partition_count() == 0
    with pytest.raises(ValueError, match="do not scatter"):
        P.scatter_param(empty, "w", np.zeros((4, 4), np.float32))
    step, params, x = P.make_training_step(
        create_mesh((2, 2), devices=[CPU] * 4), dim=8, batch=4)
    _, loss = step(params, x)
    assert np.isfinite(float(loss))
    assert P.max_servable_dim(64 << 20) == 4096
    assert P.max_servable_dim(64 << 20, 4) == 8192
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        P.PsService()


def test_package_exports_the_parameter_server():
    import incubator_brpc_tpu_torch as port

    assert port.PsService is PsService and port.BatchPolicy is BatchPolicy
    assert port.batching.Batcher is Batcher
    assert port.batching.fused_stack_rows.__module__ == \
        "incubator_brpc_tpu_torch.batching.fused"
