"""Disaggregated serving (serving/, docs/serving.md): prefill/decode
split with HBM-resident KV, live session migration, exactly-once token
emission, the ``kv.ship`` / ``session.migrate`` chaos sites, and the
``kv:<session>@<epoch>`` naming grammar.

Carried by hand from ``tests/test_serving.py``: every store, prefill
service and decode loop is given the device the case runs on (the CPU,
or the card), as the port has no default device.  The cases of the JAX
file that ``tests/test_torch_serving.py`` and ``tests/test_torch_chaos.py``
already hold are not repeated here.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.chaos.harness import RecoveryHarness
from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.serving import metrics as serving_metrics
from incubator_brpc_tpu_torch.serving import session as sv_session
from incubator_brpc_tpu_torch.serving.decode import (
    DecodeService,
    decode_stub,
)
from incubator_brpc_tpu_torch.serving.prefill import (
    KvShipError,
    PrefillService,
    prompt_seed_state,
)
from incubator_brpc_tpu_torch.serving.router import SessionChannel, SessionError
from incubator_brpc_tpu_torch.serving.session import (
    format_kv_key,
    kv_layer_keys,
    parse_kv_key,
)
from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop

from torch_carry import torch_device  # noqa: F401  (fixture)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DIM = 12


@pytest.fixture(autouse=True)
def _clean():
    sv_session.clear_registry()
    yield
    sv_session.clear_registry()
    injector.disarm()


def _tier(device, n_replicas=2, n_layers=3, step_delay_s=0.0, max_sessions=32):
    store = HBMCacheStore(device=device, hbm_budget_bytes=1 << 24)
    pf = PrefillService(store, device=device, dim=DIM, n_layers=n_layers)
    reps = [
        DecodeService(
            store,
            DecodeLoop(device=device, dim=DIM, step_delay_s=step_delay_s),
            name=f"d{i}",
            max_sessions=max_sessions,
        )
        for i in range(n_replicas)
    ]
    return store, pf, reps, SessionChannel(pf, reps)


def _close(reps):
    for r in reps:
        r.close()


# ---- the kv:<session>@<epoch>[#<layer>] grammar -----------------------------


def test_kv_key_roundtrip():
    assert format_kv_key("chat-42", 3) == b"kv:chat-42@3"
    assert format_kv_key("chat-42", 3, layer=1) == b"kv:chat-42@3#1"
    assert parse_kv_key(b"kv:chat-42@3") == ("chat-42", 3, None)
    assert parse_kv_key("kv:chat-42@3#1") == ("chat-42", 3, 1)
    # sessions may themselves contain @ — rpartition anchors the epoch
    assert parse_kv_key("kv:user@host@7#0") == ("user@host", 7, 0)
    assert kv_layer_keys("s", 2, 3) == [
        b"kv:s@2#0", b"kv:s@2#1", b"kv:s@2#2",
    ]


def test_kv_key_rejects_foreign_grammars_and_junk():
    # the OTHER naming-tag grammars must parse to None, never misroute
    assert parse_kv_key("0/4@2") is None  # resharding partition tag
    assert parse_kv_key("ps@3:replica-b") is None  # replication lease tag
    assert parse_kv_key("kv:") is None
    assert parse_kv_key("kv:noepoch") is None
    assert parse_kv_key("kv:s@") is None
    assert parse_kv_key("kv:s@-1") is None
    assert parse_kv_key("kv:s@2#-1") is None
    assert parse_kv_key("kv:s@2#x") is None
    assert parse_kv_key(b"\xff\xfe") is None
    assert parse_kv_key(None) is None


def test_prompt_seed_state_matches_decode_loop_init():
    import hashlib

    import numpy as np

    seed = int.from_bytes(
        hashlib.blake2s(b"prompt-x", digest_size=8).digest(), "big"
    )
    expect = np.random.default_rng(seed).standard_normal(DIM).astype(
        np.float32
    )
    assert np.array_equal(prompt_seed_state("prompt-x", DIM), expect)


# ---- disagg == monolith -----------------------------------------------------


def test_prefill_window_is_one_batched_execution(torch_device):
    """A multi-session prefill window pads to ONE bucketed device
    execution (the padding-bucket discipline), and every session's complete
    layer set lands in the store."""
    store = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 24)
    pf = PrefillService(store, device=torch_device, dim=DIM, n_layers=4)
    reqs = [(f"w{i}", f"prompt {i}") for i in range(5)]
    out = pf.prefill_sessions(reqs)
    assert pf.batches == 1
    assert pf.sessions_prefilled == 5
    assert set(out) == {f"w{i}" for i in range(5)}
    for sid, _p in reqs:
        assert all(store.get(k) is not None for k in kv_layer_keys(sid, 0, 4))
    assert out["w0"]["kv_bytes"] == 4 * DIM * 4


# ---- migration: exactly-once across >=2 replica hops ------------------------


def test_all_replicas_dead_fails_with_erpc_code(torch_device):
    store, pf, reps, ch = _tier(torch_device, n_replicas=2)
    try:
        for r in reps:
            r.kill()
        with pytest.raises(SessionError) as ei:
            ch.generate("s-dead", "nowhere to go", 4)
        assert ei.value.code in (errors.EOVERCROWDED, errors.ETOOMANYFAILS)
        assert sv_session.get_session("s-dead").state == sv_session.FAILED
    finally:
        _close(reps)


# ---- chaos: kv.ship ---------------------------------------------------------


def test_kv_ship_drop_at_checkpoint_falls_back_to_crash_migration(torch_device):
    """A dropped CHECKPOINT ship must not lose the session: the old
    epoch is intact (complete-or-absent), so the handoff falls back to
    re-pull + fast-forward and the session still completes with
    contiguous tokens."""
    store, pf, reps, ch = _tier(torch_device, n_replicas=2, step_delay_s=0.01)
    try:
        got = {}
        t = threading.Thread(
            target=lambda: got.setdefault(
                "res", ch.generate("s-ckptfail", "ship will fail", 40)
            )
        )
        t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            r = sv_session.get_session("s-ckptfail")
            if r is not None and len(r.tokens) >= 5:
                break
            time.sleep(0.01)
        # epoch 1 is the checkpoint's target epoch: drop its layer-0 ship
        plan = FaultPlan(
            [FaultSpec("kv.ship", "drop",
                       match={"method": "kv:s-ckptfail@1#0"})],
            seed=11, name="ckpt-ship-drop",
        )
        injector.arm(plan)
        assert ch.migrate("s-ckptfail", "test") is True
        injector.disarm()
        t.join(30)
        res = got["res"]
        assert len(res.tokens) == 40
        kinds = [e["kind"] for e in res.record.migration_log]
        assert "graceful-fallback" in kinds
        assert res.prefill_executions == 1
    finally:
        _close(reps)


def test_kv_ship_seeded_replay_identical_hit_log(torch_device):
    """Same plan + same traversal → identical kv.ship firings, run to
    run (the seeded-replay regression for the new site)."""
    logs = []
    for _ in range(2):
        store = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 24)
        pf = PrefillService(store, device=torch_device, dim=DIM, n_layers=4)
        plan = FaultPlan(
            [FaultSpec("kv.ship", "drop", probability=0.35)],
            seed=20260806, name="kv-ship-replay",
        )
        injector.arm(plan)
        outcomes = []
        for i in range(8):
            try:
                pf.prefill_sessions([(f"r{i}", f"replay {i}")])
                outcomes.append("ok")
            except KvShipError:
                outcomes.append("drop")
        logs.append((outcomes, injector.hit_log()))
        injector.disarm()
    assert logs[0] == logs[1]
    assert "drop" in logs[0][0], "plan never fired — schedule broken"
    assert "ok" in logs[0][0], "plan always fired — not probabilistic"


def test_kv_ship_delay_us_stretches_not_fails(torch_device):
    store = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 24)
    pf = PrefillService(store, device=torch_device, dim=DIM, n_layers=2)
    plan = FaultPlan(
        [FaultSpec("kv.ship", "delay_us", arg=20_000)],
        seed=3, name="kv-ship-delay",
    )
    injector.arm(plan)
    t0 = time.monotonic()
    pf.prefill_sessions([("slow", "delayed ship")])
    took = time.monotonic() - t0
    injector.disarm()
    assert took >= 0.03  # 2 layers x 20ms
    assert all(store.get(k) is not None for k in kv_layer_keys("slow", 0, 2))


# ---- chaos: session.migrate -------------------------------------------------


def test_session_migrate_drop_aborts_handoff_session_stays_on_source(torch_device):
    """A dropped handoff is ABORTED, not half-done: the session stays
    on its source replica, the ownership epoch does not bump, and the
    stream completes uninterrupted with zero migrations."""
    store, pf, reps, ch = _tier(torch_device, n_replicas=2, step_delay_s=0.01)
    try:
        got = {}
        t = threading.Thread(
            target=lambda: got.setdefault(
                "res", ch.generate("s-abort", "stay home", 30)
            )
        )
        t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            r = sv_session.get_session("s-abort")
            if r is not None and r.replica and len(r.tokens) >= 3:
                break
            time.sleep(0.01)
        rec = sv_session.get_session("s-abort")
        source, epoch_before = rec.replica, rec.epoch
        plan = FaultPlan(
            [FaultSpec("session.migrate", "drop")],
            seed=13, name="migrate-drop",
        )
        injector.arm(plan)
        assert ch.migrate("s-abort", "test") is False
        injector.disarm()
        assert rec.replica == source
        assert rec.epoch == epoch_before
        t.join(30)
        res = got["res"]
        assert len(res.tokens) == 30
        assert res.migrations == 0
        assert [e["kind"] for e in res.record.migration_log] == ["aborted"]
        assert ch.migrations_aborted == 1
    finally:
        _close(reps)


# ---- recovery harness acceptance --------------------------------------------


@pytest.mark.slow
def test_recovery_kill_decode_replica_under_storm(torch_device):
    """Acceptance: kill a decode replica mid-generation under
    a seeded storm — every live session migrates and completes with
    exactly-once contiguous tokens, prefill_executions == 1 per
    session, ERPC-only codes, and the tier settles."""
    store, pf, reps, ch = _tier(
        torch_device, n_replicas=3, n_layers=3, step_delay_s=0.005
    )
    plan = FaultPlan(
        [
            FaultSpec("kv.ship", "delay_us", arg=2_000, probability=0.3),
            FaultSpec("cache.lookup", "delay_us", arg=2_000,
                      probability=0.3),
            FaultSpec("session.migrate", "delay_us", arg=5_000,
                      probability=0.5),
        ],
        seed=20260806, name="serving-storm",
    )
    sessions = [f"storm-{i}" for i in range(4)]
    n_tokens = 40

    def workload(h):
        results = {}
        threads = []

        def run(sid):
            try:
                results[sid] = ch.generate(sid, f"prompt {sid}", n_tokens)
                h.record_error(0)
            except SessionError as e:
                h.record_error(e.code)

        for sid in sessions:
            th = threading.Thread(target=run, args=(sid,))
            th.start()
            threads.append(th)
        # wait until every session is decoding somewhere, then kill
        # the replica owning the most sessions
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            recs = [sv_session.get_session(s) for s in sessions]
            if all(r is not None and r.replica for r in recs) and all(
                len(r.tokens) >= 3 for r in recs
            ):
                break
            time.sleep(0.01)
        owners = [sv_session.get_session(s).replica for s in sessions]
        victim_name = max(set(owners), key=owners.count)
        victim = {d.name: d for d in reps}[victim_name]
        victim.kill()
        for th in threads:
            th.join(40)
        assert not any(th.is_alive() for th in threads)
        return results, victim_name, owners

    harness = RecoveryHarness(
        plan,
        wall_clock_s=60.0,
        baseline_probes=[
            ("live_sessions",
             lambda: float(sum(r.live_sessions() for r in reps))),
        ],
    )
    try:
        report = harness.run_or_raise(workload)
        results, victim_name, owners = report.workload_result
        assert len(results) == len(sessions), "a session failed for good"
        for sid in sessions:
            res = results[sid]
            assert len(res.tokens) == n_tokens
            assert res.prefill_executions == 1
            assert pf.prefill_executions[sid] == 1
        # every session that lived on the victim migrated off it
        for sid, owner in zip(sessions, owners):
            if owner == victim_name:
                assert results[sid].migrations >= 1
        assert any(results[s].migrations >= 1 for s in sessions)
    finally:
        _close(reps)


# ---- device witness: KV never crosses to host -------------------------------


def _child_device(device):
    return "torch.device('cpu')" if device.type == "cpu" else "torch.device('cuda', 0)"


def _run_child(code, timeout=240):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=timeout, cwd=REPO_ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )


@pytest.mark.slow
def test_witness_kv_never_crosses_host_prefill_to_decode(torch_device):
    """Armed witness over the WHOLE disagg path — prefill, KV ship,
    fused DMGET pull, decode with migration: zero violations, zero
    unmanifested pulls, no cache.host-spill use (the KV plane never
    exits to host; only the decode loop's manifested token-sum pull
    may cross)."""
    code = textwrap.dedent(f"""\
        import sys
        sys.path.insert(0, {str(REPO_ROOT)!r})
        from incubator_brpc_tpu_torch.analysis import device_witness as dw
        dw.enable()
        import threading, time
        import torch
        DEV = {_child_device(torch_device)}
        from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
        from incubator_brpc_tpu_torch.serving.prefill import PrefillService
        from incubator_brpc_tpu_torch.serving.decode import DecodeService
        from incubator_brpc_tpu_torch.serving.router import SessionChannel
        from incubator_brpc_tpu_torch.streaming.generate import DecodeLoop
        from incubator_brpc_tpu_torch.serving import session as sv

        store = HBMCacheStore(device=DEV, hbm_budget_bytes=1 << 24)
        pf = PrefillService(store, device=DEV, dim=8, n_layers=3)
        reps = [
            DecodeService(store, DecodeLoop(device=DEV, dim=8, step_delay_s=0.01),
                          name=f"d{{i}}")
            for i in range(2)
        ]
        ch = SessionChannel(pf, reps)
        got = {{}}
        t = threading.Thread(
            target=lambda: got.setdefault(
                "r", ch.generate("w-sess", "witnessed", 30)))
        t.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            rec = sv.get_session("w-sess")
            if rec is not None and len(rec.tokens) >= 4:
                break
            time.sleep(0.01)
        assert ch.migrate("w-sess", "witness hop") is True
        t.join(60)
        res = got["r"]
        assert len(res.tokens) == 30, res.tokens
        assert res.migrations >= 1
        for r in reps:
            r.close()
        rep = dw.cross_check()
        assert rep["violations"] == [], rep["violations"]
        assert "cache.host-spill" not in rep["scope_uses"], rep["scope_uses"]
        assert dw.retrace_contradictions() == []
        print("WITNESS-DISAGG-OK")
    """)
    proc = _run_child(code)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr}"
    assert "WITNESS-DISAGG-OK" in proc.stdout


# ---- RPC fronts -------------------------------------------------------------


def _server(svc):
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    return srv


def test_unary_admit_fallback_and_missing_kv_is_erpc(torch_device):
    store = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 24)
    pf = PrefillService(store, device=torch_device, dim=DIM, n_layers=2)
    dec = DecodeService(store, DecodeLoop(device=torch_device, dim=DIM), name="u-d0")
    srv = _server(dec)
    ch = Channel(ChannelOptions(timeout_ms=10000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        # no KV in the cache yet: the admission FAILS with an ERPC
        # code, it never silently recomputes prefill
        c = Controller()
        decode_stub(ch).Admit(
            c, EchoRequest(message=json.dumps(
                {"session": "u-s", "kv_epoch": 0, "n_layers": 2,
                 "max_tokens": 4}))
        )
        assert c.failed()
        assert c.error_code == errors.EINTERNAL
        assert "incomplete" in c.error_text()

        pf.prefill_sessions([("u-s", "unary prompt")])
        c2 = Controller()
        r = decode_stub(ch).Admit(
            c2, EchoRequest(message=json.dumps(
                {"session": "u-s", "kv_epoch": 0, "n_layers": 2,
                 "max_tokens": 4}))
        )
        assert not c2.failed(), c2.error_text()
        lines = r.message.splitlines()
        assert len(lines) == 4
        assert [l.split()[0] for l in lines] == ["0", "1", "2", "3"]
        assert dec.unary_rows >= 1
    finally:
        ch.close()
        srv.stop()
        dec.close()


def test_sse_admit_front(torch_device):
    store = HBMCacheStore(device=torch_device, hbm_budget_bytes=1 << 24)
    pf = PrefillService(store, device=torch_device, dim=DIM, n_layers=2)
    pf.prefill_sessions([("sse-s", "sse prompt")])
    dec = DecodeService(store, DecodeLoop(device=torch_device, dim=DIM), name="sse-d0")
    srv = _server(dec)
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=20000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        c = Controller()
        c.response_will_be_read_progressively()
        decode_stub(ch).AdmitSSE(
            c, EchoRequest(message=json.dumps(
                {"session": "sse-s", "kv_epoch": 0, "n_layers": 2,
                 "max_tokens": 5}))
        )
        assert not c.failed(), c.error_text()
        parts, end = [], threading.Event()

        def reader(part):
            if part is None:
                end.set()
            else:
                parts.append(part)

        assert c.read_progressive_attachment(reader) == 0
        assert end.wait(20)
        body = b"".join(parts).decode()
        events = [l[6:] for l in body.split("\n") if l.startswith("data: ")]
        assert events[-1] == "[DONE]"
        assert len(events) == 6  # 5 "<idx> <tok>" + terminator
        assert [e.split()[0] for e in events[:-1]] == [
            str(i) for i in range(5)
        ]
        assert dec.sse_rows == 1
    finally:
        ch.close()
        srv.stop()
        dec.close()


# ---- observability ----------------------------------------------------------


def test_serving_metrics_exposed_and_counted(torch_device):
    from incubator_brpc_tpu_torch.metrics.variable import _registry

    for name in (
        "rpc_serving_sessions", "rpc_serving_migrations",
        "rpc_serving_kv_bytes", "rpc_serving_prefill_reuse",
    ):
        assert name in _registry, f"{name} not exposed"
    base = serving_metrics.snapshot()
    store, pf, reps, ch = _tier(torch_device, n_replicas=2, step_delay_s=0.01)
    try:
        got = {}
        t = threading.Thread(
            target=lambda: got.setdefault(
                "r", ch.generate("m-sess", "metrics", 30))
        )
        t.start()
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            r = sv_session.get_session("m-sess")
            if r is not None and len(r.tokens) >= 3:
                break
            time.sleep(0.01)
        assert ch.migrate("m-sess", "for metrics")
        t.join(30)
        now = serving_metrics.snapshot()
        assert now["sessions"] == base["sessions"] + 1
        assert now["migrations"] >= base["migrations"] + 1
        assert now["prefill_reuse"] >= base["prefill_reuse"] + 1
        assert now["kv_bytes"] > base["kv_bytes"]
    finally:
        _close(reps)


def test_serving_builtin_page_and_status_section(torch_device):
    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page_full

    store, pf, reps, ch = _tier(torch_device)
    srv = _server(reps[0])
    try:
        ch.generate("b-sess", "builtin page", 5)
        addr = f"127.0.0.1:{srv.port}"

        status, _ct, body = fetch_page_full(addr, "serving")
        assert status == 200
        d = json.loads(body)
        assert d["enabled"] is True
        assert d["sessions"]["b-sess"]["state"] == "DONE"
        assert d["sessions"]["b-sess"]["prefill_executions"] == 1
        assert "sessions" in d["counters"]

        status, _ct, body = fetch_page_full(addr, "serving?session=b-sess")
        assert status == 200
        assert json.loads(body)["tokens"] == 5

        status, _ct, body = fetch_page_full(addr, "serving?session=ghost")
        assert status == 404

        status, _ct, body = fetch_page_full(addr, "status")
        assert status == 200
        text = body.decode()
        assert "serving:" in text
        assert "b-sess: state=DONE" in text

        status, _ct, body = fetch_page_full(addr, "")
        assert "/serving" in body.decode()
    finally:
        srv.stop()
        _close(reps)


def test_rpcz_one_trace_joins_prefill_ship_and_hops(torch_device):
    """One session = one rpcz trace: the root client span plus
    collective legs for prefill, every kv.ship and each decode hop,
    all sharing the root's trace id."""
    from incubator_brpc_tpu_torch.chaos.harness import wait_until
    from incubator_brpc_tpu_torch.observability.span import span_db
    from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag

    prev = get_flag("rpcz_enabled", True)
    set_flag("rpcz_enabled", True)
    try:
        store, pf, reps, ch = _tier(torch_device, n_replicas=2, step_delay_s=0.01)
        try:
            got = {}
            t = threading.Thread(
                target=lambda: got.setdefault(
                    "r", ch.generate("z-sess", "traced", 30))
            )
            t.start()
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                r = sv_session.get_session("z-sess")
                if r is not None and len(r.tokens) >= 3:
                    break
                time.sleep(0.01)
            assert ch.migrate("z-sess", "trace the hop")
            t.join(30)
            assert got["r"].migrations >= 1
        finally:
            _close(reps)
        # spans reach the SpanDB through the Collector's drain rounds;
        # pick THIS session's root by its annotation (other tests may
        # have left Serving/Session roots of their own in the ring)
        def _my_root():
            for s in span_db().recent(400):
                if (
                    s.service == "Serving"
                    and s.method == "Session"
                    and "session=z-sess" in s.describe()
                ):
                    return s
            return None

        assert wait_until(
            lambda: _my_root() is not None, timeout_s=3.0
        ), "root Session span never reached the SpanDB"
        root = _my_root()
        assert wait_until(
            lambda: sum(
                1
                for s in span_db().by_trace(root.trace_id)
                if s.method.startswith("decode.hop.")
            ) >= 2,
            timeout_s=5.0,
        ), [s.method for s in span_db().by_trace(root.trace_id)]
        mine = span_db().by_trace(root.trace_id)
        methods = [s.method for s in mine]
        assert "prefill" in methods
        assert "kv.ship" in methods
        hops = [m for m in methods if m.startswith("decode.hop.")]
        assert len(hops) >= 2, methods
        assert all(s.kind == "collective" for s in mine
                   if s.method != "Session")
    finally:
        set_flag("rpcz_enabled", prev)
