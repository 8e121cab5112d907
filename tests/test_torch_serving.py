"""The port's streaming decode loop and disaggregated prefill/decode
serving held against the JAX package's, on the CPU.

The scenarios are those of tests/test_streaming_generate.py:84-244
(the decode loop and the Generate RPC) and tests/test_serving.py
(disagg == monolithic, one batched prefill, the fused DMGET pull,
exactly-once across two migrations, shed and hop, complete-or-absent
KV ships, streamed admit over RPC), each run through the port with
``device=torch.device("cpu")`` and, on the same inputs in the same
test, through the JAX package.

Tolerances.  Both packages draw W from ``default_rng(1234)`` and seed
each prompt's state from its hash, so W and layer 0 are bit-equal.
The step ``tanh(s @ W)`` sums in another order than XLA, so a state
agrees with JAX's within 1e-5·(|s| @ |W|) + 1e-6 per element.  A
token is ``int(|Σ state| · 1e4) % vocab``.  Each port loop's steps are
recorded (``trace_steps``) and the JAX kernel is run from the port's
own input states: every port token equals the token of the port's own
sum and of JAX's.  Against the JAX loop's own run the trajectories
stay within DRIFT per element, and the tokens differ exactly where
listed (``JAX_RUN_DIFFERS``: 2 of the JAX tests' 197 tokens, sums that
straddle a boundary).  Within the port, one device and one bucket,
tokens are compared for equality.
"""

import hashlib
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from incubator_brpc_tpu.cache.store import HBMCacheStore as JStore
from incubator_brpc_tpu.chaos import injector as j_injector
from incubator_brpc_tpu.serving import session as j_session
from incubator_brpc_tpu.serving.decode import DecodeService as JDecodeService
from incubator_brpc_tpu.serving.prefill import PrefillService as JPrefill
from incubator_brpc_tpu.serving.router import SessionChannel as JSessionChannel
from incubator_brpc_tpu.streaming.generate import DecodeLoop as JLoop
from incubator_brpc_tpu.streaming.generate import GenerateService as JGenerateService
from incubator_brpc_tpu_torch import convert
from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.cache.store import HBMCacheStore
from incubator_brpc_tpu_torch.cache import store as p_store_mod
from incubator_brpc_tpu_torch.chaos import injector
from incubator_brpc_tpu_torch.chaos.plan import FaultPlan, FaultSpec
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.client.stream import Stream, StreamHandler
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server
from incubator_brpc_tpu_torch.serving import session as sv_session
from incubator_brpc_tpu_torch.serving.decode import (
    AdmitError,
    DecodeService,
    _as_state,
    decode_stub,
)
from incubator_brpc_tpu_torch.serving.prefill import (
    PrefillService,
    prefill_stub,
    prompt_seed_state,
)
from incubator_brpc_tpu_torch.serving.router import SessionChannel, SessionError
from incubator_brpc_tpu_torch.serving.session import kv_layer_keys, parse_kv_key
from incubator_brpc_tpu_torch.streaming.generate import (
    DecodeLoop,
    GenerateService,
    generate_stub,
)
from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag

CPU = torch.device("cpu")
DIM = 12  # tests/test_serving.py's width
RTOL, ATOL = 1e-5, 1e-6
# the port's and the JAX loop's trajectories from one state, per element
# at every step (at most 7e-7 over the 60 steps of these tests)
DRIFT = 2e-6
VOCAB = 32000


@pytest.fixture(autouse=True)
def _isolation():
    # the port's rpcz flag is process-wide: restore what this test found
    rpcz = get_flag("rpcz_enabled")
    sv_session.clear_registry()
    j_session.clear_registry()
    yield
    set_flag("rpcz_enabled", rpcz)
    sv_session.clear_registry()
    j_session.clear_registry()
    injector.disarm()
    j_injector.disarm()


@pytest.fixture
def closer():
    """Everything with a ``stop``/``close`` made by a test is shut down
    at its end, passed or failed: no decode thread outlives its test."""
    made = []
    yield made.append
    for obj in reversed(made):
        (getattr(obj, "stop", None) or obj.close)()


# ---------------------------------------------------------------------------
# the JAX reference and the token rule
# ---------------------------------------------------------------------------


def seed_state(prompt, dim):
    seed = int.from_bytes(hashlib.blake2s(prompt.encode(), digest_size=8).digest(), "big")
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def token_of(s):
    return f"t{int(abs(float(s)) * 1e4) % VOCAB}"


def trace_steps(loop):
    """Record every step the port loop runs as numpy (input rows, output
    rows, row sums), by wrapping its step kernel; returns the list that
    fills."""
    steps, inner = [], loop._kernel

    def traced(w, s):
        out, sums = inner(w, s)
        steps.append((s.numpy().copy(), out.numpy().copy(), sums.numpy().copy()))
        return out, sums

    loop._kernel = traced
    return steps


def row_trace(steps, s0, n):
    """The port's own computation for the row that started from ``s0``:
    per token (input state, output state, sum).  The row is followed
    through the recorded steps from the first that holds ``s0``: at each
    later step its input is, bit for bit, its output of the step before,
    in whichever slot of the window it sits."""
    trace, prev = [], np.asarray(s0, np.float32)
    for s_in, s_out, sums in steps:
        hit = [i for i in range(len(s_in)) if np.array_equal(s_in[i], prev)]
        if not hit:
            assert not trace, f"the row left the window after {len(trace)} of {n} steps"
            continue
        i = hit[0]
        trace.append((prev, s_out[i], float(sums[i])))
        prev = s_out[i]
        if len(trace) == n:
            return trace
    raise AssertionError(f"the row ran {len(trace)} of {n} steps")


def assert_tokens_match(port_tokens, trace, jloop, jax_tokens=None, jax_differs=()):
    """Hold the port's tokens to the JAX kernel run from the port's own
    states.  At each step of ``trace`` (``row_trace``) the port's output
    state is within 1e-5·(|s| @ |W|) + 1e-6 per element of JAX's from the
    same input, its sum within the sum of those bounds, and its token is
    ``token_of`` its own sum and of JAX's sum: no boundary lies between
    the two sums (none does on any prompt of these tests).

    ``jax_tokens`` are the JAX loop's own run from the same first state.
    The two trajectories stay within DRIFT per element at every step,
    and the tokens differ exactly at the steps ``jax_differs``, each
    where the two sums, within ``dim``·DRIFT of each other, straddle a
    token boundary."""
    assert len(trace) == len(port_tokens)
    w, wa = jloop._ensure_w(), np.abs(jloop._w.astype(np.float64))
    s_jax = trace[0][0]
    differs = []
    for k, (tok, (s_in, s_out, psum)) in enumerate(zip(port_tokens, trace)):
        jn, js = jloop._kernel(w, jnp.asarray(s_in[None]))
        jn, jsum = np.asarray(jn)[0], float(np.asarray(js)[0])
        bound = RTOL * (np.abs(s_in).astype(np.float64) @ wa) + ATOL
        assert np.all(np.abs(s_out - jn) <= bound), (
            f"step {k}: state off JAX's by {np.abs(s_out - jn).max():.3g}")
        assert abs(psum - jsum) <= bound.sum(), (
            f"step {k}: sum {psum!r} vs JAX {jsum!r}, beyond {bound.sum():.3g}")
        assert tok == token_of(psum) == token_of(jsum), (
            f"step {k}: token {tok}, port sum {psum!r}, JAX sum {jsum!r}")
        if jax_tokens is None:
            continue
        # the JAX loop's own trajectory, one step on
        jn, js = jloop._kernel(w, jnp.asarray(s_jax[None]))
        s_jax, run_sum = np.asarray(jn)[0], float(np.asarray(js)[0])
        assert jax_tokens[k] == token_of(run_sum), "the JAX loop's token is not its kernel's"
        assert np.abs(s_out - s_jax).max() <= DRIFT, (
            f"step {k}: trajectories {np.abs(s_out - s_jax).max():.3g} apart")
        if jax_tokens[k] != tok:
            assert abs(psum - run_sum) <= len(s_in) * DRIFT
            differs.append(k)
    if jax_tokens is not None:
        assert len(jax_tokens) == len(port_tokens)
        assert differs == list(jax_differs), f"tokens differ from the JAX run at {differs}"


def collect(loop, prompt, n, timeout=30, **kw):
    toks, done = [], threading.Event()
    loop.admit(prompt, n, lambda t, r: toks.append(t), lambda r, ok: done.set(), **kw)
    assert done.wait(timeout), loop.describe()
    return toks


# ---------------------------------------------------------------------------
# weights, steps and tokens against the JAX package
# ---------------------------------------------------------------------------


def test_weights_bit_equal_across_packages(closer):
    """W is drawn from the same seeded generator in both packages and
    placed once; convert.decode_weights_from_reference carries a JAX
    loop's (or prefill's) W across bit for bit."""
    for dim in (8, 12, 32):
        jloop, ploop = JLoop(dim=dim), DecodeLoop(dim=dim, device=CPU)
        closer(jloop)
        closer(ploop)
        w = ploop._ensure_w()
        assert w is ploop._ensure_w()  # placed once
        assert w.dtype == torch.float32 and w.device == CPU
        assert np.array_equal(w.numpy(), np.asarray(jloop._ensure_w()))
        assert torch.equal(convert.decode_weights_from_reference(jloop, CPU), w)
        jpf = JPrefill(JStore(1 << 20), dim=dim, n_layers=2)
        ppf = PrefillService(HBMCacheStore(1 << 20, device=CPU), dim=dim,
                             n_layers=2, device=CPU)
        assert torch.equal(convert.decode_weights_from_reference(jpf, CPU),
                           ppf._ensure_w())
        assert torch.equal(ppf._ensure_w(), w)


@pytest.mark.parametrize("dim,bucket", [(8, 1), (12, 4), (32, 32)])
def test_step_kernel_within_tolerance_of_jax(dim, bucket, closer):
    """The fused step on one input: states within 1e-5·(|s| @ |W|) +
    1e-6 per element of JAX's, the row sums within the sum of those."""
    jloop, ploop = JLoop(dim=dim), DecodeLoop(dim=dim, device=CPU)
    closer(jloop)
    closer(ploop)
    s = np.random.default_rng(dim).standard_normal((bucket, dim)).astype(np.float32)
    jn, js = jloop._kernel(jloop._ensure_w(), jnp.asarray(s))
    pn, ps = ploop._kernel(ploop._ensure_w(), torch.from_numpy(s))
    bound = RTOL * (np.abs(s).astype(np.float64) @ np.abs(jloop._w)) + ATOL
    assert np.all(np.abs(pn.numpy() - np.asarray(jn)) <= bound)
    assert np.all(np.abs(ps.numpy() - np.asarray(js)) <= bound.sum(-1))


# the prompts, token counts and widths of the JAX tests this file reruns
JAX_TEST_PROMPTS = [
    (8, "same-prompt", 6), (8, "prompt-b", 5), (8, "good-row", 20),
    (8, "roundtrip", 10), (8, "both-paths", 6), (8, "mate", 60),
    (12, "hello disagg", 10), (12, "fused pull", 4), (12, "migrate me", 60),
    (12, "overflow", 6), (12, "over the wire", 6), (12, "healthy again", 4),
]


# where the JAX loop's own run emits another token than the port's: the
# two trajectories, 4e-7 to 7e-7 apart per element by then, straddle a
# boundary (sums -2.9711995 / -2.9712002 and 2.2200999 / 2.2201014)
JAX_RUN_DIFFERS = {(8, "mate"): (35, 37)}


@pytest.mark.parametrize("dim,prompt,n", JAX_TEST_PROMPTS)
def test_loop_tokens_match_jax_for_the_jax_tests_prompts(dim, prompt, n, closer):
    """Each prompt of the JAX tests, run alone through both loops: the
    same tokens, a difference allowed only at a token boundary (and
    counted; see ROADMAP.md queue 3)."""
    jloop, ploop = JLoop(dim=dim), DecodeLoop(dim=dim, device=CPU)
    closer(jloop)
    closer(ploop)
    steps = trace_steps(ploop)
    jt, pt = collect(jloop, prompt, n), collect(ploop, prompt, n)
    assert len(pt) == len(jt) == n
    assert_tokens_match(pt, row_trace(steps, seed_state(prompt, dim), n), jloop, jt,
                        JAX_RUN_DIFFERS.get((dim, prompt), ()))


def test_batched_window_rows_held_to_jax_row_by_row(closer):
    """Five rows admitted together share every step (bucket 8, three
    pad rows): each row's state moves through the window as its own,
    and each row's tokens are its own sums', held to the JAX kernel from
    the same states."""
    loop, jloop = DecodeLoop(dim=DIM, device=CPU), JLoop(dim=DIM)
    closer(loop)
    closer(jloop)
    steps = trace_steps(loop)
    prompts = [f"batched {i}" for i in range(5)]
    toks = {p: [] for p in prompts}
    dones = [threading.Event() for _ in prompts]
    with loop._cv:  # all five join the first step's window
        for p, ev in zip(prompts, dones):
            loop.admit(p, 20, lambda t, r, p=p: toks[p].append(t),
                       lambda r, ok, ev=ev: ev.set())
    assert all(ev.wait(30) for ev in dones)
    assert loop.steps == 20 and loop.max_fused == 5
    assert all(len(s_in) == 8 for s_in, _, _ in steps)
    for p in prompts:
        assert_tokens_match(toks[p], row_trace(steps, seed_state(p, DIM), 20), jloop)


# ---------------------------------------------------------------------------
# the decode loop (tests/test_streaming_generate.py:84-177)
# ---------------------------------------------------------------------------


def test_loop_generates_deterministic_tokens(closer):
    loop = DecodeLoop(dim=8, device=CPU)
    closer(loop)
    steps = trace_steps(loop)
    runs = [collect(loop, "same-prompt", 6) for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 6
    jloop = JLoop(dim=8)
    closer(jloop)
    assert_tokens_match(runs[0], row_trace(steps, seed_state("same-prompt", 8), 6), jloop)


def _mid_stream(make):
    loop = make(step_delay_s=0.01)
    toks_a, done_a = [], threading.Event()
    row_a = loop.admit("prompt-a", 200, lambda t, r: toks_a.append(t),
                       lambda r, ok: done_a.set())
    deadline = time.monotonic() + 10
    while loop.steps < 5 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert loop.steps >= 5
    toks_b, done_b = [], threading.Event()
    row_b = loop.admit("prompt-b", 5, lambda t, r: toks_b.append(t),
                       lambda r, ok: done_b.set())
    assert done_b.wait(10)
    shared = [u for _, u in list(loop.step_log) if row_a.uid in u and row_b.uid in u]
    row_a.cancel()
    assert done_a.wait(10)
    return (len(toks_b), row_b.admitted_step >= 5, len(shared) >= 5,
            loop.mid_stream_joins >= 1, loop.max_fused)


def test_row_admitted_mid_stream_shares_fused_steps(closer):
    """A row admitted at step k > 0 shares fused executions with the
    row admitted at step 0, in both packages."""
    def maker(cls, **base):
        def make(**kw):
            loop = cls(dim=8, **base, **kw)
            closer(loop)
            return loop
        return make

    assert _mid_stream(maker(DecodeLoop, device=CPU)) == _mid_stream(maker(JLoop)) \
        == (5, True, True, True, 2)


def test_cancel_frees_slot_within_one_step(closer):
    loop = DecodeLoop(dim=8, step_delay_s=0.005, device=CPU)
    closer(loop)
    done = threading.Event()
    row = loop.admit("cancel-me", 100000, lambda t, r: None, lambda r, ok: done.set())
    deadline = time.monotonic() + 10
    while loop.steps < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    cancel_step = loop.steps
    row.cancel("test cancel")
    assert done.wait(10), "cancelled row never finished"
    late = [(i, u) for i, u in list(loop.step_log) if row.uid in u and i > cancel_step + 1]
    assert not late, late
    assert loop.live_rows() == 0 and loop.rows_cancelled >= 1


def _emit_failure(loop):
    toks_bad, bad_done = [], threading.Event()

    def bad_emit(tok, row):
        toks_bad.append(tok)
        if len(toks_bad) >= 3:
            raise RuntimeError("sink exploded")

    toks_good, good_done = [], threading.Event()
    loop.admit("bad-row", 50, bad_emit, lambda r, ok: bad_done.set())
    loop.admit("good-row", 20, lambda t, r: toks_good.append(t),
               lambda r, ok: good_done.set())
    assert bad_done.wait(10) and good_done.wait(10)
    return len(toks_good), 3 <= len(toks_bad) <= 4, loop.rows_cancelled >= 1


def test_per_row_emit_failure_never_poisons_step_mates(closer):
    ploop, jloop = DecodeLoop(dim=8, device=CPU), JLoop(dim=8)
    closer(ploop)
    closer(jloop)
    assert _emit_failure(ploop) == _emit_failure(jloop) == (20, True, True)


def test_step_states_stay_device_resident_and_sums_are_the_one_pull(closer):
    """Row states are the step output's rows on the loop's device; the
    only manifested pull per step is decode.token-sums."""
    from incubator_brpc_tpu_torch.analysis.device_witness import transfer_counts

    loop = DecodeLoop(dim=8, device=CPU)
    closer(loop)
    before = transfer_counts()
    seen = []
    loop.admit("resident", 4, lambda t, r: seen.append(r.state), lambda r, ok: None)
    deadline = time.monotonic() + 10
    while len(seen) < 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(seen) == 4
    after = transfer_counts()
    assert after.get("decode.token-sums", 0) - before.get("decode.token-sums", 0) == 4
    assert all(isinstance(s, torch.Tensor) and s.shape == (8,) for s in seen)
    assert loop.steps == 4


# ---------------------------------------------------------------------------
# the Generate RPC (tests/test_streaming_generate.py:180-244)
# ---------------------------------------------------------------------------


class TokenSink(StreamHandler):
    def __init__(self):
        self.tokens, self.stamps = [], []
        self.closed = threading.Event()
        self.cv = threading.Condition()

    def on_received_messages(self, stream, messages):
        now = time.monotonic()
        with self.cv:
            for m in messages:
                self.tokens.append(m.to_bytes().decode())
                self.stamps.append(now)
            self.cv.notify_all()

    def on_closed(self, stream):
        self.closed.set()

    def wait_tokens(self, n, timeout=20):
        with self.cv:
            return self.cv.wait_for(lambda: len(self.tokens) >= n, timeout)


@pytest.fixture
def gen_server():
    svc = GenerateService(loop=DecodeLoop(dim=8, step_delay_s=0.005, device=CPU))
    srv = Server()
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=10000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    yield srv, svc, generate_stub(ch)
    ch.close()
    srv.stop()
    svc.close()


def _start_stream(stub, prompt, n_tokens):
    sink = TokenSink()
    c = Controller()
    stream = Stream.create(c, sink)
    r = stub.Generate(c, EchoRequest(message=prompt, code=n_tokens))
    assert not c.failed(), c.error_text()
    assert r.message == "streaming"
    assert stream.wait_established(5)
    return stream, sink


def test_streamed_generation_roundtrip(gen_server, closer):
    srv, svc, stub = gen_server
    steps = trace_steps(svc.loop)
    stream, sink = _start_stream(stub, "roundtrip", 10)
    assert sink.closed.wait(20), (sink.tokens, svc.loop.describe())
    assert len(sink.tokens) == 10
    assert sink.stamps[0] < sink.stamps[-1]  # progressive
    assert svc.streamed_rows == 1 and svc.unary_rows == 0
    jloop = JLoop(dim=8)
    closer(jloop)
    assert_tokens_match(sink.tokens, row_trace(steps, seed_state("roundtrip", 8), 10), jloop)


def test_unary_fallback_matches_streamed_tokens(gen_server, closer):
    srv, svc, stub = gen_server
    steps = trace_steps(svc.loop)
    stream, sink = _start_stream(stub, "both-paths", 6)
    assert sink.closed.wait(20)
    c = Controller()
    r = stub.Generate(c, EchoRequest(message="both-paths", code=6))
    assert not c.failed(), c.error_text()
    assert r.message.split(" ") == sink.tokens
    assert svc.unary_rows == 1
    jloop = JLoop(dim=8)
    closer(jloop)
    assert_tokens_match(sink.tokens, row_trace(steps, seed_state("both-paths", 8), 6), jloop)


def test_client_cancel_mid_stream_frees_slot(gen_server):
    srv, svc, stub = gen_server
    loop = svc.loop
    long_stream, long_sink = _start_stream(stub, "long", 100000)
    mate_stream, mate_sink = _start_stream(stub, "mate", 60)
    assert long_sink.wait_tokens(5)
    assert loop.live_rows() == 2
    long_stream.close()
    deadline = time.monotonic() + 10
    while loop.live_rows() > 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert loop.live_rows() == 1, "cancelled row still holds its slot"
    assert loop.rows_cancelled >= 1
    assert mate_sink.closed.wait(20)
    assert len(mate_sink.tokens) == 60


# ---------------------------------------------------------------------------
# the SSE fronts over HTTP (tests/test_streaming_generate.py:281-343,
# tests/test_serving.py:720-740), held to the JAX package's
# ---------------------------------------------------------------------------


def read_sse(stub_method, request):
    """One SSE call read progressively: (data events, arrival times)."""
    c = Controller()
    c.response_will_be_read_progressively()
    stub_method(c, request)
    assert not c.failed(), c.error_text()
    parts, stamps, end = [], [], threading.Event()

    def reader(part):
        if part is None:
            end.set()
        else:
            parts.append(part)
            stamps.append(time.monotonic())

    assert c.read_progressive_attachment(reader) == 0
    assert end.wait(20), "SSE stream never finished"
    body = b"".join(parts).decode()
    return [ln[6:] for ln in body.split("\n") if ln.startswith("data: ")], stamps


def jax_sse(make_service, method, request_kw):
    """The JAX package's SSE tokens: its own server, its http channel."""
    from incubator_brpc_tpu.client.channel import Channel as JChannel
    from incubator_brpc_tpu.client.channel import ChannelOptions as JOptions
    from incubator_brpc_tpu.client.controller import Controller as JController
    from incubator_brpc_tpu.protos.echo_pb2 import EchoRequest as JEchoRequest
    from incubator_brpc_tpu.server.server import Server as JServer
    from incubator_brpc_tpu.server.service import ServiceStub as JStub

    svc = make_service()
    srv = JServer()
    srv.add_service(svc)
    assert srv.start(0) == 0
    ch = JChannel(JOptions(protocol="http", timeout_ms=20000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        c = JController()
        c.response_will_be_read_progressively()
        getattr(JStub(ch, type(svc)), method)(c, JEchoRequest(**request_kw))
        assert not c.failed(), c.error_text()
        parts, end = [], threading.Event()
        c.read_progressive_attachment(lambda p: end.set() if p is None else parts.append(p))
        assert end.wait(20)
        body = b"".join(parts).decode()
        return [ln[6:] for ln in body.split("\n") if ln.startswith("data: ")]
    finally:
        ch.close()
        srv.stop()
        svc.close()


@pytest.mark.parametrize("prompt,n", [("sse", 6), ("wire", 3), ("mate", 60)])
def test_generate_sse_tokens_match_jax(prompt, n, closer):
    """GenerateSSE over Channel(protocol="http"): progressive arrivals,
    ``[DONE]`` last, and the tokens of the JAX package's GenerateSSE
    under assert_tokens_match's rule."""
    gen = GenerateService(loop=DecodeLoop(dim=8, step_delay_s=0.005, device=CPU))
    closer(gen)
    steps = trace_steps(gen.loop)
    srv = Server()
    srv.add_service(gen)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=20000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        events, stamps = read_sse(generate_stub(ch).GenerateSSE,
                                  EchoRequest(message=prompt, code=n))
    finally:
        ch.close()
        srv.stop()
    assert events[-1] == "[DONE]" and len(events) == n + 1
    assert stamps[-1] - stamps[0] > 0.005  # progressive, not one buffered blob
    assert gen.sse_rows == 1 and gen.streamed_rows == gen.unary_rows == 0
    jt = jax_sse(lambda: JGenerateService(loop=JLoop(dim=8)), "GenerateSSE",
                 {"message": prompt, "code": n})
    assert jt[-1] == "[DONE]"
    jloop = JLoop(dim=8)
    closer(jloop)
    assert_tokens_match(events[:-1], row_trace(steps, seed_state(prompt, 8), n), jloop,
                        jt[:-1], JAX_RUN_DIFFERS.get((8, prompt), ()))


def test_generate_sse_wire_content_type(closer):
    gen = GenerateService(loop=DecodeLoop(dim=8, device=CPU))
    closer(gen)
    srv = Server()
    srv.add_service(gen)
    assert srv.start(0) == 0
    try:
        import socket as pysock

        body = b'{"message":"wire","code":3}'
        s = pysock.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.sendall(b"POST /GenerateService/GenerateSSE HTTP/1.1\r\nHost: x\r\n"
                  b"Content-Length: %d\r\n\r\n" % len(body) + body)
        s.settimeout(10)
        data = b""
        while b"0\r\n\r\n" not in data:
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
        s.close()
    finally:
        srv.stop()
    head, _, rest = data.partition(b"\r\n\r\n")
    assert b"200" in head.split(b"\r\n")[0]
    assert b"text/event-stream" in head.lower()
    assert b"transfer-encoding: chunked" in head.lower()
    assert rest.count(b"data: ") == 4  # 3 tokens + [DONE]


class _FakeAttachment:
    """A progressive attachment whose unsent backlog the test sets."""

    def __init__(self, backlog):
        self.backlog, self.parts, self.closed = backlog, [], threading.Event()

    def backlog_bytes(self):
        return self.backlog

    def write(self, part):
        self.parts.append(part)
        return 0

    def close(self):
        self.closed.set()


def test_sse_backlog_cap_cancels_only_the_slow_row(closer):
    """A reader past the backlog cap (max(64, outbox_max_tokens) x 64
    bytes) loses its row at the next step, without [DONE]; the row that
    shares its steps runs to the end, and its events carry the host
    token strings the loop emits."""
    gen = GenerateService(loop=DecodeLoop(dim=8, step_delay_s=0.002, device=CPU),
                          outbox_max_tokens=64)
    closer(gen)
    steps = trace_steps(gen.loop)
    slow, fast = _FakeAttachment(64 * 64 + 1), _FakeAttachment(64 * 64)
    with gen.loop._cv:  # both rows join the first step's window
        for pa, prompt in ((slow, "slow reader"), (fast, "fast reader")):
            c = Controller()
            c.create_progressive_attachment = lambda content_type=None, pa=pa: pa
            gen.GenerateSSE(c, EchoRequest(message=prompt, code=20), None, lambda: None)
    assert slow.closed.wait(10) and fast.closed.wait(10)
    assert slow.parts == [] and gen.loop.rows_cancelled >= 1
    assert fast.parts[-1] == "data: [DONE]\n\n" and len(fast.parts) == 21
    jloop = JLoop(dim=8)
    closer(jloop)
    assert_tokens_match([p[6:-2] for p in fast.parts[:-1]],
                        row_trace(steps, seed_state("fast reader", 8), 20), jloop)


def test_admit_sse_tokens_match_jax(closer):
    """AdmitSSE behind a prefilled session: ``<idx> <token>`` events in
    order, ``[DONE]`` last, prefill run once, and the tokens of the JAX
    package's AdmitSSE on the same session under assert_tokens_match's
    rule (layer 0 of the KV stack is the prompt's seed state)."""
    n, prompt = 5, "sse prompt"
    req = {"session": "sse-s", "kv_epoch": 0, "n_layers": 2, "max_tokens": n}
    store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=CPU)
    pf = PrefillService(store, dim=DIM, n_layers=2, device=CPU)
    pf.prefill_sessions([("sse-s", prompt)])
    dec = DecodeService(store, DecodeLoop(dim=DIM, device=CPU), name="sse-d0")
    closer(dec)
    steps = trace_steps(dec.loop)
    srv = Server()
    srv.add_service(dec)
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(protocol="http", timeout_ms=20000))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    try:
        events, _ = read_sse(decode_stub(ch).AdmitSSE, EchoRequest(message=json.dumps(req)))
    finally:
        ch.close()
        srv.stop()
    assert events[-1] == "[DONE]" and len(events) == n + 1
    assert [e.split()[0] for e in events[:-1]] == [str(i) for i in range(n)]
    assert pf.prefill_executions["sse-s"] == 1 and dec.sse_rows == 1

    def jax_decode():
        jstore = JStore(hbm_budget_bytes=1 << 24)
        JPrefill(jstore, dim=DIM, n_layers=2).prefill_sessions([("sse-s", prompt)])
        return JDecodeService(jstore, JLoop(dim=DIM), name="sse-d0")

    jt = jax_sse(jax_decode, "AdmitSSE", {"message": json.dumps(req)})
    assert jt[-1] == "[DONE]" and [e.split()[0] for e in jt[:-1]] == [str(i) for i in range(n)]
    jloop = JLoop(dim=DIM)
    closer(jloop)
    assert_tokens_match([e.split()[1] for e in events[:-1]],
                        row_trace(steps, seed_state(prompt, DIM), n), jloop,
                        [e.split()[1] for e in jt[:-1]])


# ---------------------------------------------------------------------------
# disaggregated serving (tests/test_serving.py)
# ---------------------------------------------------------------------------


def _tier(closer, n_replicas=2, n_layers=3, step_delay_s=0.0, max_sessions=32):
    store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=CPU)
    pf = PrefillService(store, dim=DIM, n_layers=n_layers, device=CPU)
    reps = [
        DecodeService(store, DecodeLoop(dim=DIM, step_delay_s=step_delay_s, device=CPU),
                      name=f"d{i}", max_sessions=max_sessions)
        for i in range(n_replicas)
    ]
    for r in reps:
        closer(r)
    return store, pf, reps, SessionChannel(pf, reps)


def mono_tokens(closer, prompt, n):
    loop = DecodeLoop(dim=DIM, device=CPU)
    closer(loop)
    return collect(loop, prompt, n)


def test_disagg_tokens_match_monolithic_generate(closer):
    """Prefill → cache → decode emits exactly the monolithic loop's
    tokens (layer 0 of the KV stack is the decode state), and both
    match the JAX package's."""
    store, pf, reps, ch = _tier(closer)
    traced = [trace_steps(r.loop) for r in reps]
    ref = mono_tokens(closer, "hello disagg", 10)
    res = ch.generate("s-eq", "hello disagg", 10)
    assert res.tokens == ref
    assert res.prefill_executions == 1 and res.migrations == 0
    assert sv_session.get_session("s-eq").state == sv_session.DONE
    assert ("s-eq", 0, 0) in [parse_kv_key(k) for k in store.keys()]
    jloop = JLoop(dim=DIM)
    closer(jloop)
    trace = row_trace(next(s for s in traced if s), seed_state("hello disagg", DIM), 10)
    assert_tokens_match(res.tokens, trace, jloop)
    # the JAX tier on the same prompt agrees too
    jstore = JStore(hbm_budget_bytes=1 << 24)
    jreps = [JDecodeService(jstore, JLoop(dim=DIM), name=f"j{i}") for i in range(2)]
    for r in jreps:
        closer(r)
    jres = JSessionChannel(JPrefill(jstore, dim=DIM, n_layers=3), jreps).generate(
        "s-eq", "hello disagg", 10)
    assert_tokens_match(res.tokens, trace, jloop, jres.tokens)


def test_prefill_window_is_one_batched_execution_held_to_jax():
    """Five sessions pad to ONE bucketed execution; every layer lands
    in the store; layer 0 is bit-identical to the decode seed state and
    the upper layers are within the state tolerance of JAX's stack."""
    store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=CPU)
    pf = PrefillService(store, dim=DIM, n_layers=4, device=CPU)
    jstore = JStore(hbm_budget_bytes=1 << 24)
    jpf = JPrefill(jstore, dim=DIM, n_layers=4)
    reqs = [(f"w{i}", f"prompt {i}") for i in range(5)]
    traces0 = pf._kernel.trace_count()
    out = pf.prefill_sessions(reqs)
    jpf.prefill_sessions(reqs)
    assert pf.batches == 1 and pf.sessions_prefilled == 5
    assert pf._kernel.trace_count() - traces0 == 1  # one (bucket 8) signature
    assert set(out) == {f"w{i}" for i in range(5)}
    assert out["w0"]["kv_bytes"] == 4 * DIM * 4
    w = np.abs(jpf._w.astype(np.float64))
    for sid, prompt in reqs:
        assert np.array_equal(prompt_seed_state(prompt, DIM), seed_state(prompt, DIM))
        keys = kv_layer_keys(sid, 0, 4)
        layers = [store.get(k) for k in keys]
        assert all(v is not None and v.untyped_storage().nbytes() == DIM * 4
                   for v in layers)  # compact copies, not views of the stack
        assert np.array_equal(layers[0].numpy(), seed_state(prompt, DIM))
        for layer in range(1, 4):
            jl = np.asarray(jstore.get(keys[layer]))
            s_in = np.asarray(jstore.get(keys[layer - 1])).astype(np.float64)
            bound = RTOL * (np.abs(s_in) @ w) + ATOL
            # errors of earlier layers carry: allow one bound per layer
            assert np.all(np.abs(layers[layer].numpy() - jl) <= layer * bound)


@pytest.mark.parametrize("n_sessions", [1, 5])
def test_sharded_prefill_on_a_mesh_held_to_jax(n_sessions):
    """PrefillService(mesh=) on a (1, 4) mesh in both packages: the
    layer products run through the sharded kernel (one execution and
    one merge per layer, W row-sharded over the chips), each session is
    prefilled once, layer 0 is the seed state bit for bit, and the upper
    layers are within the state tolerance of the JAX service's."""
    import jax

    from incubator_brpc_tpu.parallel.mesh import create_mesh as j_create_mesh
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    n_layers = 4
    store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=CPU)
    pf = PrefillService(store, dim=DIM, n_layers=n_layers,
                        mesh=create_mesh((1, 4), devices=[CPU] * 4))
    jstore = JStore(hbm_budget_bytes=1 << 24)
    jpf = JPrefill(jstore, dim=DIM, n_layers=n_layers,
                   mesh=j_create_mesh((1, 4), devices=jax.devices("cpu")[:4]))
    assert [tuple(s.shape) for s in pf._w_dev.shards] == [(DIM // 4, DIM)] * 4
    pf.prewarm()  # returns early on a mesh, as the JAX service's does
    reqs = [(f"m{i}", f"mesh prompt {i}") for i in range(n_sessions)]
    out = pf.prefill_sessions(reqs)
    jout = jpf.prefill_sessions(reqs)
    assert pf.batches == jpf.batches == 1
    assert {k: v["prefill_executions"] for k, v in out.items()} == \
        {k: v["prefill_executions"] for k, v in jout.items()} == {s: 1 for s, _ in reqs}
    assert pf._sharded.executions == pf._sharded.collective_merges == n_layers - 1
    assert jpf._sharded.executions == n_layers - 1
    w = np.abs(jpf._w.astype(np.float64))
    for sid, prompt in reqs:
        keys = kv_layer_keys(sid, 0, n_layers)
        layers = [store.get(k) for k in keys]
        assert np.array_equal(layers[0].numpy(), seed_state(prompt, DIM))
        for layer in range(1, n_layers):
            jl = np.asarray(jstore.get(keys[layer]))
            s_in = np.asarray(jstore.get(keys[layer - 1])).astype(np.float64)
            bound = RTOL * (np.abs(s_in) @ w) + ATOL
            assert np.all(np.abs(layers[layer].numpy() - jl) <= layer * bound)


def test_decode_pull_is_fused_dmget(closer):
    store, pf, reps, ch = _tier(closer, n_layers=3)
    t0 = p_store_mod._mget_gather.trace_count()
    ch.generate("s-dmget", "fused pull", 4)
    d = next(r for r in reps if r.kv_pulls)
    assert d.kv_pulls == d.fused_pulls == 1, "multi-layer pull missed the fused gather"
    assert p_store_mod._mget_gather.trace_count() - t0 <= 1


def test_step_log_prefill_exactly_once_across_two_migrations(closer):
    """Decode hops across >= 2 replicas (one graceful handoff, one
    crash) while prefill runs exactly once, the emitted indices stay
    contiguous with no dup/gap, and the tokens are the unmigrated
    sequence."""
    store, pf, reps, ch = _tier(closer, n_replicas=3, step_delay_s=0.01)
    got, seen = {}, []
    t = threading.Thread(target=lambda: got.setdefault(
        "res", ch.generate("s-mig", "migrate me", 60, lambda i, tok: seen.append(i))))
    t.start()
    rec = sv_session.get_session
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        r = rec("s-mig")
        if r is not None and len(r.tokens) >= 5:
            break
        time.sleep(0.01)
    assert ch.migrate("s-mig", "drain for test") is True
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        r = rec("s-mig")
        if r.migrations >= 1 and len(r.tokens) >= r.ckpt_tokens + 5:
            break
        time.sleep(0.01)
    # the checkpoint stored the live state as a compact copy
    layer0 = store.get(kv_layer_keys("s-mig", rec("s-mig").kv_epoch, 3)[0])
    assert layer0 is not None and layer0.untyped_storage().nbytes() == DIM * 4
    {d.name: d for d in reps}[rec("s-mig").replica].kill()  # crash hop
    t.join(30)
    assert not t.is_alive()
    res = got["res"]
    assert len(res.tokens) == 60 and res.migrations >= 2
    assert res.prefill_executions == 1 and pf.prefill_executions["s-mig"] == 1
    assert seen == list(range(60))
    kinds = [e["kind"] for e in res.record.migration_log]
    assert "graceful" in kinds and "crash" in kinds
    assert len({e["from"] for e in res.record.migration_log}) >= 2
    assert res.tokens == mono_tokens(closer, "migrate me", 60)


def test_overloaded_replica_sheds_and_router_hops(closer):
    store, pf, reps, ch = _tier(closer, n_replicas=2)
    reps[0].overloaded = True
    res = ch.generate("s-shed", "overflow", 6)
    assert len(res.tokens) == 6
    assert reps[0].shed_sessions + reps[1].shed_sessions >= 1
    assert sv_session.get_session("s-shed").replica == reps[1].name
    with pytest.raises(AdmitError) as ei:
        reps[0].admit_session("direct", 0, 1, 1)
    assert ei.value.code == errors.EOVERCROWDED
    assert res.tokens == mono_tokens(closer, "overflow", 6)


def test_kv_ship_drop_is_erpc_never_silent_and_epoch_complete_or_absent(closer):
    store, pf, reps, ch = _tier(closer, n_layers=3)
    injector.arm(FaultPlan(
        [FaultSpec("kv.ship", "drop", match={"method": "kv:s-drop@0#1"})],
        seed=7, name="kv-ship-drop"))
    with pytest.raises(SessionError) as ei:
        ch.generate("s-drop", "doomed prefill", 4)
    injector.disarm()
    assert ei.value.code == errors.EINTERNAL
    assert "kv.ship dropped" in str(ei.value)
    assert all(store.get(k) is None for k in kv_layer_keys("s-drop", 0, 3))
    assert pf.ship_failures == 1
    assert len(ch.generate("s-after", "healthy again", 4).tokens) == 4


class _FrameSink(StreamHandler):
    def __init__(self):
        self.frames, self.failures = [], []
        self.closed = threading.Event()

    def on_received_messages(self, stream, messages):
        self.frames.extend(m.to_bytes().decode() for m in messages)

    def on_closed(self, stream):
        self.closed.set()

    def on_failed(self, stream, code, text):
        self.failures.append((code, text))
        self.closed.set()


def test_prefill_and_streamed_admit_over_rpc(closer):
    """Prefill RPC ships KV, the streamed Admit RPC pulls it and streams
    ``<idx> <token>`` frames after the response settles."""
    store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=CPU)
    pf = PrefillService(store, dim=DIM, n_layers=2, device=CPU)
    dec = DecodeService(store, DecodeLoop(dim=DIM, device=CPU), name="rpc-d0")
    closer(dec)
    steps = trace_steps(dec.loop)
    servers, channels = [], []
    try:
        for svc in (pf, dec):
            srv = Server()
            srv.add_service(svc)
            assert srv.start(0) == 0
            servers.append(srv)
            ch = Channel(ChannelOptions(timeout_ms=10000))
            assert ch.init(f"127.0.0.1:{srv.port}") == 0
            channels.append(ch)
        c = Controller()
        r = prefill_stub(channels[0]).Prefill(c, EchoRequest(message=json.dumps(
            {"session": "rpc-s", "prompt": "over the wire"})))
        assert not c.failed(), c.error_text()
        out = json.loads(r.message)
        assert out["n_layers"] == 2 and out["prefill_executions"] == 1
        sink, c2 = _FrameSink(), Controller()
        stream = Stream.create(c2, sink)
        r2 = decode_stub(channels[1]).Admit(c2, EchoRequest(message=json.dumps(
            {"session": "rpc-s", "kv_epoch": 0, "n_layers": 2, "max_tokens": 6})))
        assert not c2.failed(), c2.error_text()
        assert r2.message == "streaming"
        assert stream.wait_established(5) and sink.closed.wait(20)
        assert sink.failures == []
        assert [f.split()[0] for f in sink.frames] == [str(i) for i in range(6)]
        toks = [f.split()[1] for f in sink.frames]
        assert toks == mono_tokens(closer, "over the wire", 6)
        assert dec.streamed_rows == 1 and dec.unary_rows == 0
        jloop = JLoop(dim=DIM)
        closer(jloop)
        assert_tokens_match(toks, row_trace(steps, seed_state("over the wire", DIM), 6), jloop)
    finally:
        for ch in channels:
            ch.close()
        for srv in servers:
            srv.stop()


def test_jax_kv_stack_carried_across_gives_the_same_tokens(closer):
    """A session prefilled by the JAX package: its KV layers carried
    into a port store (convert.tensor_from_reference, as float32 and as
    the uint8 bytes a wire row arrives as) decode in the port to the
    tokens the JAX decode emits from the same KV."""
    jstore = JStore(hbm_budget_bytes=1 << 24)
    JPrefill(jstore, dim=DIM, n_layers=3).prefill_sessions([("x", "carried prompt")])
    jdec = JDecodeService(jstore, JLoop(dim=DIM), name="jx")
    closer(jdec)
    jt, jdone = [], threading.Event()
    jdec.admit_session("x", 0, 3, 8, emit=lambda i, t: jt.append(t),
                       on_finish=lambda ok: jdone.set())
    assert jdone.wait(30)
    for as_bytes in (False, True):
        store = HBMCacheStore(hbm_budget_bytes=1 << 24, device=CPU)
        for k in kv_layer_keys("x", 0, 3):
            arr = np.asarray(jstore.get(k))
            store.set(k, convert.tensor_from_reference(
                arr.view(np.uint8) if as_bytes else arr, CPU))
        dec = DecodeService(store, DecodeLoop(dim=DIM, device=CPU), name="px")
        closer(dec)
        steps = trace_steps(dec.loop)
        pt, pdone = [], threading.Event()
        entry = dec.admit_session("x", 0, 3, 8, emit=lambda i, t: pt.append(t),
                                  on_finish=lambda ok: pdone.set())
        assert pdone.wait(30)
        assert entry.layers[0].dtype == torch.float32
        assert np.array_equal(entry.layers[0].numpy(), seed_state("carried prompt", DIM))
        jloop = JLoop(dim=DIM)
        closer(jloop)
        trace = row_trace(steps, seed_state("carried prompt", DIM), 8)
        assert_tokens_match(pt, trace, jloop, jt)


def test_uint8_kv_row_bitcasts_on_the_device():
    """A uint8 wire row becomes the float32 state by a view of the same
    memory (no host round trip); a float32 row passes through."""
    s = seed_state("bitcast", DIM)
    raw = torch.from_numpy(s.view(np.uint8).copy())
    st = _as_state(raw, DIM, CPU)
    assert st.dtype == torch.float32 and st.shape == (DIM,)
    assert st.data_ptr() == raw.data_ptr()
    assert np.array_equal(st.numpy(), s)
    f = torch.from_numpy(s)
    assert _as_state(f, DIM, CPU) is f
    assert np.array_equal(_as_state(s.tobytes(), DIM, CPU).numpy(), s)


# ---------------------------------------------------------------------------
# what is not ported, and no silent CPU default
# ---------------------------------------------------------------------------


def test_unported_fronts_raise_naming_their_item(closer):
    """The SSE fronts are ported: called directly, each switches its
    response to a text/event-stream progressive attachment (a bad admit
    request fails EREQUEST first).  The sharded prefill is ported too:
    with a mesh its layer products run through the sharded kernel."""
    gen = GenerateService(loop=DecodeLoop(dim=8, device=CPU))
    closer(gen)
    c, done = Controller(), threading.Event()
    gen.GenerateSSE(c, EchoRequest(message="x", code=2), None, done.set)
    assert done.is_set() and not c.failed() and gen.sse_rows == 1
    assert c._progressive_attachment.content_type == "text/event-stream"
    store = HBMCacheStore(1 << 20, device=CPU)
    dec = DecodeService(store, name="u", dim=8, device=CPU)
    closer(dec)
    c, done = Controller(), threading.Event()
    dec.AdmitSSE(c, EchoRequest(message="{}"), None, done.set)
    assert done.is_set() and c.error_code == errors.EREQUEST and dec.sse_rows == 0
    c, done = Controller(), threading.Event()
    dec.AdmitSSE(c, EchoRequest(message=json.dumps(
        {"session": "absent", "kv_epoch": 0, "n_layers": 2, "max_tokens": 2})), None, done.set)
    assert done.is_set() and c.failed() and dec.sse_rows == 1
    assert c._progressive_attachment.content_type == "text/event-stream"
    from incubator_brpc_tpu_torch.parallel.mesh import create_mesh

    pf = PrefillService(store, dim=8, mesh=create_mesh((1, 2), devices=[CPU] * 2))
    assert pf.device == CPU and pf._sharded is not None
    assert [tuple(s.shape) for s in pf._w_dev.shards] == [(4, 8)] * 2
    assert pf.prefill_sessions([("m", "mesh")])["m"]["prefill_executions"] == 1
    assert pf._sharded.executions == pf._sharded.collective_merges == 3


def test_entry_points_without_a_device_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = HBMCacheStore(1 << 20, device=CPU)
    for make in (DecodeLoop, lambda: PrefillService(store),
                 lambda: DecodeService(store), lambda: GenerateService()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
