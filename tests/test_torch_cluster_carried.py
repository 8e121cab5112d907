"""Cluster tests: multiple in-process servers + naming services — the
reference's distribution test pattern (SURVEY.md §4: file NS as cluster
simulator, no real multi-machine).

Carried by hand from ``tests/test_cluster.py``.  Besides the package name,
the tpu:// topology case gives its server ports and channel the device the
case runs on (the CPU, or the card).
"""

import collections
import itertools
import threading
import time

import pytest

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server

from torch_carry import torch_device  # noqa: F401  (fixture)


class TaggedEcho(EchoService):
    """Echo that reports which server answered."""

    SERVICE_NAME = "EchoService"

    def __init__(self, tag):
        super().__init__()
        self.tag = tag

    def Echo(self, controller, request, response, done):
        response.message = self.tag
        response.code = request.code
        # sleep only when this server is named in the request message
        # ("slow:<tag>") or unconditionally via sleep_us with no name —
        # lets tests make exactly one cluster member slow
        if request.sleep_us and (
            not request.message.startswith("slow:")
            or request.message == f"slow:{self.tag}"
        ):
            time.sleep(request.sleep_us / 1e6)
        done()


@pytest.fixture
def cluster():
    servers = []
    for i in range(3):
        srv = Server()
        srv.add_service(TaggedEcho(f"s{i}"))
        assert srv.start(0) == 0
        servers.append(srv)
    yield servers
    for s in servers:
        s.stop()


_group_seq = itertools.count(1)


def fresh_options(**kw):
    """Unique connection_group per test: recycled OS ports must not hit
    another test's half-dead shared sockets in the global SocketMap."""
    kw.setdefault("timeout_ms", 3000)
    return ChannelOptions(connection_group=f"t{next(_group_seq)}", **kw)


def warm_until_all(stub, want=("s0", "s1", "s2"), deadline_s=5.0):
    """Call until every server has answered once — drains NS-propagation
    and connection-establishment races before an exact-count window.
    Safe for rr/wrr exactness: both select from a deterministic cyclic
    sequence, so any later window of a whole number of cycles is exact."""
    seen = set()
    end = time.monotonic() + deadline_s
    while seen < set(want) and time.monotonic() < end:
        c = Controller()
        r = stub.Echo(c, EchoRequest())
        if not c.failed():
            seen.add(r.message)
    assert seen == set(want), seen


def call_tags(stub, n, **req_kw):
    tags = collections.Counter()
    for _ in range(n):
        c = Controller()
        r = stub.Echo(c, EchoRequest(**req_kw))
        assert not c.failed(), c.error_text()
        tags[r.message] += 1
    return tags


def test_list_ns_round_robin(cluster):
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in cluster)
    ch = Channel(fresh_options())
    assert ch.init(url, "rr") == 0
    stub = echo_stub(ch)
    warm_until_all(stub)
    tags = call_tags(stub, 30)
    assert set(tags) == {"s0", "s1", "s2"}
    assert all(c == 10 for c in tags.values()), tags  # perfect rr


def test_list_ns_weighted(cluster):
    url = "list://" + ",".join(
        f"127.0.0.1:{s.port} {w}" for s, w in zip(cluster, [4, 1, 1])
    )
    ch = Channel(fresh_options())
    assert ch.init(url, "wrr") == 0
    stub = echo_stub(ch)
    warm_until_all(stub)
    tags = call_tags(stub, 60)
    assert tags["s0"] == 40 and tags["s1"] == 10 and tags["s2"] == 10, tags


def test_random_lb(cluster):
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in cluster)
    ch = Channel(fresh_options())
    assert ch.init(url, "random") == 0
    tags = call_tags(echo_stub(ch), 60)
    assert set(tags) == {"s0", "s1", "s2"}


def test_consistent_hashing_sticky(cluster):
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in cluster)
    ch = Channel(fresh_options())
    assert ch.init(url, "c_murmurhash") == 0
    stub = echo_stub(ch)

    def tag_for(code):
        c = Controller()
        c.log_id = code  # request_code channel
        r = stub.Echo(c, EchoRequest(message="k"))
        assert not c.failed()
        return r.message

    # request_code IS the ring position (reference semantics: callers
    # set a well-distributed code, e.g. a hash of their key)
    from incubator_brpc_tpu_torch.utils.hashes import murmur3_32

    codes = [murmur3_32(f"key{i}".encode()) for i in range(40)]
    # warm up: flush any stale shared sockets left by earlier tests on
    # recycled ports (first attempts may retry onto a different node)
    for code in codes[:3]:
        tag_for(code)
    # same key → same server, every time
    for code in codes[:3]:
        tags = {tag_for(code) for _ in range(8)}
        assert len(tags) == 1, tags
    # well-distributed keys spread over multiple servers
    spread = {tag_for(code) for code in codes}
    assert len(spread) >= 2


def test_locality_aware_prefers_fast(cluster):
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in cluster)
    ch = Channel(fresh_options())
    assert ch.init(url, "la") == 0
    stub = echo_stub(ch)
    # every call makes s0 sleep 15ms while s1/s2 answer immediately;
    # after the learning phase the la balancer must starve s0
    tags = collections.Counter()
    for _ in range(40):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="slow:s0", sleep_us=15000))
        assert not c.failed(), c.error_text()
        tags[r.message] += 1
    learn_s0 = tags["s0"]
    tags2 = collections.Counter()
    for _ in range(60):
        c = Controller()
        r = stub.Echo(c, EchoRequest(message="slow:s0", sleep_us=15000))
        assert not c.failed(), c.error_text()
        tags2[r.message] += 1
    # slow server gets a clear minority once latencies are learned
    assert tags2["s0"] < 60 * 0.25, (learn_s0, tags2)
    assert tags2["s1"] + tags2["s2"] > 60 * 0.7, tags2


def test_file_ns_watches_changes(cluster, tmp_path):
    f = tmp_path / "servers"
    f.write_text(f"127.0.0.1:{cluster[0].port}\n")
    ch = Channel(fresh_options())
    assert ch.init(f"file://{f}", "rr") == 0
    stub = echo_stub(ch)
    time.sleep(0.2)
    tags = call_tags(stub, 6)
    assert set(tags) == {"s0"}
    # add the other two servers; the watcher must pick them up
    f.write_text("".join(f"127.0.0.1:{s.port}\n" for s in cluster))
    deadline = time.monotonic() + 8.0
    tags = []
    while time.monotonic() < deadline:
        tags = call_tags(stub, 30)
        if set(tags) == {"s0", "s1", "s2"}:
            break
        time.sleep(0.3)
    assert set(tags) == {"s0", "s1", "s2"}, tags


def test_dead_server_isolated_and_revived(cluster):
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in cluster)
    ch = Channel(fresh_options(max_retry=3))
    assert ch.init(url, "rr") == 0
    stub = echo_stub(ch)
    call_tags(stub, 6)
    # kill s1
    port1 = cluster[1].port
    cluster[1].stop()
    time.sleep(0.1)
    # calls keep succeeding (retry + breaker route around the corpse)
    tags = call_tags(stub, 30)
    assert tags["s0"] + tags["s2"] >= 28, tags
    # breaker should now be isolating s1: a fresh burst avoids it entirely
    tags = call_tags(stub, 20)
    assert tags.get("s1", 0) == 0, tags
    # resurrect on the same port; health check revives it
    srv = Server()
    srv.add_service(TaggedEcho("s1b"))
    assert srv.start(port1) == 0
    try:
        deadline = time.monotonic() + 10
        seen = set()
        while time.monotonic() < deadline:
            tags = call_tags(stub, 12)
            seen |= set(tags)
            if "s1b" in seen:
                break
            time.sleep(0.5)
        assert "s1b" in seen, seen
    finally:
        srv.stop()


def test_backup_request_hedges_slow_server(cluster):
    url = "list://" + ",".join(f"127.0.0.1:{s.port}" for s in cluster)
    ch = Channel(fresh_options(backup_request_ms=100))
    assert ch.init(url, "rr") == 0
    stub = echo_stub(ch)
    # only s0 sleeps; rr starts at s0, so the first attempt is slow and
    # the backup request (fired after 100ms) lands on a fast server
    t0 = time.monotonic()
    c = Controller()
    r = stub.Echo(c, EchoRequest(message="slow:s0", sleep_us=2_000_000, code=1))
    elapsed = time.monotonic() - t0
    assert not c.failed(), c.error_text()
    assert elapsed < 1.5, f"backup request did not hedge: {elapsed:.2f}s"
    assert r.message in ("s1", "s2"), r.message


def test_tpu_topology_ns(torch_device):
    servers = []
    for chip in (70, 71):
        srv = Server()
        srv.add_service(TaggedEcho(f"chip{chip}"))
        assert srv.start_ici(3, chip, device=torch_device) == 0
        servers.append(srv)
    try:
        opts = fresh_options()
        opts.ici_device = torch_device
        ch = Channel(opts)
        assert ch.init("tpu://fabric", "rr") == 0
        stub = echo_stub(ch)
        # poll until the topology NS has seen both chips (a fixed sleep
        # is flaky when the suite loads the single core)
        deadline = time.monotonic() + 10
        tags = set()
        while time.monotonic() < deadline:
            time.sleep(0.3)
            try:
                tags = set(call_tags(stub, 12))
            except AssertionError:
                continue
            if {"chip70", "chip71"} <= tags:
                break
        assert {"chip70", "chip71"} <= tags, tags
    finally:
        for s in servers:
            s.stop()
