"""Cross-process ICI via the DCN bridge (reference analog: the RDMA
endpoint's TCP-assisted bootstrap, rdma_endpoint.h:93-108).

A REAL second process hosts the ici:// server; the client process
bridges to it over TCP, resolves it through the tpu:// naming service,
and runs echo RPCs whose payloads carry device segments.

Carried by hand from ``tests/test_dcn.py``: the child's server port, the
client's channel and the payloads live on the device the case runs on
(the CPU, or the card); payloads are tensors.  The cases
``tests/test_torch_dcn.py`` already holds are not repeated here.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

from torch_carry import torch_device  # noqa: F401  (fixture)

_SERVER_SCRIPT = r"""
import json, os, sys, time
import torch
sys.path.insert(0, os.environ["REPO_ROOT"])
from incubator_brpc_tpu_torch.parallel.dcn import listen_dcn
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.server.server import Server

srv = Server()
srv.add_service(EchoService())
assert srv.start_ici(0, 7, device=torch.device(os.environ["CARRY_DEVICE"])) == 0  # ici://slice0/chip7 in THIS process
port = listen_dcn(0, host="127.0.0.1")
print(json.dumps({"dcn_port": port}), flush=True)
# serve until the parent closes stdin
sys.stdin.read()
"""


@pytest.fixture
def remote_ici_server(torch_device):
    env = dict(os.environ)
    env["CARRY_DEVICE"] = str(torch_device)
    env["REPO_ROOT"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVER_SCRIPT],
        stdin=subprocess.PIPE,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        env=env,
        text=True,
    )
    line = proc.stdout.readline()
    try:
        info = json.loads(line)
    except ValueError:
        proc.kill()
        raise RuntimeError(f"server process failed: {line!r}\n{proc.stderr.read()}")
    yield info["dcn_port"]
    proc.stdin.close()
    try:
        proc.wait(5)
    except subprocess.TimeoutExpired:
        proc.kill()


def test_cross_process_device_payload(remote_ici_server, torch_device):
    import numpy as np
    import torch

    from incubator_brpc_tpu_torch.parallel.dcn import connect_dcn

    connect_dcn("127.0.0.1", remote_ici_server)
    ch = Channel(ChannelOptions(timeout_ms=60000, ici_device=torch_device))
    assert ch.init("ici://slice0/chip7") == 0
    stub = echo_stub(ch)
    # warmup WITH a device segment: the first device payload pays the
    # child's full lazy jax init (8-virtual-device CPU backend), which
    # can take tens of seconds when the whole suite loads this box —
    # front-load it here where only success matters, not latency
    w = Controller()
    w.request_attachment.append_device(torch.ones((8,), dtype=torch.float32, device=torch_device))
    stub.Echo(w, EchoRequest(message="warm"))
    payload = torch.arange(512, dtype=torch.float32, device=torch_device)
    c = Controller()
    c.request_attachment.append_device(payload)  # HBM segment on the wire
    r = stub.Echo(c, EchoRequest(message="dev"))
    assert not c.failed(), c.error_text()
    assert r.message == "dev"
    # echo service reflects the attachment; it crossed two process hops
    got = np.frombuffer(c.response_attachment.to_bytes(), dtype=np.float32)
    assert np.array_equal(got, np.arange(512, dtype=np.float32))
    ch.close()
