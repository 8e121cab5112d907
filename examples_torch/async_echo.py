"""Asynchronous echo (reference example/asynchronous_echo_c++): the
done-callback form of CallMethod — submit many RPCs without blocking,
handle each response in its completion callback.

    python examples_torch/async_echo.py
"""

import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

if __name__ == "__main__":
    srv = Server(ServerOptions(native_engine=True))
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    ch = Channel(ChannelOptions(timeout_ms=5000, connection_type="native"))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0
    stub = echo_stub(ch)

    N = 64
    done_count = [0]
    failures = [0]
    all_done = threading.Event()
    lock = threading.Lock()

    for i in range(N):
        c = Controller()

        def on_done(c=c, i=i):
            with lock:
                if c.failed():
                    failures[0] += 1
                done_count[0] += 1
                if done_count[0] == N:
                    all_done.set()

        # returns immediately: the response is handled by on_done on a
        # framework thread (reference: done=new MyDone on a bthread)
        stub.Echo(c, EchoRequest(message=f"async-{i}"), done=on_done)

    assert all_done.wait(30), "async completions missing"
    assert failures[0] == 0, f"{failures[0]} async RPCs failed"
    print(f"{N}/{N} async echoes completed via done callbacks")
    ch.close()
    srv.stop()
