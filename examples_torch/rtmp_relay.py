"""RTMP publish/play relay (reference example/rtmp_c++ analog):
a publisher pushes frames, a subscriber plays them back — one
in-process server relays.

    python examples_torch/rtmp_relay.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import threading
import time

from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.protocols.rtmp import MSG_VIDEO, RtmpClient
from incubator_brpc_tpu_torch.server.server import Server

if __name__ == "__main__":
    srv = Server()
    srv.add_service(EchoService())
    assert srv.start(0) == 0
    got = threading.Event()

    def on_media(msg):
        print(f"subscriber got type={msg.type_id} ts={msg.timestamp} {len(msg.payload)}B")
        got.set()

    sub = RtmpClient("127.0.0.1", srv.port, app="live", on_media=on_media)
    sub.play(sub.create_stream(), "demo")
    pub = RtmpClient("127.0.0.1", srv.port, app="live")
    sid = pub.create_stream()
    pub.publish(sid, "demo")
    pub.write_frame(sid, MSG_VIDEO, 0, b"\x17\x01" + b"frame-bytes" * 100)
    assert got.wait(5), "no media relayed"
    pub.close()
    sub.close()
    srv.stop()
