"""Redis client (reference example/redis_c++): pipelined commands
through a Channel speaking the redis protocol against this framework's
own redis-serving Server (KVRedisService + the native engine's C KV).

    python examples_torch/redis_client.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
from incubator_brpc_tpu_torch.client.controller import Controller
from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.protocols import redis as R
from incubator_brpc_tpu_torch.protocols.redis import KVRedisService
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

if __name__ == "__main__":
    srv = Server(
        ServerOptions(native_engine=True, redis_service=KVRedisService())
    )
    srv.add_service(EchoService())
    assert srv.start(0) == 0

    ch = Channel(ChannelOptions(timeout_ms=5000, protocol="redis"))
    assert ch.init(f"127.0.0.1:{srv.port}") == 0

    # pipelined SET + GET + INCR in one round trip
    req = R.RedisRequest()
    req.add_command("SET", "greeting", "hello-tpu")
    req.add_command("GET", "greeting")
    req.add_command("INCR", "visits")
    resp = R.RedisResponse()
    c = Controller()
    ch.call_method(R.redis_method_spec(), c, req, resp)
    assert not c.failed(), c.error_text()
    assert resp.reply(0).value == "OK", resp.reply(0)
    assert resp.reply(1).value == b"hello-tpu"
    assert resp.reply(2).value == 1
    print(
        "redis pipeline: SET ->", resp.reply(0).value,
        "| GET ->", resp.reply(1).value.decode(),
        "| INCR ->", resp.reply(2).value,
    )
    ch.close()
    srv.stop()
