"""The /batching builtin page, carried by hand from ``tests/test_batching.py``.

The PS behind the page is given the device the case runs on (the CPU, or
the card), as the port has no default device.  The JAX file's other cases
are held by ``tests/test_torch_batching.py``.
"""

from incubator_brpc_tpu_torch.models.parameter_server import PsService
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

from torch_carry import torch_device  # noqa: F401  (fixture)


def test_batching_page_get_post_and_status_surfacing(torch_device):
    import json
    import socket as _pysocket

    from incubator_brpc_tpu_torch.tools.rpc_view import fetch_page

    srv = Server(ServerOptions(enable_batching=True,
                               method_max_concurrency="auto"))
    srv.add_service(PsService(device=torch_device))
    assert srv.start(0) == 0
    try:
        state = json.loads(fetch_page(f"127.0.0.1:{srv.port}", "batching"))
        assert state["enabled"] is True
        get_state = state["methods"]["PsService.Get"]
        assert get_state["policy"]["max_batch_size"] == 32
        assert {"pending", "occupancy", "batches", "rows", "shed"} <= set(get_state)
        # POST tunes max_wait_us at runtime
        with _pysocket.create_connection(("127.0.0.1", srv.port), timeout=3) as s:
            s.sendall(
                b"POST /batching?method=PsService.Get&max_wait_us=123 "
                b"HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
                b"Connection: close\r\n\r\n"
            )
            data = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        assert b"200" in data.split(b"\r\n", 1)[0]
        assert srv.batcher("PsService.Get").policy.max_wait_us == 123
        # unknown method → 404
        with _pysocket.create_connection(("127.0.0.1", srv.port), timeout=3) as s:
            s.sendall(
                b"POST /batching?method=No.Such&max_wait_us=5 HTTP/1.1\r\n"
                b"Host: x\r\nContent-Length: 0\r\nConnection: close\r\n\r\n"
            )
            data = s.recv(65536)
        assert b"404" in data.split(b"\r\n", 1)[0]
        # /status surfaces the limiter's moving max_concurrency AND the
        # batcher's live queue depth per method
        status = fetch_page(f"127.0.0.1:{srv.port}", "status")
        assert "limiter=AutoConcurrencyLimiter max_concurrency=" in status
        assert "batching: queue_depth=" in status
    finally:
        srv.stop()
