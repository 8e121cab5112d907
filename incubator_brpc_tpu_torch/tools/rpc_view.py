"""rpc_view — fetch / proxy another server's builtin pages.

Analog of reference tools/rpc_view (rpc_view.cpp): the reference runs
its own brpc server whose pages PROXY a target server, so an operator
browses `http://rpc_view_host:port/...` and sees the target's
observability surface (useful when the target's port is reachable only
from the bastion running rpc_view).  Same shape here — ``serve()``
starts one of this framework's servers whose builtin paths forward to
the target — plus the one-shot ``fetch_page`` CLI mode.

    python -m incubator_brpc_tpu_torch.tools.rpc_view --server host:port [--page status]
    python -m incubator_brpc_tpu_torch.tools.rpc_view --server host:port --port 8888  # proxy mode
"""

from __future__ import annotations

import argparse
import socket as _pysocket
from typing import Tuple

# pages the proxy mirrors (the reference forwards the same builtin set)
PROXY_PAGES = (
    "/", "/index", "/status", "/vars", "/metrics", "/flags",
    "/connections", "/rpcz", "/health", "/version", "/list", "/threads",
    "/bthreads", "/ids", "/sockets", "/protobufs", "/dir",
    "/hotspots/cpu", "/hotspots/contention", "/hotspots/heap",
    "/hotspots/growth", "/pprof/profile", "/vlog",
    "/rpcz/export", "/cluster/export", "/cluster/metrics",
    "/cluster/latency_breakdown", "/cluster/stragglers", "/rpc_dump",
)


def fetch_page_full(
    server: str, page: str = "status", timeout: float = 3.0, retries: int = 5
) -> Tuple[int, str, bytes]:
    """GET one page → (status, content_type, body_bytes).  A raw fetch
    can race the server's accept loop right after start; connect-phase
    failures retry, a hung response does not."""
    host, _, port = server.partition(":")
    for attempt in range(retries + 1):
        try:
            conn = _pysocket.create_connection((host, int(port)), timeout=timeout)
            break
        except OSError:
            if attempt == retries:
                raise
            import time

            time.sleep(0.05 * (2**attempt))
    with conn as s:
        req = (
            f"GET /{page.lstrip('/')} HTTP/1.1\r\nHost: {server}\r\n"
            "Connection: close\r\n\r\n"
        )
        s.sendall(req.encode())
        data = b""
        while True:
            head, sep, body = data.partition(b"\r\n\r\n")
            if sep:
                clen = None
                for line in head.split(b"\r\n"):
                    if line.lower().startswith(b"content-length:"):
                        clen = int(line.split(b":")[1])
                if clen is not None and len(body) >= clen:
                    break
            chunk = s.recv(65536)
            if not chunk:
                break
            data += chunk
    head, _, body = data.partition(b"\r\n\r\n")
    status = 502
    ctype = "text/plain"
    for i, line in enumerate(head.split(b"\r\n")):
        if i == 0 and line.startswith(b"HTTP/"):
            parts = line.split()
            if len(parts) >= 2 and parts[1].isdigit():
                status = int(parts[1])
        elif line.lower().startswith(b"content-type:"):
            ctype = line.split(b":", 1)[1].strip().decode("latin-1")
    return status, ctype, body


def fetch_page(
    server: str, page: str = "status", timeout: float = 3.0, retries: int = 5
) -> str:
    """Body-only fetch (the one-shot CLI mode and test helper)."""
    return fetch_page_full(server, page, timeout, retries)[2].decode(
        "utf-8", errors="replace"
    )


def make_proxy_server(target: str, timeout: float = 5.0):
    """Build (not start) a Server whose builtin paths proxy `target`
    (reference rpc_view.cpp: a brpc server forwarding to -target)."""
    from urllib.parse import urlencode

    from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

    # has_builtin_services=False: start() must not overwrite the proxy
    # handlers with this server's OWN pages
    srv = Server(
        ServerOptions(
            server_info_name=f"rpc_view -> {target}",
            has_builtin_services=False,
        )
    )

    def proxy(server, msg):
        page = msg.path
        if msg.query:
            page += "?" + urlencode(msg.query)
        try:
            # retries=0: the retry loop exists for the just-started-
            # server race in one-shot mode; a proxy must fail fast or a
            # down target serializes every worker behind backoff sleeps
            status, ctype, body = fetch_page_full(
                target, page, timeout, retries=0
            )
        except OSError as e:
            return 502, f"rpc_view: {target} unreachable: {e}", "text/plain"
        return status, body, ctype

    # builtin registration replaces this server's own pages with the
    # proxied ones — the same inversion the reference performs
    for path in PROXY_PAGES:
        srv.add_builtin_handler(path, proxy)
    return srv


def serve(target: str, port: int = 8888, timeout: float = 5.0):
    srv = make_proxy_server(target, timeout)
    rc = srv.start(port)
    if rc != 0:
        raise RuntimeError(f"rpc_view proxy failed to start on :{port}")
    return srv


def main(argv=None):
    ap = argparse.ArgumentParser(description="rpc_view")
    ap.add_argument("--server", required=True, help="target host:port")
    ap.add_argument("--page", default=None, help="one-shot: fetch this page")
    ap.add_argument(
        "--port", type=int, default=None,
        help="proxy mode: serve the target's pages on this local port",
    )
    args = ap.parse_args(argv)
    if args.port is not None and args.page is not None:
        ap.error("--page (one-shot) and --port (proxy mode) conflict")
    if args.port is not None:
        srv = serve(args.server, args.port)
        print(f"proxying {args.server} on http://0.0.0.0:{srv.port}/ — Ctrl-C stops")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
        return
    print(fetch_page(args.server, args.page or "status"))


if __name__ == "__main__":
    main()
