"""HTTP server — reference example/http_c++.

The same port speaks tpu_std AND restful HTTP: any pb method is
reachable as POST /Service/Method with a JSON body (json2pb maps it),
and the builtin observability pages are plain GETs.

    python examples_torch/http_server.py [port]    # serve until Ctrl-C
    python examples_torch/http_server.py --demo    # self-contained demo
"""

import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from incubator_brpc_tpu_torch.models.echo import EchoService
from incubator_brpc_tpu_torch.server.server import Server, ServerOptions


def start(port=0):
    srv = Server(ServerOptions(usercode_in_dispatcher=True))
    srv.add_service(EchoService())
    assert srv.start(port) == 0
    return srv


def demo():
    srv = start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        req = urllib.request.Request(
            f"{base}/EchoService/Echo",
            data=json.dumps({"message": "restful", "code": 7}).encode(),
            headers={"Content-Type": "application/json"},
        )
        body = json.loads(urllib.request.urlopen(req, timeout=5).read())
        print(f"POST /EchoService/Echo -> {body}")
        status = urllib.request.urlopen(f"{base}/status", timeout=5).read()
        print("GET /status ->")
        print("  " + status.decode().splitlines()[0])
        print(f"also try: curl {base}/vars   curl '{base}/hotspots/cpu?view=flame'")
    finally:
        srv.stop()


if __name__ == "__main__":
    if "--demo" in sys.argv:
        demo()
    else:
        port = int(sys.argv[1]) if len(sys.argv) > 1 else 8010
        srv = start(port)
        print(f"serving on :{srv.port} — POST /EchoService/Echo, GET /status")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            srv.stop()
