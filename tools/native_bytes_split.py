#!/usr/bin/env python3
"""Split the native lane's bytes path: the same large attachment through
the JAX package's native server and through the port's, on the CPU.

    python tools/native_bytes_split.py [--mb 151] [--reps 3] [--json PATH]

Each package runs in a child interpreter of its own (neither process
imports the other package), with a native-engine server and a native
channel on loopback.  Per package it times, median of ``--reps``:

- ``echo_c``: an EchoService echo of the attachment that the engine
  answers in C (its native fast path): the transport and the client's
  Python side only;
- ``echo_py``: the same echo with ``sleep_us=1``, which hands the frame
  to the Python handler: the engine's hand-off to Python and back;
- ``put`` / ``get``: a PsService Put of the attachment as bytes, then a
  Get of it, the path W takes over TCP in the smoke's ``[native]``.

The default 151 MB is W at d = 6144 in float32.  Prints one line per
package and a JSON object with both and the port / JAX ratio of each
figure.  It asserts nothing about time: the figures say whether the
port's copies cost more than the JAX package's (a port fault) or the
two are even (a cost of the shared design).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "incubator_brpc_tpu", "port": "incubator_brpc_tpu_torch"}

_CHILD = r"""
import importlib, json, statistics, sys, time
pkg, nbytes, reps = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
m = lambda name: importlib.import_module(f"{pkg}.{name}")
Server, ServerOptions = m("server.server").Server, m("server.server").ServerOptions
Channel, ChannelOptions = m("client.channel").Channel, m("client.channel").ChannelOptions
Controller = m("client.controller").Controller
echo, ps = m("models.echo"), m("models.parameter_server")
EchoRequest = m("protos.echo_pb2").EchoRequest
if pkg.endswith("_torch"):
    import torch
    svc = ps.PsService(device=torch.device("cpu"))
else:
    svc = ps.PsService()
srv = Server(ServerOptions(native_engine=True))
srv.add_service(echo.EchoService())
srv.add_service(svc)
assert srv.start(0) == 0 and srv._native_engine is not None, "no native engine"
ch = Channel(ChannelOptions(timeout_ms=600000, connection_type="native"))
assert ch.init(f"127.0.0.1:{srv.port}") == 0
payload = bytes(range(256)) * (nbytes // 256) + bytes(nbytes % 256)
estub, pstub = echo.echo_stub(ch), ps.ps_stub(ch)

def timed(call):
    out = []
    for _ in range(reps):
        c = Controller()
        t0 = time.perf_counter()
        got = call(c)
        out.append((time.perf_counter() - t0) * 1e3)
        assert not c.failed(), c.error_text()
        assert got == payload, "the bytes came back otherwise"
    return statistics.median(out)

def echo_call(sleep_us):
    def call(c):
        c.request_attachment.append(payload)
        estub.Echo(c, EchoRequest(message="x", sleep_us=sleep_us))
        return c.response_attachment.to_bytes()
    return call

def put(c):
    c.request_attachment.append(payload)
    pstub.Put(c, EchoRequest(message="w"))
    return payload

def get(c):
    pstub.Get(c, EchoRequest(message="w"))
    return c.response_attachment.to_bytes()

res = {"echo_c": timed(echo_call(0)), "echo_py": timed(echo_call(1)),
       "put": timed(put), "get": timed(get)}
ch.close(); srv.stop()
print(json.dumps(res))
"""


def run_child(pkg: str, nbytes: int, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _CHILD, pkg, str(nbytes), str(reps)],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
    if out.returncode != 0:
        raise SystemExit(f"{pkg}: child failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=6144 * 6144 * 4 / 1e6,
                    help="attachment size in MB (default: W at d = 6144, float32)")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    nbytes = int(args.mb * 1e6)
    # alternate the packages, so a drift of the machine's load hits both
    rounds = {name: [] for name in PACKAGES}
    for order in (("jax", "port"), ("port", "jax")):
        for name in order:
            rounds[name].append(run_child(PACKAGES[name], nbytes, args.reps))
    res = {name: {k: statistics.median(r[k] for r in rs) for k in rs[0]}
           for name, rs in rounds.items()}
    res["port_over_jax"] = {k: res["port"][k] / res["jax"][k] for k in res["jax"]}
    res["bytes"] = nbytes
    for name in PACKAGES:
        print(f"{name:4}: " + ", ".join(f"{k} {v:.1f} ms" for k, v in res[name].items()))
    print(json.dumps(res))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
