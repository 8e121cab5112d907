"""rpc_replay — re-issue rpc_dump samples at controlled qps.

Analog of reference tools/rpc_replay/rpc_replay.cpp: reads sample files
written by the server's rpc_dump context and replays them against a
target server.
"""

from __future__ import annotations

import argparse
import time


def replay(server: str, dump_dir: str, qps: int = 100, times: int = 1, report=print):
    from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
    from incubator_brpc_tpu_torch.client.controller import Controller
    from incubator_brpc_tpu_torch.observability.rpc_dump import list_dump_files, read_samples
    from incubator_brpc_tpu_torch.protos import rpc_meta_pb2 as pb
    from incubator_brpc_tpu_torch.protocols.tpu_std import _frame
    from incubator_brpc_tpu_torch.runtime.call_id import default_pool
    from incubator_brpc_tpu_torch.transport.socket import Socket
    from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

    files = list_dump_files(dump_dir)
    if not files:
        report(f"no dump files under {dump_dir}")
        return None
    ch = Channel(ChannelOptions(timeout_ms=5000))
    if ch.init(server) != 0:
        report("channel init failed")
        return None
    sent = ok = 0
    interval = 1.0 / max(qps, 1)
    t0 = time.monotonic()
    for _ in range(times):
        for path in files:
            for meta, body in read_samples(path):
                # raw replay: rebuild the tpu_std frame with a fresh cid
                # and push it through the channel's transport
                from incubator_brpc_tpu_torch.client.controller import Controller
                from incubator_brpc_tpu_torch.server.service import MethodSpec

                c = Controller()
                # look up message classes is impossible from raw bytes;
                # send as raw frame on the shared socket
                err, sid, _node = ch._select_socket(c)
                if err:
                    continue
                sock = Socket.address(sid)
                if sock is None:
                    continue
                m = pb.RpcMeta()
                m.request.service_name = meta["service"]
                m.request.method_name = meta["method"]
                m.request.log_id = meta.get("log_id", 0)
                m.attachment_size = meta.get("attachment_size", 0)
                m.correlation_id = 0  # fire-and-forget replay
                sock.write(_frame(m, IOBuf(body)))
                sent += 1
                ok += 1
                time.sleep(interval)
    wall = time.monotonic() - t0
    report(f"replayed {sent} samples in {wall:.1f}s ({sent / max(wall, 1e-9):.0f} qps)")
    return sent


def main(argv=None):
    ap = argparse.ArgumentParser(description="rpc_replay")
    ap.add_argument("--server", required=True)
    ap.add_argument("--dir", required=True, help="rpc_dump directory")
    ap.add_argument("--qps", type=int, default=100)
    ap.add_argument("--times", type=int, default=1)
    args = ap.parse_args(argv)
    replay(args.server, args.dir, args.qps, args.times)


if __name__ == "__main__":
    main()
