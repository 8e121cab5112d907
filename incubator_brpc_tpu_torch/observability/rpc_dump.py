"""rpc_dump — sampled request capture for replay.

Analog of reference rpc_dump.{h,cpp}: a fast sampling gate
(AskToBeSampled, rpc_dump.h:67) captures requests into round-robin
files under a directory (rpc_dump.cpp:48-58); the rpc_replay tool
re-issues them at controlled qps.

File format (one sample): b"TDMP" + meta_size(u32) + body_size(u32) +
meta(json: service/method/log_id) + body bytes.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

from incubator_brpc_tpu_torch.utils.iobuf import IOBuf

MAGIC = b"TDMP"


class RpcDumpContext:
    def __init__(
        self,
        dump_dir: str,
        sample_ratio: float = 0.01,
        max_files: int = 4,
        max_file_bytes: int = 8 << 20,
    ):
        self.dump_dir = dump_dir
        self.sample_ratio = sample_ratio
        self.max_files = max_files
        self.max_file_bytes = max_file_bytes
        os.makedirs(dump_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._file_idx = 0
        self._cur = None
        self._cur_bytes = 0
        self._counter = 0
        self.sampled = 0

    def _should_sample(self) -> bool:
        self._counter += 1
        period = max(1, int(1 / self.sample_ratio))
        return self._counter % period == 1 or period == 1

    def sample_request(self, req_meta, payload: IOBuf, attachment_size: int = 0):
        """Called on the server request path (the AskToBeSampled gate).
        ``attachment_size`` is the frame's: the body's last that many
        bytes are the attachment, which a replay must send as one."""
        if not self._should_sample():
            return
        meta = json.dumps(
            {
                "service": req_meta.service_name,
                "method": req_meta.method_name,
                "log_id": req_meta.log_id,
                "attachment_size": attachment_size,
                "ts": time.time(),
            }
        ).encode()
        body = payload.to_bytes()
        record = MAGIC + struct.pack(">II", len(meta), len(body)) + meta + body
        with self._lock:
            f = self._file()
            f.write(record)
            f.flush()
            self._cur_bytes += len(record)
            self.sampled += 1

    def _file(self):
        if self._cur is None or self._cur_bytes >= self.max_file_bytes:
            if self._cur is not None:
                self._cur.close()
            path = os.path.join(
                self.dump_dir, f"requests.{self._file_idx % self.max_files:04d}"
            )
            self._file_idx += 1
            self._cur = open(path, "wb")  # round-robin: truncate old
            self._cur_bytes = 0
        return self._cur


def read_samples(path: str) -> Iterator[Tuple[dict, bytes]]:
    """Iterate (meta, body) samples from one dump file (rpc_replay input)."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 12 <= len(data):
        if data[pos : pos + 4] != MAGIC:
            break
        meta_size, body_size = struct.unpack_from(">II", data, pos + 4)
        pos += 12
        meta = json.loads(data[pos : pos + meta_size])
        body = data[pos + meta_size : pos + meta_size + body_size]
        pos += meta_size + body_size
        yield meta, body


def list_dump_files(dump_dir: str) -> List[str]:
    try:
        return sorted(
            os.path.join(dump_dir, f)
            for f in os.listdir(dump_dir)
            if f.startswith("requests.")
        )
    except OSError:
        return []
