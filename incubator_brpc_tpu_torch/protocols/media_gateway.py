"""Media gateway — RTMP ingest fanned out to HLS and FLV consumers.

The integration layer over protocols/flv.py and protocols/ts.py: an
RtmpService that taps every published stream's media into a per-stream
HlsSegmenter (live .ts window + m3u8) and FLV archive, the way
reference users compose FlvWriter (rtmp.h:401) and the TS writer
(ts.{h,cpp}) behind an RTMP/media server.  Plug it into
``ServerOptions.rtmp_service`` and serve the accessors from any HTTP
handler:

    gw = MediaGatewayService()
    srv = Server(ServerOptions(rtmp_service=gw, ...))
    ...
    gw.playlist("room")          # → m3u8 text
    gw.segment("room", seq)      # → .ts bytes
    gw.flv_snapshot("room")      # → progressive-download FLV bytes
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from incubator_brpc_tpu_torch.protocols.flv import FlvWriter
from incubator_brpc_tpu_torch.protocols.rtmp import RtmpMessage, RtmpService
from incubator_brpc_tpu_torch.protocols.ts import HlsSegmenter

_FLV_CAP = 64 << 20  # stop archiving past 64MB (live use: HLS window)
_EVICT_IDLE_S = 10.0  # a stream this quiet counts as gone for eviction


class _StreamState:
    def __init__(self, target_s: float, window: int, flv: bool):
        self.hls = HlsSegmenter(target_duration_s=target_s, window=window)
        self.flv = FlvWriter() if flv else None
        # archive as immutable chunks: snapshots shallow-copy the list
        # under the lock and join OUTSIDE it, so a 64MB poll never
        # stalls live ingest
        self.flv_chunks: List[bytes] = []
        self.flv_size = 0
        self.last_active = time.monotonic()
        self.lock = threading.Lock()


class MediaGatewayService(RtmpService):
    def __init__(
        self,
        target_duration_s: float = 4.0,
        window: int = 5,
        flv_archive: bool = True,
        max_streams: int = 64,
    ):
        self._target = target_duration_s
        self._window = window
        self._flv = flv_archive
        self._max_streams = max_streams
        self._streams: Dict[str, _StreamState] = {}
        self._lock = threading.Lock()

    # ---- RtmpService hooks --------------------------------------------------
    def on_frame(self, stream_name: str, msg: RtmpMessage) -> None:
        st = self._state(stream_name)
        with st.lock:
            st.last_active = time.monotonic()
            st.hls.on_message(msg)
            if st.flv is not None and st.flv_size < _FLV_CAP:
                try:
                    st.flv.write_message(msg)
                except ValueError:
                    pass  # non-media control frames
                else:
                    chunk = st.flv.take()
                    st.flv_chunks.append(chunk)
                    st.flv_size += len(chunk)

    # ---- consumer accessors -------------------------------------------------
    def streams(self):
        with self._lock:
            return sorted(self._streams)

    def playlist(self, stream: str, end: bool = False) -> Optional[str]:
        st = self._get(stream)
        if st is None:
            return None
        with st.lock:
            return st.hls.playlist(end=end)

    def segment(self, stream: str, seq: int) -> Optional[bytes]:
        st = self._get(stream)
        if st is None:
            return None
        with st.lock:
            for s in st.hls.segments:
                if s.seq == seq:
                    return bytes(s.data)
        return None

    def finish(self, stream: str) -> None:
        """Seal the open segment (publisher stopped)."""
        st = self._get(stream)
        if st is not None:
            with st.lock:
                st.hls.finish_segment()

    def flv_snapshot(self, stream: str) -> bytes:
        """Everything archived so far as one FLV byte stream."""
        st = self._get(stream)
        if st is None:
            return b""
        with st.lock:
            chunks = list(st.flv_chunks)
        return b"".join(chunks)  # the big copy runs outside the lock

    def drop(self, stream: str) -> None:
        """Forget a stream's state (publisher gone, archive served)."""
        with self._lock:
            self._streams.pop(stream, None)

    # ---- internals ----------------------------------------------------------
    def _state(self, stream: str) -> _StreamState:
        with self._lock:
            st = self._streams.get(stream)
            if st is None:
                # bounded registry: unique-name churn (or a hostile
                # publisher) must not grow memory forever.  Prefer
                # evicting IDLE streams — evicting a live publisher
                # would drop its cached sequence headers and silently
                # kill its HLS/FLV output until it republishes.  Only
                # when every entry is live does the globally oldest go
                # (bounded memory wins; loudly).
                if len(self._streams) >= self._max_streams:
                    now = time.monotonic()
                    idle = [
                        k
                        for k, v in self._streams.items()
                        if now - v.last_active > _EVICT_IDLE_S
                    ]
                    pool = idle or list(self._streams)
                    victim = min(
                        pool, key=lambda k: self._streams[k].last_active
                    )
                    if not idle:
                        from incubator_brpc_tpu_torch.utils.logging import log_error

                        log_error(
                            "media gateway at max_streams=%d with all "
                            "streams live; evicting %r",
                            self._max_streams, victim,
                        )
                    del self._streams[victim]
                st = self._streams[stream] = _StreamState(
                    self._target, self._window, self._flv
                )
            return st

    def _get(self, stream: str) -> Optional[_StreamState]:
        with self._lock:
            return self._streams.get(stream)
