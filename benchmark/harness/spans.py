"""The program's rpcz server spans, every one, while a traced window runs.

The program keeps rpcz on by default at a creation budget of 500 traces
a second (``rpcz_max_spans_per_second``); the traced run lifts the
budget so every call is traced, and takes each finished server span as
the program's collector hands it to the span store.  The untraced run
leaves the program's defaults as they are.
"""

from __future__ import annotations

import time
from typing import List, Tuple

# (service, method, received_us, callback_start_us)
SpanStamps = Tuple[str, str, int, int]

_BUDGET = 10_000_000
_DRAIN_WAIT_S = 0.5  # the collector drains every 0.1 s


class ServerSpans:
    def __init__(self):
        self.stamps: List[SpanStamps] = []

    def __enter__(self) -> "ServerSpans":
        from incubator_brpc_tpu_torch.observability.span import span_db
        from incubator_brpc_tpu_torch.utils.flags import get_flag, set_flag

        self._saved = {
            name: get_flag(name) for name in ("rpcz_enabled", "rpcz_max_spans_per_second")
        }
        set_flag("rpcz_enabled", True)
        set_flag("rpcz_max_spans_per_second", _BUDGET)
        self._db = span_db()
        keep = self.stamps.append
        store = self._db.add

        def add(span):
            if span.kind == "server":
                keep((span.service, span.method, span.phase("received_us"),
                      span.phase("callback_start_us")))
            store(span)

        self._db.add = add
        return self

    def __exit__(self, *exc) -> None:
        from incubator_brpc_tpu_torch.utils.flags import set_flag

        time.sleep(_DRAIN_WAIT_S)  # let the collector hand over the window's last spans
        del self._db.add
        for name, value in self._saved.items():
            set_flag(name, value)

    def within(self, lo_us: int, hi_us: int) -> List[SpanStamps]:
        """The spans whose callback began inside [lo_us, hi_us] (wall clock)."""
        return [s for s in self.stamps if lo_us <= s[3] <= hi_us]
