"""MethodStatus + ConcurrencyLimiter.

Analog of reference details/method_status.{h,cpp} and
concurrency_limiter.h: per-method concurrency gate + qps/latency stats
(LatencyRecorder gives qps, p50/p90/p99/p99.9 per method exactly as the
reference's /status page shows). The "auto" limiter implements the
reference's gradient algorithm (policy/auto_concurrency_limiter.{h,cpp},
doc docs/cn/auto_concurrency_limiter.md): track min latency and
windowed qps, derive max_concurrency ≈ peak_qps × min_latency with a
periodic exploration phase that lowers the limit to re-sample the
no-load latency.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder
from incubator_brpc_tpu_torch.metrics.reducer import Adder


class ConcurrencyLimiter:
    """Interface (concurrency_limiter.h)."""

    def on_request(self, current: int) -> bool:
        raise NotImplementedError

    def on_response(self, latency_us: int) -> None:
        pass

    def on_response_bulk(self, latency_us: int, n: int) -> None:
        """Fold `n` responses averaging `latency_us` in O(1).  Used by
        the native fast-path harvest; limiters that estimate qps from
        call counts must override (one plain on_response per harvest
        would collapse the estimate)."""
        self.on_response(latency_us)

    def max_concurrency(self) -> int:
        return 0


class ConstantConcurrencyLimiter(ConcurrencyLimiter):
    def __init__(self, limit: int):
        self._limit = limit

    def on_request(self, current: int) -> bool:
        return self._limit <= 0 or current <= self._limit

    def max_concurrency(self) -> int:
        return self._limit


class AutoConcurrencyLimiter(ConcurrencyLimiter):
    """Gradient/EMA limiter (auto_concurrency_limiter.h:29-80)."""

    def __init__(
        self,
        alpha: float = 0.3,
        min_limit: int = 8,
        sample_window_s: float = 1.0,
        explore_interval_s: float = 15.0,
        explore_ratio: float = 0.7,
    ):
        self._alpha = alpha
        self._min_limit = min_limit
        self._limit = 64
        self._min_latency_us: Optional[float] = None
        self._win_start = time.monotonic()
        self._win_count = 0
        self._win_lat_sum = 0.0
        self._last_explore = time.monotonic()
        self._explore_interval = explore_interval_s
        self._explore_ratio = explore_ratio
        self._sample_window = sample_window_s
        self._lock = threading.Lock()
        # observed-latency feedback (server/admission.py
        # feed_limiter_from_tier_latency): when set, each window update
        # also reads this live signal — e.g. the interactive tier's p99
        # — and shrinks the limit proportionally whenever it exceeds
        # the target, instead of trusting the static no-load estimate
        self._observed_us_fn = None
        self._target_us = 0

    def set_latency_target(self, observed_us_fn, target_us: int) -> None:
        """Feed an observed-latency source (callable returning the
        current latency in us, e.g. a tier p99) and the acceptable
        target.  observed > target ⇒ the next window update scales the
        limit by target/observed (floored at min_limit)."""
        self._observed_us_fn = observed_us_fn
        self._target_us = int(target_us)

    def on_request(self, current: int) -> bool:
        return current <= self._limit

    def on_response(self, latency_us: int) -> None:
        self.on_response_bulk(latency_us, 1)

    def on_response_bulk(self, latency_us: int, n: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._win_count += n
            self._win_lat_sum += latency_us * n
            span = now - self._win_start
            if span < self._sample_window or self._win_count < 10:
                return
            avg_lat = self._win_lat_sum / self._win_count
            qps = self._win_count / span
            self._win_start = now
            self._win_count = 0
            self._win_lat_sum = 0.0
            if self._min_latency_us is None:
                self._min_latency_us = avg_lat
            else:
                # EMA toward observed minimum (reference smoothing)
                self._min_latency_us = min(
                    self._min_latency_us * (1 - self._alpha) + avg_lat * self._alpha,
                    max(self._min_latency_us, 1.0),
                )
            # little's law: concurrency that keeps latency near no-load
            target = qps * (self._min_latency_us / 1e6) * 1.2 + self._min_limit
            self._limit = max(self._min_limit, int(target))
            if self._observed_us_fn is not None and self._target_us > 0:
                try:
                    observed = float(self._observed_us_fn() or 0.0)
                except Exception:  # noqa: BLE001 — a failing signal
                    # source must never take the method down with it
                    observed = 0.0
                if observed > self._target_us:
                    self._limit = max(
                        self._min_limit,
                        min(
                            self._limit,
                            int(self._limit * self._target_us / observed),
                        ),
                    )
            if now - self._last_explore > self._explore_interval:
                # exploration: drop the limit briefly to re-measure
                self._last_explore = now
                self._limit = max(self._min_limit, int(self._limit * self._explore_ratio))
                self._min_latency_us = avg_lat

    def max_concurrency(self) -> int:
        return self._limit


def make_limiter(spec) -> Optional[ConcurrencyLimiter]:
    """Parse an adaptive max-concurrency spec: 0/None=unlimited, int=N,
    "auto"=gradient, "constant=N" (reference AdaptiveMaxConcurrency's
    string forms, adaptive_max_concurrency.cpp)."""
    if spec in (None, 0, "", "unlimited"):
        return None
    if spec == "auto":
        return AutoConcurrencyLimiter()
    if isinstance(spec, str) and spec.startswith("constant="):
        return ConstantConcurrencyLimiter(int(spec.partition("=")[2]))
    if isinstance(spec, ConcurrencyLimiter):
        return spec
    return ConstantConcurrencyLimiter(int(spec))


class MethodStatus:
    """Per-method stats + concurrency gate (details/method_status.h)."""

    def __init__(self, full_name: str, limiter: Optional[ConcurrencyLimiter] = None):
        self.full_name = full_name
        self.latency_rec = LatencyRecorder()
        self.errors = Adder(0)
        self._concurrency = 0
        self._lock = threading.Lock()
        self.limiter = limiter

    def expose(self):
        safe = self.full_name.replace(".", "_").lower()
        self.latency_rec.expose(f"rpc_server_{safe}")
        self.errors.expose(f"rpc_server_{safe}_error")

    def on_requested(self) -> bool:
        with self._lock:
            self._concurrency += 1
            current = self._concurrency
        if self.limiter is not None and not self.limiter.on_request(current):
            with self._lock:
                self._concurrency -= 1
            return False
        return True

    def on_response(self, latency_us: int, error: bool = False) -> None:
        with self._lock:
            self._concurrency -= 1
        if error:
            self.errors << 1
        elif latency_us > 0:
            self.latency_rec.update(latency_us)
        if self.limiter is not None:
            self.limiter.on_response(latency_us)

    @property
    def concurrency(self) -> int:
        return self._concurrency
