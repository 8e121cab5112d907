"""Circuit breaker + cluster recovery.

Analog of reference CircuitBreaker (circuit_breaker.h:25-60): per-node
error-rate EMA; a node is isolated when its recent error rate crosses
the threshold, isolation duration doubles on repeat offenses (capped),
and the node rejoins after the duration via health checking.
ClusterRecoverPolicy (cluster_recover_policy.{h,cpp}) prevents
avalanche: when too many nodes are isolated, traffic is randomly let
through to isolated nodes so the cluster can recover.
"""

from __future__ import annotations

import threading
import time

from incubator_brpc_tpu_torch.utils.hashes import fast_rand_double


class CircuitBreaker:
    def __init__(
        self,
        alpha: float = 0.2,
        error_threshold: float = 0.5,
        min_samples: int = 5,
        base_isolation_s: float = 0.1,
        max_isolation_s: float = 30.0,
    ):
        self._alpha = alpha
        self._threshold = error_threshold
        self._min_samples = min_samples
        self._base_isolation = base_isolation_s
        self._max_isolation = max_isolation_s
        self._lock = threading.Lock()
        self._ema_error = 0.0
        self._samples = 0
        self._isolated_until = 0.0
        self._isolation_count = 0

    def on_call(self, failed: bool) -> None:
        """Feedback from every finished RPC (reference OnCallEnd)."""
        with self._lock:
            self._samples += 1
            self._ema_error = (
                self._ema_error * (1 - self._alpha) + (1.0 if failed else 0.0) * self._alpha
            )
            if (
                failed
                and self._samples >= self._min_samples
                and self._ema_error > self._threshold
                and time.monotonic() >= self._isolated_until
            ):
                self._isolation_count += 1
                duration = min(
                    self._base_isolation * (2 ** (self._isolation_count - 1)),
                    self._max_isolation,
                )
                self._isolated_until = time.monotonic() + duration

    def mark_failed_hard(self):
        """Connection-level failure: isolate immediately."""
        with self._lock:
            self._isolation_count += 1
            duration = min(
                self._base_isolation * (2 ** (self._isolation_count - 1)),
                self._max_isolation,
            )
            self._isolated_until = time.monotonic() + duration
            self._ema_error = 1.0
            self._samples = max(self._samples, self._min_samples)

    def is_isolated(self) -> bool:
        return time.monotonic() < self._isolated_until

    def reset(self):
        """Health check succeeded: rejoin (reference Reset; the
        repeat-offender count decays rather than clearing)."""
        with self._lock:
            self._ema_error = 0.0
            self._samples = 0
            self._isolated_until = 0.0
            self._isolation_count = max(0, self._isolation_count - 1)


class ClusterRecoverPolicy:
    """Anti-avalanche: when isolated_ratio exceeds `threshold`, allow a
    random fraction of traffic to isolated nodes."""

    def __init__(self, threshold: float = 0.7):
        self._threshold = threshold

    def should_try_isolated(self, isolated: int, total: int) -> bool:
        if total == 0 or isolated == 0:
            return False
        ratio = isolated / total
        if ratio < self._threshold:
            return False
        return fast_rand_double() < ratio
