"""BatchPolicy — the per-method coalescing contract.

Dependency-free on purpose: ``server/service.py`` imports it at class
definition time (the ``@batched_method`` decorator carries a policy),
so it must not pull the runtime/transport stack in.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class BatchPolicy:
    """Knobs of one method's micro-batcher.

    max_batch_size   rows per fused execution; <= 1 means batching OFF
                     for the method (the "zero-batch-size" config): the
                     server never builds a Batcher and requests take
                     the existing dispatch path unchanged.
    max_wait_us      longest a row may sit waiting for batch-mates.
                     The classic latency/throughput dial; tunable at
                     runtime via POST /batching.
    padding_buckets  ascending batch sizes the fused device execution
                     pads up to.  jit specializes per leading-dim, so
                     without buckets every distinct batch size retraces;
                     with them the trace-cache size is bounded by the
                     bucket count (asserted in tests).  () = no padding.
    deadline_us      per-request time budget from enqueue.  0 disables
                     the deadline guard.  Two effects:
                       * flush is scheduled so a row never waits past
                         (deadline - expected batch service time) — its
                         remaining budget always covers the execution;
                       * a row already past its deadline at dequeue is
                         SHED with ELIMIT before user code runs (the
                         shed feeds the method's concurrency limiter
                         like any other errored response).
    expected_service_us  seed for the batch-service-time EMA the
                     deadline guard subtracts; the Batcher refines it
                     from measured flushes.  With deadline_us set and
                     no explicit seed, it floors at deadline_us / 10 —
                     a zero seed would let the very first window flush
                     exactly AT its rows' deadline, landing their
                     responses past it.
    max_queue_rows   overload bound: rows the batcher may hold queued
                     (batches execute one at a time per method, so the
                     queue is where sustained overload accumulates).  A
                     row arriving at a full queue is shed immediately
                     with EOVERCROWDED — bounded memory and bounded
                     queue wait instead of unbounded growth.  0 = auto
                     (16 x max_batch_size).
    """

    max_batch_size: int = 32
    max_wait_us: int = 1000
    padding_buckets: Tuple[int, ...] = field(default_factory=tuple)
    deadline_us: int = 0
    expected_service_us: int = 0
    max_queue_rows: int = 0

    def __post_init__(self):
        self.max_batch_size = int(self.max_batch_size)
        self.max_wait_us = int(self.max_wait_us)
        self.deadline_us = int(self.deadline_us)
        self.expected_service_us = int(self.expected_service_us)
        self.max_queue_rows = int(self.max_queue_rows)
        buckets = tuple(int(b) for b in self.padding_buckets)
        if self.max_wait_us < 0:
            raise ValueError("max_wait_us must be >= 0")
        if self.deadline_us < 0 or self.expected_service_us < 0:
            raise ValueError("deadline_us/expected_service_us must be >= 0")
        if self.max_queue_rows < 0:
            raise ValueError("max_queue_rows must be >= 0 (0 = auto)")
        if self.deadline_us and not self.expected_service_us:
            # conservative seed until the EMA has a real measurement
            self.expected_service_us = self.deadline_us // 10
        if any(b <= 0 for b in buckets):
            raise ValueError("padding buckets must be positive")
        if list(buckets) != sorted(set(buckets)):
            raise ValueError("padding buckets must be strictly ascending")
        if buckets and self.max_batch_size > 1 and buckets[-1] < self.max_batch_size:
            # a batch bigger than the last bucket would execute unpadded
            # at its exact size — an unbounded-retrace hole the bucket
            # contract exists to close
            raise ValueError(
                f"largest padding bucket {buckets[-1]} < max_batch_size "
                f"{self.max_batch_size}: oversize batches would bypass "
                f"the retrace bound"
            )
        self.padding_buckets = buckets

    @property
    def enabled(self) -> bool:
        return self.max_batch_size > 1

    @property
    def queue_cap(self) -> int:
        """Effective queued-row bound (max_queue_rows, auto-derived
        when 0)."""
        return self.max_queue_rows or 16 * max(1, self.max_batch_size)

    def bucket_for(self, n: int) -> int:
        """Smallest padding bucket >= n (n itself without buckets)."""
        for b in self.padding_buckets:
            if b >= n:
                return b
        return n

    def to_dict(self) -> dict:
        return {
            "max_batch_size": self.max_batch_size,
            "max_wait_us": self.max_wait_us,
            "padding_buckets": list(self.padding_buckets),
            "deadline_us": self.deadline_us,
            "expected_service_us": self.expected_service_us,
            "max_queue_rows": self.max_queue_rows,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BatchPolicy":
        unknown = set(d) - {
            "max_batch_size", "max_wait_us", "padding_buckets",
            "deadline_us", "expected_service_us", "max_queue_rows",
        }
        if unknown:
            raise ValueError(f"unknown BatchPolicy keys {sorted(unknown)}")
        return cls(**d)
