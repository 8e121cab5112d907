"""RetryPolicy (analog of reference retry_policy.{h,cpp}).

DoRetry decides which error codes are retriable; the default mirrors
the reference's DefaultRetryPolicy: connection-level failures retry,
logical/server errors don't. Retries reuse the versioned CallId so
stale responses of dead attempts are dropped (controller.cpp:996-1004).

``backoff_ms`` extends the reference contract (newer brpc's
RetryPolicy::GetBackoffTimeMs): the Controller waits that long before
reissuing a retriable attempt.  RetryPolicyWithBackoff implements
seeded exponential backoff with deterministic jitter — the jitter for
retry k is a pure function of (seed, k), so a replayed run produces
the identical attempt-time spacing (the chaos harness asserts it).
"""

from __future__ import annotations

from incubator_brpc_tpu_torch import errors
from incubator_brpc_tpu_torch.utils.hashes import GOLDEN64 as _GOLDEN
from incubator_brpc_tpu_torch.utils.hashes import fmix64 as _mix64

#: codes worth reissuing.  EOVERCROWDED ("this server is overloaded,
#: retry elsewhere" — docs/overload.md code mapping) is retriable ONLY
#: against a different replica: reissuing it at the same saturated
#: server adds load exactly where there is none to give.  ELIMIT is
#: deliberately absent — it now means "the request expired while
#: queued" (batcher deadline shed): a drop, retrying is wasted work.
_RETRIABLE = (
    errors.EFAILEDSOCKET,
    errors.ECLOSE,
    errors.EOVERCROWDED,
    errors.ELOGOFF,
)


class RetryPolicy:
    def do_retry(self, controller) -> bool:
        code = controller.error_code
        if code not in _RETRIABLE:
            return False
        if (
            code == errors.EOVERCROWDED
            # only SERVER-returned sheds demand a different replica; a
            # locally-generated EOVERCROWDED (the client's own write
            # queue past its unsent-bytes cap) is transient — a
            # backed-off retry on the same connection drains it, and
            # failing fast there would regress every single-server
            # caller hitting momentary backpressure
            and controller.__dict__.get("_error_from_server")
            and not controller.has_unexcluded_replica()
        ):
            # no OTHER replica to try: hammering the overloaded server
            # again is worse than failing fast (the caller's own
            # backpressure is the right response)
            return False
        return True

    def backoff_ms(self, controller) -> float:
        """Delay before the next attempt; 0 = reissue immediately
        (the historical behavior, kept as the default)."""
        return 0.0


class RetryPolicyWithBackoff(RetryPolicy):
    """Exponential backoff with seeded, deterministic jitter.

    Retry k (1-based) sleeps ``min(base_ms * multiplier**(k-1),
    max_ms)`` scaled by a jitter factor in ``[1 - jitter, 1]`` drawn
    from fmix64(seed, k).  Pure function of (seed, k): call
    :meth:`expected_backoffs` to precompute the exact schedule a
    replay will follow.

    ``no_backoff_remaining_ms``: when the RPC's remaining deadline
    budget is below this, skip the sleep — burning the last slice of
    budget waiting guarantees a timeout (reference
    DefaultRetryPolicy-with-backoff has the same guard).
    """

    def __init__(
        self,
        base_ms: float = 4.0,
        max_ms: float = 1000.0,
        multiplier: float = 2.0,
        jitter: float = 0.25,
        seed: int = 0,
        no_backoff_remaining_ms: float = 0.0,
    ):
        self.base_ms = float(base_ms)
        self.max_ms = float(max_ms)
        self.multiplier = float(multiplier)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.seed = int(seed)
        self.no_backoff_remaining_ms = float(no_backoff_remaining_ms)

    def backoff_for(self, k: int) -> float:
        """The exact backoff (ms) before retry ``k`` (1-based)."""
        if k < 1:
            return 0.0
        raw = min(self.base_ms * self.multiplier ** (k - 1), self.max_ms)
        if self.jitter:
            u = _mix64(self.seed + k * _GOLDEN) / 2.0**64
            raw *= 1.0 - self.jitter * u
        return raw

    def expected_backoffs(self, n: int) -> list:
        """[backoff before retry 1, ..., before retry n] — the replay
        schedule the chaos harness compares attempt spacing against."""
        return [self.backoff_for(k) for k in range(1, n + 1)]

    #: slice of deadline budget a capped backoff always leaves for the
    #: reissued attempt itself
    DEADLINE_MARGIN_MS = 10.0

    def backoff_ms(self, controller) -> float:
        delay = self.backoff_for(controller.retry_count)
        remaining = controller.remaining_ms()
        if remaining is not None:
            if (
                self.no_backoff_remaining_ms > 0
                and remaining < self.no_backoff_remaining_ms
            ):
                return 0.0
            # never sleep past the overall deadline: an uncapped
            # backoff would convert every late retriable error into a
            # guaranteed ERPCTIMEDOUT, silently voiding the retry
            # budget (the scheduled delay may therefore undershoot
            # expected_backoffs near the deadline)
            delay = min(delay, max(0.0, remaining - self.DEADLINE_MARGIN_MS))
        return delay


_default = RetryPolicy()


def default_retry_policy() -> RetryPolicy:
    return _default
