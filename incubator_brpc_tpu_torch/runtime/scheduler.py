"""TaskControl / TaskGroup — work-stealing task scheduler.

Analog of bthread's TaskControl (task_control.h:41-116) and TaskGroup
(task_group.h:60-166): N workers, each with a private run deque; empty
workers steal from random victims (WorkStealingQueue, Chase–Lev in the
reference, work_stealing_queue.h:32-117) then park in a ParkingLot
(parking_lot.h:31).

Deviation from the reference, by design: bthreads context-switch in
user space so a blocked bthread costs nothing; Python tasks occupy
their worker thread while blocked. To preserve the invariant that a
blocked task never starves runnable tasks (the property the M:N design
exists for), workers notify the control on block/unblock and the
control spawns replacement workers up to a cap — an adaptive pool
instead of stack-switching.
"""

from __future__ import annotations

import os
import random
import threading
import time as _time
from collections import deque
from typing import Callable, Optional

from incubator_brpc_tpu_torch.utils.logging import log_error

# queue-out observer: callable(wait_us) fed each task's spawn→run delay
# (observability/latency_breakdown registers itself here; kept as a
# hook so this low-level module never imports the metrics stack). The
# optional gate is a Flag-like object — observation (including the
# per-task clock reads) only happens while gate.value is truthy, so a
# server with rpcz disabled pays nothing per spawn.
_task_queue_observer: Optional[Callable[[int], None]] = None
_task_queue_gate = None

# chaos hook slot (same pattern as the queue observer): chaos.injector
# fills it while an armed plan targets "scheduler.callback"; disarmed
# cost is one `is None` check per task run.
_chaos_hook: Optional[Callable[[], None]] = None

# occupancy observer: second queue-out slot with its own gate, filled by
# observability/profiling (the runtime occupancy sampler) — separate
# from the rpcz-gated latency_breakdown observer so either can be on
# while the other is off.  Same contract: callable(wait_us).
_occupancy_observer: Optional[Callable[[int], None]] = None
_occupancy_gate = None


def set_chaos_hook(cb: Optional[Callable[[], None]]) -> None:
    global _chaos_hook
    _chaos_hook = cb


def set_task_queue_observer(
    cb: Optional[Callable[[int], None]], gate=None
) -> None:
    global _task_queue_observer, _task_queue_gate
    _task_queue_observer = cb
    _task_queue_gate = gate


def set_occupancy_observer(
    cb: Optional[Callable[[int], None]], gate=None
) -> None:
    global _occupancy_observer, _occupancy_gate
    _occupancy_observer = cb
    _occupancy_gate = gate


def _gate_open(gate) -> bool:
    return gate is None or bool(gate.value)


def _observing() -> bool:
    if _task_queue_observer is not None and _gate_open(_task_queue_gate):
        return True
    return _occupancy_observer is not None and _gate_open(_occupancy_gate)


class Task:
    """Handle for a spawned task (stands in for a bthread tid)."""

    __slots__ = ("fn", "args", "_done", "result", "exc", "locals", "queued_ns")

    def __init__(self, fn, args):
        self.fn = fn
        self.args = args
        self._done = threading.Event()
        self.result = None
        self.exc = None
        # queue-in stamp, read back at run() for the queue-out delta;
        # clock read only while observation is on (observer + gate)
        self.queued_ns = _time.monotonic_ns() if _observing() else 0

    def run(self):
        if _chaos_hook is not None:
            try:
                _chaos_hook()  # injected callback delay
            except Exception:  # noqa: BLE001 — chaos must not kill workers
                pass
        if self.queued_ns:
            wait_us = (_time.monotonic_ns() - self.queued_ns) // 1000
            obs = _task_queue_observer
            if obs is not None and _gate_open(_task_queue_gate):
                try:
                    obs(wait_us)
                except Exception:  # noqa: BLE001
                    pass
            occ = _occupancy_observer
            if occ is not None and _gate_open(_occupancy_gate):
                try:
                    occ(wait_us)
                except Exception:  # noqa: BLE001
                    pass
        prev = getattr(_tls, "current_task", None)
        _tls.current_task = self
        try:
            self.result = self.fn(*self.args)
        except BaseException as e:  # noqa: BLE001 — task crash must not kill worker
            self.exc = e
            log_error("task %r raised: %r", self.fn, e)
        finally:
            _tls.current_task = prev
            self._done.set()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Analog of bthread_join."""
        return self._done.wait(timeout)

    def done(self) -> bool:
        return self._done.is_set()


class ParkingLot:
    """Futex-based sleep/wakeup for idle workers (parking_lot.h:31)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._signal = 0

    def signal(self, n: int = 1):
        with self._cond:
            self._signal += n
            if n == 1:
                self._cond.notify()
            else:
                self._cond.notify_all()

    def wait(self, timeout: float = 1.0) -> bool:
        with self._cond:
            if self._signal > 0:
                self._signal -= 1
                return True
            if self._cond.wait(timeout):
                if self._signal > 0:
                    self._signal -= 1
                return True
            return False


class TaskGroup:
    """Per-worker scheduler state (task_group.h): private deque + steal."""

    __slots__ = ("control", "rq", "lock", "worker_id", "steals", "runs")

    def __init__(self, control: "TaskControl", worker_id: int):
        self.control = control
        self.worker_id = worker_id
        self.rq: deque = deque()
        self.lock = threading.Lock()
        # plain ints, bumped GIL-atomically by this group's own worker —
        # the occupancy sampler (observability/profiling) reads them;
        # this module stays metrics-free
        self.steals = 0  # tasks this worker stole from a victim
        self.runs = 0  # tasks this worker executed

    def push(self, task: Task, urgent: bool = False):
        with self.lock:
            if urgent:
                self.rq.appendleft(task)  # bthread_start_urgent: run next
            else:
                self.rq.append(task)

    def pop(self) -> Optional[Task]:
        with self.lock:
            return self.rq.popleft() if self.rq else None

    def steal(self) -> Optional[Task]:
        with self.lock:
            return self.rq.pop() if self.rq else None  # steal from the tail


_tls = threading.local()


class TaskControl:
    """Owns worker threads and global scheduling (task_control.h:41)."""

    def __init__(self, concurrency: Optional[int] = None, max_workers: int = 256):
        self.concurrency = concurrency or max(4, (os.cpu_count() or 4))
        self.max_workers = max_workers
        self._groups: list[TaskGroup] = []
        self._remote_q: deque = deque()  # spawns from non-worker threads
        self._remote_lock = threading.Lock()
        self._lot = ParkingLot()
        self._lock = threading.Lock()
        self._stopped = False
        self._nworkers = 0
        self._nblocked = 0
        self._nparked = 0
        self._parks_total = 0  # cumulative park events (occupancy sampler)
        for _ in range(self.concurrency):
            self._add_worker()

    # ---- spawning ----------------------------------------------------------
    def spawn(self, fn: Callable, *args, urgent: bool = False) -> Task:
        """Analog of bthread_start_background/urgent."""
        task = Task(fn, args)
        group = getattr(_tls, "group", None)
        if group is not None and group.control is self:
            group.push(task, urgent)
        else:
            with self._remote_lock:
                self._remote_q.append(task)
        self._lot.signal(1)
        self._maybe_grow()
        return task

    def _maybe_grow(self):
        # If every worker is occupied by a *blocked* task, runnable work
        # would starve — grow the pool (replacement for bthread context
        # switch). Parked workers are idle capacity, not a reason to grow.
        if self._nblocked >= self._nworkers and self._nworkers < self.max_workers:
            with self._lock:
                if self._nworkers < self.max_workers and not self._stopped:
                    self._add_worker_locked()

    def _add_worker(self):
        with self._lock:
            self._add_worker_locked()

    def _add_worker_locked(self):
        wid = self._nworkers
        self._nworkers += 1
        group = TaskGroup(self, wid)
        self._groups.append(group)
        t = threading.Thread(
            target=self._worker_main, args=(group,), daemon=True, name=f"tpubrpc-w{wid}"
        )
        t.start()

    # ---- worker loop (run_main_task, task_group.cpp:145) -------------------
    def _worker_main(self, group: TaskGroup):
        _tls.group = group
        while not self._stopped:
            task = self._wait_task(group)
            if task is not None:
                group.runs += 1
                task.run()

    def _wait_task(self, group: TaskGroup) -> Optional[Task]:
        """Analog of TaskGroup::wait_task (task_group.cpp:118)."""
        task = group.pop()
        if task is not None:
            return task
        with self._remote_lock:
            if self._remote_q:
                return self._remote_q.popleft()
        task = self._steal_task(group)
        if task is not None:
            group.steals += 1
            return task
        self._nparked += 1
        self._parks_total += 1
        try:
            self._lot.wait(timeout=0.1)
        finally:
            self._nparked -= 1
        return None

    def _steal_task(self, group: TaskGroup) -> Optional[Task]:
        groups = self._groups
        n = len(groups)
        if n <= 1:
            return None
        start = random.randrange(n)
        for i in range(n):
            victim = groups[(start + i) % n]
            if victim is group:
                continue
            task = victim.steal()
            if task is not None:
                return task
        return None

    # ---- blocking integration (butex calls these) --------------------------
    def on_task_block(self):
        self._nblocked += 1
        self._maybe_grow()

    def on_task_unblock(self):
        self._nblocked -= 1

    def stop(self):
        self._stopped = True
        self._lot.signal(self.max_workers)

    # ---- introspection ------------------------------------------------------
    def worker_count(self) -> int:
        return self._nworkers

    def blocked_count(self) -> int:
        return self._nblocked

    def parked_count(self) -> int:
        return self._nparked

    def parks_total(self) -> int:
        return self._parks_total

    def steals_total(self) -> int:
        return sum(g.steals for g in self._groups)

    def runs_total(self) -> int:
        return sum(g.runs for g in list(self._groups))

    def runqueue_depth(self) -> int:
        return sum(len(g.rq) for g in self._groups) + len(self._remote_q)

    def occupancy_snapshot(self) -> dict:
        """Point-in-time occupancy state for /hotspots/runtime: totals
        plus one row per worker (run-queue depth, steals, runs).  len()
        on a deque is GIL-atomic, so no victim locks are taken."""
        workers = [
            {
                "worker_id": g.worker_id,
                "rq_depth": len(g.rq),
                "steals": g.steals,
                "runs": g.runs,
            }
            for g in list(self._groups)
        ]
        return {
            "workers": self._nworkers,
            "blocked": self._nblocked,
            "parked": self._nparked,
            "parks_total": self._parks_total,
            "steals_total": sum(w["steals"] for w in workers),
            "remote_q": len(self._remote_q),
            "per_worker": workers,
        }


_default_control: Optional[TaskControl] = None
_default_lock = threading.Lock()


def get_task_control() -> TaskControl:
    global _default_control
    if _default_control is None:
        with _default_lock:
            if _default_control is None:
                _default_control = TaskControl()
                from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus

                PassiveStatus(handoffs_total).expose("runtime_handoffs")
    return _default_control


def spawn(fn: Callable, *args) -> Task:
    return get_task_control().spawn(fn, *args)


def spawn_urgent(fn: Callable, *args) -> Task:
    return get_task_control().spawn(fn, *args, urgent=True)


def handoffs_total() -> int:
    """Tasks begun on a thread other than the one that queued them, so
    far: every task a runtime worker ran (ExecutionQueue consumers
    included; ``execute_or_inline`` runs done in place are not tasks)
    and every timer the default timer thread fired."""
    from incubator_brpc_tpu_torch.runtime.timer_thread import fired_total

    control = _default_control
    return (control.runs_total() if control is not None else 0) + fired_total()


def in_worker() -> bool:
    return getattr(_tls, "group", None) is not None
