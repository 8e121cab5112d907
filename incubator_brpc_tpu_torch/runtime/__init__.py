"""Task runtime — the bthread analog (reference src/bthread/).

The reference implements M:N user-space threads with hand-written
context-switch assembly (bthread/context.cpp), per-worker work-stealing
run queues (task_group.cpp), futex-based parking (parking_lot.h), and a
butex primitive unifying all blocking (butex.cpp).

The TPU rebuild keeps the *architecture* — TaskControl owning worker
groups with work-stealing deques and a parking lot, butex as the single
blocking primitive, versioned correlation ids, execution queues, one
timer thread — on top of OS threads (CPython can't swap user-space
stacks; the GIL already serializes compute, and the RPC hot path is IO
where threads release the GIL). TaskControl grows workers adaptively
when tasks block, preserving bthread's "blocking a task never stalls
the event loop" property that the M:N design exists for.
"""

from incubator_brpc_tpu_torch.runtime.scheduler import (  # noqa: F401
    TaskControl,
    get_task_control,
    spawn,
    spawn_urgent,
)
from incubator_brpc_tpu_torch.runtime.butex import Butex  # noqa: F401
from incubator_brpc_tpu_torch.runtime.call_id import CallIdPool, INVALID_CALL_ID  # noqa: F401
from incubator_brpc_tpu_torch.runtime.execution_queue import ExecutionQueue  # noqa: F401
from incubator_brpc_tpu_torch.runtime.timer_thread import TimerThread, get_timer_thread  # noqa: F401
from incubator_brpc_tpu_torch.runtime.sync import CountdownEvent  # noqa: F401
