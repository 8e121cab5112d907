"""Metrics layer — the bvar analog (reference src/bvar/).

Write-path design follows the reference (reducer.h:69): each writer
thread owns an *agent* holding a private partial value — writes are
uncontended (~ns in the reference); reads combine all agents (~µs).
Everything above instruments itself with these at construction, exactly
as brpc does (SURVEY.md §7 step 3).
"""

from incubator_brpc_tpu_torch.metrics.variable import (  # noqa: F401
    Variable,
    dump_exposed,
    list_exposed,
    describe_exposed,
)
from incubator_brpc_tpu_torch.metrics.reducer import Adder, Maxer, Miner  # noqa: F401
from incubator_brpc_tpu_torch.metrics.window import Window, PerSecond  # noqa: F401
from incubator_brpc_tpu_torch.metrics.recorder import IntRecorder  # noqa: F401
from incubator_brpc_tpu_torch.metrics.latency_recorder import LatencyRecorder  # noqa: F401
from incubator_brpc_tpu_torch.metrics.passive_status import PassiveStatus, Status  # noqa: F401
from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension  # noqa: F401
from incubator_brpc_tpu_torch.metrics.collector import Collected, get_collector  # noqa: F401
