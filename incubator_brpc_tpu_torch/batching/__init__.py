"""Adaptive micro-batching — deadline-aware request coalescing.

The server-side symmetric half of the collective *merge* lowerings in
``parallel/collectives.py``: where those fuse a fan-out's N partial
responses into one collective, this subsystem fuses N concurrent
same-method requests into ONE batched user-handler execution (the
continuous-batching shape of inference serving, grafted onto the brpc
server stack).  See docs/batching.md.

Layers:
  policy.py   BatchPolicy — per-method coalescing knobs + deadline guard
  batcher.py  Batcher — accumulate / flush / shed / scatter
  fused.py    padded-stack device fusion with bounded jit retraces
"""

from incubator_brpc_tpu_torch.batching.policy import BatchPolicy

# batcher/fused re-exports are lazy (PEP 562): BatchPolicy is imported
# at service-class-definition time (the @batched_method decorator) and
# must stay dependency-free — eagerly pulling batcher.py here would
# drag the chaos/metrics/runtime stack into every service definition
_LAZY = {
    "Batcher": ("incubator_brpc_tpu_torch.batching.batcher", "Batcher"),
    "BatchContext": ("incubator_brpc_tpu_torch.batching.batcher", "BatchContext"),
    "current_batch": ("incubator_brpc_tpu_torch.batching.batcher", "current_batch"),
    "FusedKernel": ("incubator_brpc_tpu_torch.batching.fused", "FusedKernel"),
    "fused_stack_rows": ("incubator_brpc_tpu_torch.batching.fused",
                         "fused_stack_rows"),
}


def __getattr__(name):
    try:
        mod_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(mod_name), attr)


__all__ = [
    "BatchPolicy",
    "Batcher",
    "BatchContext",
    "current_batch",
    "FusedKernel",
    "fused_stack_rows",
]
