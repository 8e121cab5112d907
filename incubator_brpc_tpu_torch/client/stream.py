"""Compatibility shim — the streaming subsystem grew into its own
package (incubator_brpc_tpu/streaming/); the Stream API is re-exported
here because streams are negotiated from the client Controller and
existing code imports them from this path."""

from incubator_brpc_tpu_torch.streaming.stream import (  # noqa: F401
    Stream,
    StreamHandler,
    StreamOptions,
)
