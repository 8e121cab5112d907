"""Streaming RPC subsystem — flow-controlled streams over the shared
connection (host TCP or ICI/DCN fabric) plus the token-streaming
generate service built on them.

Layers (docs/streaming.md):
  protocols/streaming.py   wire frames (DATA/DATA_PART/FEEDBACK/RST/
                           CLOSE/HALF_CLOSE) multiplexed on the socket
  streaming/stream.py      the Stream state machine: StreamWait flow
                           control, half-close, idle timeout, chunked
                           writes via the shared segmentation policy
  streaming/observe.py     live-stream registry + rpc_stream_* metrics
  streaming/generate.py    continuous-batched token-streaming
                           inference: DecodeLoop + GenerateService
"""

from incubator_brpc_tpu_torch.streaming.stream import (  # noqa: F401
    Stream,
    StreamHandler,
    StreamOptions,
)


def __getattr__(name):
    # generate.py pulls in jax/numpy via batching.fused — lazy so that
    # plain stream users never pay for it
    if name in ("GenerateService", "DecodeLoop", "GenPolicy"):
        from incubator_brpc_tpu_torch.streaming import generate

        return getattr(generate, name)
    raise AttributeError(name)
