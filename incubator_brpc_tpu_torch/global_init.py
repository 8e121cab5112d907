"""Process-global one-time initialisation.

Analog of reference GlobalInitializeOrDie (global.cpp:379-580): runs
once, registers every built-in protocol, naming service, load balancer
and compress handler, and exposes default process variables. Called by
Server.start and Channel.init (the reference calls it from both too).

The port imports every protocol without a guard, so a broken one fails
here; the registration order is the JAX package's, with legacy (and so
the headerless esp) last.
"""

from __future__ import annotations

import threading

_once = threading.Lock()
_done = False


def global_init():
    global _done
    if _done:
        return
    with _once:
        if _done:
            return
        from incubator_brpc_tpu_torch.protocols import h2 as h2_proto
        from incubator_brpc_tpu_torch.protocols import http as http_proto
        from incubator_brpc_tpu_torch.protocols import legacy as legacy_protos
        from incubator_brpc_tpu_torch.protocols import memcache as memcache_proto
        from incubator_brpc_tpu_torch.protocols import mongo as mongo_proto
        from incubator_brpc_tpu_torch.protocols import redis as redis_proto
        from incubator_brpc_tpu_torch.protocols import rtmp as rtmp_proto
        from incubator_brpc_tpu_torch.protocols import streaming
        from incubator_brpc_tpu_torch.protocols import thrift as thrift_proto
        from incubator_brpc_tpu_torch.protocols import tpu_std

        tpu_std.register()
        streaming.register()
        http_proto.register()
        h2_proto.register()
        redis_proto.register()
        memcache_proto.register()
        thrift_proto.register()
        mongo_proto.register()
        rtmp_proto.register()
        # LAST: esp is headerless and must sit at the chain's end
        legacy_protos.register()
        # naming services + load balancers self-register on import
        from incubator_brpc_tpu_torch.client import naming_service  # noqa: F401
        from incubator_brpc_tpu_torch.client import naming_remote  # noqa: F401
        from incubator_brpc_tpu_torch.client import load_balancer  # noqa: F401
        from incubator_brpc_tpu_torch.metrics.default_variables import (
            expose_default_variables,
        )

        expose_default_variables()
        _done = True
