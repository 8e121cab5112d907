"""Process-global one-time initialisation.

Analog of reference GlobalInitializeOrDie (global.cpp:379-580): runs
once, registers every built-in protocol, naming service, load balancer
and compress handler, and exposes default process variables. Called by
Server.start and Channel.init (the reference calls it from both too).
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
        from incubator_brpc_tpu_torch.protocols import tpu_std

        tpu_std.register()
        try:
            from incubator_brpc_tpu_torch.protocols import streaming

            streaming.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import http as http_proto

            http_proto.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import h2 as h2_proto

            h2_proto.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import redis as redis_proto

            redis_proto.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import memcache as memcache_proto

            memcache_proto.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import thrift as thrift_proto

            thrift_proto.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import mongo as mongo_proto

            mongo_proto.register()
        except ImportError:
            pass
        try:
            from incubator_brpc_tpu_torch.protocols import rtmp as rtmp_proto

            rtmp_proto.register()
        except ImportError:
            pass
        try:
            # LAST: esp is headerless and must sit at the chain's end
            from incubator_brpc_tpu_torch.protocols import legacy as legacy_protos

            legacy_protos.register()
        except ImportError:
            pass
        # naming services + load balancers self-register on import
        try:
            from incubator_brpc_tpu_torch.client import naming_service  # noqa: F401
            from incubator_brpc_tpu_torch.client import naming_remote  # noqa: F401
            from incubator_brpc_tpu_torch.client import load_balancer  # noqa: F401
        except ImportError:
            pass
        from incubator_brpc_tpu_torch.metrics.default_variables import (
            expose_default_variables,
        )

        expose_default_variables()
        _done = True
