"""Service definition model.

The reference uses protobuf generated services
(google::protobuf::Service; registration at server.cpp:1470 builds
fullname→method maps). Python protobuf dropped generic services, so the
TPU build declares services as classes with @rpc_method-decorated
handlers over protobuf message classes — same shape, same registry:
``Server.add_service`` builds the (service_name, method_name) →
MethodSpec map, and client stubs are generated from the same specs.

Handler signature (identical contract to the reference's CallMethod):
    def Echo(self, controller, request, response, done):
        ...fill response...
        done()       # MUST run exactly once, may be called later (async)
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Type


@dataclass
class MethodSpec:
    service_name: str
    method_name: str
    request_class: type
    response_class: type
    fn: Optional[Callable] = None  # bound at add_service time
    # batched-method registration (see batched_method below): the raw
    # batch-signature handler + its default BatchPolicy.  The server
    # builds a Batcher from these when batching is enabled; otherwise
    # `fn` (the synthesized single-request adapter) serves the method
    # on the existing dispatch path unchanged.
    batch_fn: Optional[Callable] = None
    batch_policy: Optional[object] = None

    @property
    def full_name(self) -> str:
        return f"{self.service_name}.{self.method_name}"


def rpc_method(request_class: type, response_class: type):
    """Mark a Service method as an RPC method with its message types."""

    def deco(fn):
        fn.__rpc_spec__ = (request_class, response_class)
        return fn

    return deco


def batched_method(request_class: type, response_class: type, policy=None):
    """Mark a BATCH-signature handler as an RPC method eligible for
    server-side micro-batching (docs/batching.md).  The decorated
    function takes parallel LISTS — one entry per coalesced request —
    and ONE done that completes them all:

        @batched_method(EchoRequest, EchoResponse,
                        policy=BatchPolicy(max_batch_size=32))
        def Get(self, controllers, requests, responses, done):
            ...fill responses[i] / controllers[i].set_failed(...)...
            done()      # exactly once; scatters per-row responses

    The decorator synthesizes a single-request adapter with the normal
    handler signature, so the method ALSO serves the existing dispatch
    path — unbatched servers, the batching-off config, and stubs see no
    difference (the adapter's cost is three list wraps).  Per-row
    failure = set_failed on that row's controller; batch-mates are
    unaffected.
    """
    from incubator_brpc_tpu_torch.batching.policy import BatchPolicy

    batch_policy = policy if policy is not None else BatchPolicy()

    def deco(fn):
        def single(self, controller, request, response, done):
            fn(self, [controller], [request], [response], done)

        single.__name__ = fn.__name__
        single.__qualname__ = getattr(fn, "__qualname__", fn.__name__)
        single.__doc__ = fn.__doc__
        single.__rpc_spec__ = (request_class, response_class)
        single.__batch_fn__ = fn
        single.__batch_policy__ = batch_policy
        return single

    return deco


class Service:
    """Base class for RPC services."""

    @classmethod
    def service_name(cls) -> str:
        return getattr(cls, "SERVICE_NAME", cls.__name__)

    @classmethod
    def method_specs(cls) -> Dict[str, MethodSpec]:
        """Walk the MRO so a subclass overriding a decorated method (a
        common test pattern: fault-injecting Echo) keeps the spec."""
        specs: Dict[str, MethodSpec] = {}
        for klass in cls.__mro__:
            for name, member in vars(klass).items():
                if name in specs:
                    continue
                spec = getattr(member, "__rpc_spec__", None)
                if spec is not None:
                    req_cls, res_cls = spec
                    specs[name] = MethodSpec(
                        cls.service_name(), name, req_cls, res_cls,
                        batch_fn=getattr(member, "__batch_fn__", None),
                        batch_policy=getattr(member, "__batch_policy__", None),
                    )
        return specs


# Sentinel response: skip response-object parsing entirely — the raw
# response payload lands on controller.response_bytes (native fast path;
# see docs/fastpath.md).  Pairs with passing an already-serialized
# `bytes` request: zero protobuf object work per call.
RAW_RESPONSE = object()


class ServiceStub:
    """Client-side stub generated from a Service class (analog of the
    pb-generated EchoService_Stub).

    stub = ServiceStub(channel, EchoService)
    stub.Echo(cntl, request)               -> response (sync)
    stub.Echo(cntl, request, done=fn)      -> response obj (async; done()
                                              runs when the RPC ends)
    stub.Echo(cntl, payload_bytes, response=RAW_RESPONSE)
                                           -> bytes mode: request is the
                                              serialized pb, reply bytes
                                              on cntl.response_bytes
    """

    def __init__(self, channel, service_cls: Type[Service]):
        self._channel = channel
        specs = service_cls.method_specs()
        self._method_specs = specs
        idx = {n: i for i, n in enumerate(sorted(specs))}
        for name, spec in specs.items():
            # index-addressed legacy protocols (hulu/nova/public) use
            # the method's position in sorted name order as its id
            spec._public_method_id = spec._nova_index = idx[name]
            setattr(self, name, self._make_method(spec))

    def method_spec(self, name: str) -> MethodSpec:
        """The MethodSpec behind a stub method — what Channel.call_many
        and SubmissionRing.submit take as their method argument."""
        return self._method_specs[name]

    def call_many(self, name: str, requests, timeout_ms=None,
                  controllers=None):
        """Vectorized convenience: Channel.call_many over this stub's
        method `name` (see client/channel.py for the full contract)."""
        return self._channel.call_many(
            self._method_specs[name], requests, timeout_ms, controllers
        )

    def _make_method(self, spec: MethodSpec):
        def call(controller, request, response=None, done=None):
            if response is None:
                response = spec.response_class()
            elif response is RAW_RESPONSE:
                response = None
            self._channel.call_method(spec, controller, request, response, done)
            return response

        call.__name__ = spec.method_name
        return call
