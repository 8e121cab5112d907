"""Pluggable protocol layer (analog of reference src/brpc/protocol.h).

The key inversion preserved from the reference (SURVEY.md §1): the
transport knows nothing about any protocol. Protocols register a table
of callbacks (``struct Protocol``'s 7 function pointers,
protocol.h:77-172) and the InputMessenger tries parsers in order,
caching the matched index per socket, so one server port speaks all
protocols.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional


class ParseError(enum.Enum):
    OK = 0
    NOT_ENOUGH_DATA = 1  # keep bytes, wait for more
    TRY_OTHERS = 2  # didn't match magic: try the next protocol
    BAD_FORMAT = 3  # matched but malformed: close the connection


@dataclass
class ParseResult:
    error: ParseError
    message: object = None  # protocol-specific parsed message

    @staticmethod
    def ok(msg) -> "ParseResult":
        return ParseResult(ParseError.OK, msg)

    @staticmethod
    def not_enough() -> "ParseResult":
        return ParseResult(ParseError.NOT_ENOUGH_DATA)

    @staticmethod
    def try_others() -> "ParseResult":
        return ParseResult(ParseError.TRY_OTHERS)

    @staticmethod
    def bad() -> "ParseResult":
        return ParseResult(ParseError.BAD_FORMAT)


@dataclass
class Protocol:
    """The protocol vtable (reference protocol.h:77-172).

    - parse(iobuf, socket, read_eof) -> ParseResult: cut one message.
    - serialize_request(request, controller) -> IOBuf: called ONCE per
      RPC (channel.cpp:517).
    - pack_request(request_buf, cid, method_spec, controller) -> IOBuf:
      called per send, including retries (controller.cpp:1140).
    - process_request(msg_obj, socket): server side, runs in a task.
    - process_response(msg_obj, socket): client side, runs in a task.
    - verify(msg_obj, socket) -> bool: first-message auth on a server
      connection (input_messenger.cpp:282-300).
    - parse_server_address(url) -> bool: whether this protocol supports
      the given scheme for client channels.
    """

    name: str
    parse: Callable = None
    serialize_request: Callable = None
    pack_request: Callable = None
    process_request: Callable = None
    process_response: Callable = None
    verify: Callable = None
    support_client: bool = True
    support_server: bool = True
    # pipelined protocols (redis/memcache) answer in order on one socket
    support_pipelined: bool = False
    # process in the read task instead of a fresh task per message:
    # required by protocols whose messages must keep arrival order
    # (streaming frames route to per-stream execution queues)
    process_in_place: bool = False
    # process messages of one connection sequentially in arrival order,
    # but OFF the read task (per-socket ExecutionQueue). Required by
    # correlation-less protocols (HTTP/1.x) where the client matches
    # responses FIFO: parallel server dispatch would let a fast later
    # handler overtake a slow earlier one and misroute both responses.
    process_ordered: bool = False
    # the protocol authenticates INSIDE its own message flow (h2 checks
    # the authorization header per stream) — exempts it from the
    # first-message verify gate on auth-enforcing servers; a protocol
    # with neither verify nor this flag is rejected there outright
    auth_in_protocol: bool = False
    # stateful-connection protocols (h2: per-connection HPACK tables +
    # stream ids) send through this instead of pack_request+write —
    # issue(sock, request_buf, wire_cid, method_spec, controller) packs
    # and writes atomically under the connection's encode order lock
    issue: Callable = None
    # pack_cancel(wire_cid) -> IOBuf: a cancel frame for an abandoned
    # in-flight request (hedged-request loser cancellation).  Protocols
    # without one simply leave the loser to finish server-side.
    pack_cancel: Callable = None


def accumulate_pipelined(sock, item):
    """Shared FIFO accumulator for pipelined protocols (redis/memcache):
    append one parsed reply for the FIFO-front RPC; when its count is
    reached, pop the entry and return (cid, items) — else None. Runs
    under the socket's write lock (pipelined_info's lock)."""
    with sock._write_lock:
        if not sock.pipelined_info:
            return None  # stray reply (RPC already failed): drop
        cid, count = sock.pipelined_info[0]
        sock._pipelined_acc.append(item)
        if len(sock._pipelined_acc) < count:
            return None
        sock.pipelined_info.popleft()
        items, sock._pipelined_acc = sock._pipelined_acc, []
        return cid, items


def _call_verify_credential(auth, auth_str: str, sock, attach_to_sock: bool = True):
    """Run a server authenticator. Returns (rc, AuthContext). On
    success the context attaches to the connection (reference
    VerifyCredential's out param; handlers read it via
    Controller.auth_context()) — except for per-request verification
    (h2 streams), where the caller attaches it to the request instead
    (attach_to_sock=False). Accepts both verify_credential(auth_str,
    peer) and (auth_str, peer, context) overrides."""
    from incubator_brpc_tpu_torch.client.auth import AuthContext
    from incubator_brpc_tpu_torch.utils.logging import log_error

    ctx = AuthContext()
    try:
        # arity probed once per authenticator, not per request (this is
        # the per-stream hot path on h2 servers)
        nparams = getattr(auth, "_verify_nparams", None)
        if nparams is None:
            import inspect

            try:
                nparams = len(inspect.signature(auth.verify_credential).parameters)
            except (TypeError, ValueError):
                nparams = 2
            try:
                auth._verify_nparams = nparams
            except AttributeError:
                pass  # __slots__ authenticator: re-probe each time
        if nparams >= 3:
            rc = auth.verify_credential(auth_str, sock.remote, ctx)
        else:
            rc = auth.verify_credential(auth_str, sock.remote)
    except Exception as e:  # noqa: BLE001
        log_error("verify_credential raised: %r", e)
        return -1, ctx
    if rc == 0 and attach_to_sock:
        sock.auth_context = ctx
    return rc, ctx


_protocols: List[Protocol] = []


def register_protocol(p: Protocol) -> None:
    """Analog of RegisterProtocol (protocol.h:186); called by
    global_init for every built-in protocol (global.cpp:399-580)."""
    for existing in _protocols:
        if existing.name == p.name:
            return
    _protocols.append(p)


def list_protocols() -> List[Protocol]:
    return list(_protocols)


def find_protocol(name: str) -> Optional[Protocol]:
    for p in _protocols:
        if p.name == name:
            return p
    return None
