"""SSL/TLS helpers — context construction from option structs.

Analog of reference details/ssl_helper.{h,cpp} (CreateClientSSLContext /
CreateServerSSLContext) and the SSL option structs of channel.h /
server.h (ChannelSSLOptions, ServerSSLOptions, CertInfo).  The state
machine the reference hand-rolls over OpenSSL BIOs (SSLState on Socket,
socket.h:205 region) maps onto Python's ``ssl.SSLSocket`` here: the
handshake runs blocking-with-timeout on the connecting/accepting task
(the Python transport already does blocking connects on worker tasks),
after which the socket returns to non-blocking mode and the epoll loops
treat ``SSLWantReadError``/``SSLWantWriteError`` as EAGAIN
(utils/iobuf.py translates them).

TLS 1.3 never renegotiates, and for 1.2 we disable renegotiation where
OpenSSL allows, so the want-read-on-write cross-signal case the
reference's state machine handles cannot occur post-handshake.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass
from typing import Optional


@dataclass
class CertInfo:
    """A certificate + private key pair (reference CertInfo,
    server.h: certificate/private_key support PEM paths)."""

    certificate: str = ""  # PEM file path
    private_key: str = ""  # PEM file path


@dataclass
class ChannelSSLOptions:
    """Mirrors reference ChannelSSLOptions (ssl_options.h): client-side
    TLS knobs.  Default: TLS on, peer verification OFF (the reference
    default — verify.ca_file_path empty skips verification)."""

    sni_name: str = ""  # server_hostname for SNI + hostname check
    ca_file: str = ""   # non-empty → verify the server cert against it
    verify_hostname: bool = False  # also match sni_name against the cert
    client_cert: Optional[CertInfo] = None  # mutual-TLS client identity
    ciphers: str = ""
    protocols: str = ""  # reserved (ALPN), parity with reference field


@dataclass
class ServerSSLOptions:
    """Mirrors reference ServerSSLOptions (ssl_options.h): the default
    cert served on TLS connections + optional client-cert verification.
    ``alpns`` mirrors the reference's alpns field — a sequence of
    tokens, or the reference's comma-separated string form; gRPC
    clients require the "h2" token during the handshake."""

    default_cert: CertInfo = None
    verify_client_ca_file: str = ""  # non-empty → require client certs
    ciphers: str = ""
    alpns: tuple = ("h2", "http/1.1")


def _no_renegotiation(ctx: ssl.SSLContext) -> None:
    # TLS 1.2 renegotiation would surface want-read-on-write mid-stream,
    # which the epoll write path maps to "wait for EPOLLOUT" — a stall.
    # Disabling it makes the module invariant (no cross-signals after
    # the handshake) actually true.
    ctx.options |= ssl.OP_NO_RENEGOTIATION


def make_client_context(opts: ChannelSSLOptions) -> ssl.SSLContext:
    """Build the client SSLContext (CreateClientSSLContext analog)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    _no_renegotiation(ctx)
    if opts.verify_hostname and not opts.sni_name:
        # silently skipping the check the caller asked for would let any
        # same-CA cert impersonate the server
        raise ValueError("verify_hostname=True requires sni_name")
    if opts.ca_file:
        ctx.load_verify_locations(cafile=opts.ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
        ctx.check_hostname = bool(opts.verify_hostname and opts.sni_name)
    else:
        # reference default: no CA configured → no verification
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    if opts.client_cert is not None and opts.client_cert.certificate:
        ctx.load_cert_chain(
            opts.client_cert.certificate,
            opts.client_cert.private_key or None,
        )
    if opts.ciphers:
        ctx.set_ciphers(opts.ciphers)
    return ctx


def wrap_server_side(conn, ctx: ssl.SSLContext, timeout_s: float, peer,
                     log_error):
    """Shared server-side handshake: blocking with timeout, returns the
    wrapped socket (timeout cleared) or None after logging + closing.
    Used by the RPC acceptor and the DCN bridge so the two can't drift."""
    try:
        conn.settimeout(timeout_s)
        wrapped = ctx.wrap_socket(conn, server_side=True)
        wrapped.settimeout(None)
        return wrapped
    except (OSError, ssl.SSLError) as e:
        log_error("TLS accept from %s failed: %r", peer, e)
        try:
            conn.close()
        except OSError:
            pass
        return None


def make_server_context(opts: ServerSSLOptions) -> ssl.SSLContext:
    """Build the server SSLContext (CreateServerSSLContext analog)."""
    if opts.default_cert is None or not opts.default_cert.certificate:
        raise ValueError("ServerSSLOptions.default_cert.certificate required")
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    _no_renegotiation(ctx)
    ctx.load_cert_chain(
        opts.default_cert.certificate, opts.default_cert.private_key or None
    )
    if opts.verify_client_ca_file:
        ctx.load_verify_locations(cafile=opts.verify_client_ca_file)
        ctx.verify_mode = ssl.CERT_REQUIRED
    if opts.ciphers:
        ctx.set_ciphers(opts.ciphers)
    if opts.alpns:
        # the multi-protocol port negotiates whatever it actually
        # speaks; gRPC clients refuse to proceed without "h2".
        # Accept the reference's comma-list string form too — list()
        # on a string would advertise bogus one-byte protocols.
        alpns = opts.alpns
        if isinstance(alpns, str):
            alpns = [t.strip() for t in alpns.split(",") if t.strip()]
        try:
            ctx.set_alpn_protocols(list(alpns))
        except NotImplementedError:  # openssl built without ALPN
            pass
    return ctx
