"""Authenticator — connection-level authentication.

Analog of reference brpc::Authenticator (authenticator.h): the client
packs ``generate_credential()`` into the first message it sends on a
connection (we attach it to every tpu_std request meta / http request —
a few bytes — which keeps concurrent-first-write races and pooled/short
reconnects trivially correct); the server verifies the FIRST message on
each connection through the protocol ``verify`` hook
(input_messenger.cpp:282-300) and drops the connection on mismatch.

Usage:
    class MyAuth(Authenticator):
        def generate_credential(self) -> str: ...
        def verify_credential(self, auth_str, peer) -> int: ...  # 0 = ok

    ChannelOptions(auth=MyAuth())   # client side
    ServerOptions(auth=MyAuth())    # server side
"""

from __future__ import annotations

from typing import Optional

from incubator_brpc_tpu_torch.utils.endpoint import EndPoint


class AuthContext:
    """What a verified credential resolved to (reference AuthContext):
    attached to the server connection for handlers to inspect."""

    __slots__ = ("user", "group", "roles", "starter", "is_service")

    def __init__(self, user="", group="", roles="", starter="", is_service=False):
        self.user = user
        self.group = group
        self.roles = roles
        self.starter = starter
        self.is_service = is_service


class Authenticator:
    def generate_credential(self) -> str:
        """Client side: the credential string packed into request meta.
        Raise or return "" to send nothing."""
        raise NotImplementedError

    def verify_credential(
        self, auth_str: str, peer: Optional[EndPoint], context: "AuthContext" = None
    ) -> int:
        """Server side: 0 accepts; nonzero rejects (connection closes /
        gRPC UNAUTHENTICATED). Implementations taking the third
        parameter may fill ``context`` with the resolved identity; on
        success it is attached to the connection and handlers read it
        via ``Controller.auth_context()``. Two-parameter overrides
        (without ``context``) are also accepted."""
        raise NotImplementedError


class CouchbaseAuthenticator(Authenticator):
    """SASL PLAIN credential for couchbase buckets (reference
    policy/couchbase_authenticator.cpp:38-55): the credential is a
    complete memcache-binary SASL_AUTH request — magic 0x80, opcode
    0x21, key "PLAIN", value "<bucket>\\0<bucket>\\0<password>" — sent
    as the first bytes of the connection so the couchbase server
    authenticates the bucket before any command runs."""

    MC_MAGIC_REQUEST = 0x80
    MC_BINARY_SASL_AUTH = 0x21

    def __init__(self, bucket_name: str, bucket_password: str):
        self.bucket_name = bucket_name
        self.bucket_password = bucket_password

    def generate_credential(self) -> str:
        import struct

        key = b"PLAIN"
        value = (
            self.bucket_name.encode() + b"\0"
            + self.bucket_name.encode() + b"\0"
            + self.bucket_password.encode()
        )
        header = struct.pack(
            ">BBHBBHIIQ",
            self.MC_MAGIC_REQUEST, self.MC_BINARY_SASL_AUTH,
            len(key),  # key length
            0, 0, 0,  # extras len, data type, vbucket
            len(key) + len(value),  # total body
            0, 0,  # opaque, cas
        )
        return (header + key + value).decode("latin1")

    def verify_credential(self, auth_str, peer, context=None) -> int:
        # client-only authenticator: the couchbase SERVER verifies
        return 0


class EspAuthenticator(Authenticator):
    """esp service credential (reference policy/esp_authenticator.cpp):
    a fixed magic preamble plus the 2-byte local port.  Verify accepts
    everything — parity with the reference, whose VerifyCredential is
    an explicit no-op."""

    MAGICNUM = b"\0ESP\x01\x02"

    def __init__(self, local_port: int = 0):
        self.local_port = local_port

    def generate_credential(self) -> str:
        import struct

        return (
            self.MAGICNUM + struct.pack("<H", self.local_port)
        ).decode("latin1")

    def verify_credential(self, auth_str, peer, context=None) -> int:
        return 0  # reference EspAuthenticator::VerifyCredential: no-op
