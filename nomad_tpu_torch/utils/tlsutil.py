"""mTLS context construction for the wire protocols.

Reference: helper/tlsutil/config.go — the reference builds one
tls.Config used by both the RPC listener and outgoing conns
(VerifyIncoming/VerifyOutgoing, CA + node cert/key). Here the same
triple (ca, cert, key) produces a pair of stdlib ssl contexts:

- server_context: terminates TLS and REQUIRES a client cert signed by
  the CA (mutual auth — a plaintext or unauthenticated peer fails the
  handshake, nomad/rpc.go:23-30's rpcTLS discipline);
- client_context: presents the node cert and verifies the server chain
  against the same CA. Hostname checking is off: cluster certs are
  issued per role, peers are addressed by ephemeral host:port
  (config.go VerifyServerHostname defaults false).
"""

from __future__ import annotations

import ssl
from typing import Optional


class TLSConfigError(Exception):
    pass


def _load(ctx: ssl.SSLContext, ca_file: str, cert_file: str,
          key_file: str) -> ssl.SSLContext:
    try:
        ctx.load_cert_chain(cert_file, key_file)
        ctx.load_verify_locations(ca_file)
    except (OSError, ssl.SSLError) as e:
        raise TLSConfigError(f"loading TLS material: {e}") from e
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    return ctx


def server_context(ca_file: str, cert_file: str, key_file: str,
                   verify_client: bool = True) -> ssl.SSLContext:
    """verify_client=True is the raft-transport discipline (mutual
    auth, rpc.go VerifyIncoming); the HTTP API defaults to server-only
    TLS like the reference (VerifyHTTPSClient false)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    if verify_client:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return _load(ctx, ca_file, cert_file, key_file)


def client_context(ca_file: str, cert_file: str,
                   key_file: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_REQUIRED
    return _load(ctx, ca_file, cert_file, key_file)


def contexts_from_block(
    tls,
) -> "tuple[Optional[ssl.SSLContext], Optional[ssl.SSLContext], Optional[ssl.SSLContext]]":
    """(rpc_server_ctx, http_server_ctx, client_ctx) from an agent
    TLSBlock (cli/agent_config.py); all None when TLS is off. The raft
    channel is mutual, the HTTP channel server-only, and the client
    context serves both outgoing HTTP and outgoing raft."""
    if not getattr(tls, "enabled", False):
        return None, None, None
    ca, cert, key = tls.ca_file, tls.cert_file, tls.key_file
    if not (ca and cert and key):
        raise TLSConfigError(
            "tls.enabled requires ca_file, cert_file and key_file")
    rpc_ctx = (server_context(ca, cert, key, verify_client=True)
               if tls.rpc else None)
    http_ctx = (server_context(ca, cert, key, verify_client=False)
                if tls.http else None)
    return rpc_ctx, http_ctx, client_context(ca, cert, key)
