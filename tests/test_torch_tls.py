"""mTLS on the port's wire protocols (nomad_tpu_torch/utils/tlsutil.py;
reference rpc.go:23-30 rpcTLS) and the raft transport's keep-alive
connection pool (reference pool.go:144): the raft, transport and gossip
cases of tests/test_tls.py on the port.

- a raft cluster forms and replicates over mutual TLS;
- a plaintext (or wrong-CA) peer is rejected at the handshake;
- transport connections are pooled: a heartbeat storm rides O(1)
  sockets per peer, not one per message;
- gossip rides the same mTLS and refuses a plaintext member;
- the keep-alive retry dials fresh after a peer restart.
"""

import datetime
import threading
import time

import pytest

# utils.tlsutil mints certificates through the optional `cryptography`
# package; a container without it must SKIP this module cleanly
# instead of erroring tier-1 collection.
pytest.importorskip("cryptography")

import torch_parity  # noqa: E402,F401  (the port on the CPU)
from nomad_tpu_torch import mock  # noqa: E402
from nomad_tpu_torch.server.raft import RaftNode  # noqa: E402
from nomad_tpu_torch.server.transport import (  # noqa: E402
    TCPTransport,
    fsm_payload_decoder,
)
from nomad_tpu_torch.utils import tlsutil  # noqa: E402


def wait_until(fn, timeout=20.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A CA plus one node cert (SAN 127.0.0.1/localhost), written as
    PEM files the way an operator would provide them."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID
    import ipaddress

    d = tmp_path_factory.mktemp("certs")
    now = datetime.datetime.now(datetime.timezone.utc)

    def _write_key(path, key):
        path.write_bytes(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "nomad-tpu test CA")])
    ca_cert = (
        x509.CertificateBuilder()
        .subject_name(ca_name).issuer_name(ca_name)
        .public_key(ca_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(ca_key, hashes.SHA256())
    )

    def issue(cn, signer_key, issuer_name, path_prefix):
        key = ec.generate_private_key(ec.SECP256R1())
        cert = (
            x509.CertificateBuilder()
            .subject_name(x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, cn)]))
            .issuer_name(issuer_name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName([
                x509.DNSName("localhost"),
                x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
            ]), critical=False)
            .sign(signer_key, hashes.SHA256())
        )
        (d / f"{path_prefix}.pem").write_bytes(
            cert.public_bytes(serialization.Encoding.PEM))
        _write_key(d / f"{path_prefix}.key", key)

    (d / "ca.pem").write_bytes(ca_cert.public_bytes(
        serialization.Encoding.PEM))
    issue("server.global.nomad-tpu", ca_key, ca_name, "node")
    # A second, UNRELATED CA + cert for the wrong-chain rejection test.
    rogue_key = ec.generate_private_key(ec.SECP256R1())
    rogue_name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, "rogue CA")])
    rogue_ca = (
        x509.CertificateBuilder()
        .subject_name(rogue_name).issuer_name(rogue_name)
        .public_key(rogue_key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(minutes=5))
        .not_valid_after(now + datetime.timedelta(days=1))
        .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                       critical=True)
        .sign(rogue_key, hashes.SHA256())
    )
    (d / "rogue-ca.pem").write_bytes(rogue_ca.public_bytes(
        serialization.Encoding.PEM))
    issue("rogue.node", rogue_key, rogue_name, "rogue")
    return d


def _tls_transport(certs):
    return TCPTransport(
        fsm_payload_decoder,
        ssl_server_ctx=tlsutil.server_context(
            str(certs / "ca.pem"), str(certs / "node.pem"),
            str(certs / "node.key")),
        ssl_client_ctx=tlsutil.client_context(
            str(certs / "ca.pem"), str(certs / "node.pem"),
            str(certs / "node.key")),
    )


def find_leader(nodes):
    for n in nodes:
        if n.is_leader():
            return n
    return None


def test_raft_cluster_forms_and_replicates_over_mtls(certs):
    transports = [_tls_transport(certs) for _ in range(3)]
    addrs = [t.serve("127.0.0.1", 0) for t in transports]
    applied = {i: [] for i in range(3)}
    nodes = []
    for i, t in enumerate(transports):
        def make_apply(i):
            return lambda index, mtype, payload: applied[i].append(mtype)

        node = RaftNode(addrs[i], addrs, t, make_apply(i), lambda _: None)
        t.register(node)
        nodes.append(node)
    for n in nodes:
        n.start()
    try:
        assert wait_until(lambda: find_leader(nodes) is not None)
        leader = find_leader(nodes)
        leader.apply("node_register", {"node": mock.node()})
        assert wait_until(lambda: all(len(applied[i]) == 1 for i in range(3)))
        # Follower forward rides the same mTLS channel.
        follower = next(n for n in nodes if not n.is_leader())
        follower.apply("test", {"x": 1})
        assert wait_until(lambda: all(len(applied[i]) == 2 for i in range(3)))
    finally:
        for n in nodes:
            n.stop()
        for t in transports:
            t.close()


def test_plaintext_and_wrong_ca_peers_rejected(certs):
    server_t = _tls_transport(certs)
    addr = server_t.serve("127.0.0.1", 0)

    class Echo:
        def handle_request_vote(self, args):
            return {"ok": True}

    server_t.register(Echo())
    try:
        # Plaintext client: the TLS server kills the handshake.
        plain = TCPTransport(fsm_payload_decoder)
        assert plain.request_vote(addr, {"term": 1}) is None
        plain.close()
        # Wrong CA chain: mutual verification fails both directions.
        rogue = TCPTransport(
            fsm_payload_decoder,
            ssl_client_ctx=tlsutil.client_context(
                str(certs / "rogue-ca.pem"), str(certs / "rogue.pem"),
                str(certs / "rogue.key")),
        )
        assert rogue.request_vote(addr, {"term": 1}) is None
        rogue.close()
        # The real cert still works.
        good = _tls_transport(certs)
        assert good.request_vote(addr, {"term": 1}) == {"ok": True}
        good.close()
    finally:
        server_t.close()


def test_transport_pools_connections_under_heartbeat_storm(certs):
    """One socket per peer serves sequential RPCs; a concurrent burst
    opens at most MAX_IDLE_PER_PEER (pool.go:144's O(clients) not
    O(messages) property). Runs over TLS so the pooled path and the
    handshake compose."""
    server_t = _tls_transport(certs)
    addr = server_t.serve("127.0.0.1", 0)

    class Echo:
        def handle_request_vote(self, args):
            return {"ok": True}

    server_t.register(Echo())
    client_t = _tls_transport(certs)
    try:
        for _ in range(50):
            assert client_t.request_vote(addr, {"t": 1}) == {"ok": True}
        assert client_t.dials == 1

        errors = []

        def storm():
            for _ in range(20):
                if client_t.request_vote(addr, {"t": 2}) != {"ok": True}:
                    errors.append(1)

        threads = [threading.Thread(target=storm) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert client_t.dials <= 1 + 8  # bounded by concurrency, not msgs

        # forget_peer releases the idle pool.
        client_t.forget_peer(addr)
        assert client_t._pools.get(addr) in (None, [])
    finally:
        client_t.close()
        server_t.close()


def test_gossip_over_mtls_rejects_plaintext(certs):
    """Gossip carries the addresses forwarding trusts, so it rides the
    same mTLS as raft: members sync over TLS, a plaintext peer's
    push-pull is refused at the handshake."""
    from nomad_tpu_torch.server.serf import Serf

    def tls_serf(name):
        return Serf(
            name, probe_interval=999,
            ssl_server_ctx=tlsutil.server_context(
                str(certs / "ca.pem"), str(certs / "node.pem"),
                str(certs / "node.key")),
            ssl_client_ctx=tlsutil.client_context(
                str(certs / "ca.pem"), str(certs / "node.pem"),
                str(certs / "node.key")),
        )

    a, b = tls_serf("a"), tls_serf("b")
    a.serve("127.0.0.1", 0)
    addr_b = b.serve("127.0.0.1", 0)
    plain = Serf("intruder", probe_interval=999)
    plain.serve("127.0.0.1", 0)
    try:
        assert a._push_pull(addr_b)
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if {m.name for m in b.members()} == {"a", "b"}:
                break
            time.sleep(0.05)
        assert {m.name for m in b.members()} == {"a", "b"}
        # A plaintext member cannot inject itself.
        assert plain._push_pull(addr_b) is False
        assert "intruder" not in {m.name for m in b.members()}
    finally:
        a.shutdown()
        b.shutdown()
        plain.shutdown()


def test_transport_retry_dials_fresh_after_peer_restart(certs):
    """A peer restart leaves MULTIPLE stale pooled sockets; the
    keep-alive retry must dial fresh rather than pop a second stale
    socket and report a healthy peer dead (costing election rounds)."""
    server_t = _tls_transport(certs)
    addr = server_t.serve("127.0.0.1", 0)

    class Echo:
        def handle_request_vote(self, args):
            return {"ok": True}

    server_t.register(Echo())
    client_t = _tls_transport(certs)
    try:
        # Pool several sockets via concurrent RPCs.
        threads = [threading.Thread(
            target=client_t.request_vote, args=(addr, {"t": 1}))
            for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sum(len(v) for v in client_t._pools.values()) >= 2

        # "Restart" the peer: old sockets die, a new listener appears
        # on the same port.
        host, port = addr.rsplit(":", 1)
        server_t.close()
        server_t2 = _tls_transport(certs)
        server_t2.register(Echo())
        assert server_t2.serve(host, int(port)) == addr
        try:
            # First call after the restart: stale pooled socket fails,
            # the retry dials fresh and succeeds.
            assert client_t.request_vote(addr, {"t": 2}) == {"ok": True}
        finally:
            server_t2.close()
    finally:
        client_t.close()
