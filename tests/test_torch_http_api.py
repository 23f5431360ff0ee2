"""The HTTP API and its SDK on the port (nomad_tpu_torch.api), on the
CPU:

- the cases of tests/test_http_api.py, tests/test_debug_endpoints.py,
  tests/test_httppool.py:41-121, tests/test_trace.py:425,
  tests/test_profile.py:573 and tests/test_tls.py:281,355 on the port's
  HTTPServer, Client and Server (the JAX agent's tls block is read by
  its CLI, which the port does not carry: the port's case gives the
  HTTPServer the same server context directly);
- route parity: the same seeded writes through both packages' Server
  logs (the JAX objects carried to the port as plain dicts), then the
  same requests to both HTTPServers, which must answer with the same
  status, the same X-Nomad-Index and equal JSON bodies. Normalised:
  the ids of evals that a request creates (random UUIDs on each side),
  the times a request stamps (``submit_time``, ``create_time``,
  ``modify_time``, ``status_updated_at``) and each server's own HTTP
  address;
- wire compatibility both ways: the port's SDK against the JAX
  HTTPServer, and the JAX SDK against the port's.
"""

import json
import re
import socket
import ssl
import threading
import time
import urllib.error
import urllib.request

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from torch_server import MockClient

from nomad_tpu import mock as ref_mock
from nomad_tpu.api import Client as RefClient
from nomad_tpu.api import HTTPServer as RefHTTPServer
from nomad_tpu.server import Server as RefServer
from nomad_tpu.server import ServerConfig as RefConfig
from nomad_tpu.structs import Allocation as RefAllocation
from nomad_tpu.structs import Evaluation as RefEvaluation
from nomad_tpu.structs import Job as RefJob
from nomad_tpu.structs import Node as RefNode
from nomad_tpu.utils.codec import to_dict as ref_to_dict
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import Client, HTTPServer
from nomad_tpu_torch.api import http as http_mod
from nomad_tpu_torch.api.client import APIError
from nomad_tpu_torch.profile import get_profiler
from nomad_tpu_torch.profile.export import validate_chrome_trace
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.leader_client import RemoteLeader
from nomad_tpu_torch.structs import Allocation, Evaluation, Job, Node, consts
from nomad_tpu_torch.trace import LIFECYCLE_CORE_STAGES, get_recorder
from nomad_tpu_torch.utils.codec import from_dict, to_dict


def wait_until(fn, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def _raw_request(addr, path, method="GET", body=None, timeout=10.0):
    """(status, headers, json body) — the SDK hides headers."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(addr + path, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            raw = resp.read()
            ctype = resp.headers.get("Content-Type", "")
            out = json.loads(raw) if "json" in ctype else raw.decode()
            return resp.status, dict(resp.headers), out
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


@pytest.fixture
def api():
    server = Server(ServerConfig(num_schedulers=1, eval_nack_timeout=5.0))
    server.start()
    http = HTTPServer(server)
    http.start()
    client = Client(http.addr, timeout=10.0)
    mc = MockClient(server)
    mc.start()
    yield client, server
    mc.stop()
    http.stop()
    server.shutdown()


# ------------------------------------------ tests/test_http_api.py


def test_job_lifecycle_over_http(api):
    client, server = api
    job = mock.job()
    job.task_groups[0].count = 2

    eval_id = client.jobs.register(job)
    assert eval_id

    assert wait_until(
        lambda: client.evaluations.info(eval_id)[0].status
        == consts.EVAL_STATUS_COMPLETE
    )
    allocs, idx = client.jobs.allocations(job.id)
    assert len(allocs) == 2
    assert idx > 0

    out, _ = client.jobs.info(job.id)
    assert out.id == job.id

    jobs, _ = client.jobs.list()
    assert any(j["id"] == job.id for j in jobs)

    summary, _ = client.jobs.summary(job.id)
    assert "web" in summary["summary"]

    evals, _ = client.jobs.evaluations(job.id)
    assert any(e.id == eval_id for e in evals)

    client.jobs.deregister(job.id)
    with pytest.raises(APIError) as excinfo:
        wait_until(lambda: client.jobs.info(job.id) and False, timeout=2.0)
    assert excinfo.value.status == 404


def test_blocking_query_fires_on_change(api):
    client, server = api
    job = mock.job()
    job.task_groups[0].count = 1
    client.jobs.register(job)
    assert wait_until(lambda: len(client.jobs.allocations(job.id)[0]) == 1)

    _, idx = client.jobs.allocations(job.id)
    results = {}

    def blocker():
        t0 = time.monotonic()
        out, new_idx = client.jobs.allocations(job.id, index=idx, wait=5.0)
        results["elapsed"] = time.monotonic() - t0
        results["index"] = new_idx

    t = threading.Thread(target=blocker)
    t.start()
    time.sleep(0.3)
    client.jobs.evaluate(job.id)  # may or may not change allocs
    server.job_deregister(job.id)  # definitely stops the alloc
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert results["index"] > idx
    assert results["elapsed"] < 5.0


def test_nodes_over_http(api):
    client, server = api
    nodes, _ = client.nodes.list()
    assert len(nodes) == 1
    node, _ = client.nodes.info(nodes[0]["id"])
    assert node.status == consts.NODE_STATUS_READY

    client.nodes.drain(node.id, True)
    assert wait_until(lambda: client.nodes.info(node.id)[0].drain is True)
    client.nodes.drain(node.id, False)

    with pytest.raises(APIError) as excinfo:
        client.nodes.allocations(node.id, secret="wrong")
    assert excinfo.value.status == 403


def test_plan_over_http(api):
    client, server = api
    job = mock.job()
    job.task_groups[0].count = 3
    out = client.jobs.plan(job)
    assert out["annotations"]["desired_tg_updates"]["web"]["place"] == 3
    with pytest.raises(APIError):
        client.jobs.info(job.id)  # dry run committed nothing


def test_agent_and_system_endpoints(api):
    client, server = api
    info = client.agent.self()
    assert info["stats"]["leader"] is True
    assert "read_mux" in info["stats"]
    assert client.agent.leader() != ""
    client.system.garbage_collect()


def test_unknown_route_404(api):
    client, server = api
    with pytest.raises(APIError) as excinfo:
        client.get("/v1/bogus")
    assert excinfo.value.status == 404


def test_blocking_query_times_out_with_current_state(api):
    client, server = api
    job = mock.job()
    job.task_groups[0].count = 1
    client.jobs.register(job)
    assert wait_until(lambda: len(client.jobs.allocations(job.id)[0]) == 1)
    assert wait_until(
        lambda: all(a.get("client_status") == "running"
                    for a in client.jobs.allocations(job.id)[0]))
    assert wait_until(
        lambda: (evs := client.jobs.evaluations(job.id)[0])
        and all(e.status == "complete" for e in evs))
    _, idx = client.jobs.allocations(job.id)

    t0 = time.monotonic()
    out, new_idx = client.jobs.allocations(job.id, index=idx, wait=0.5)
    elapsed = time.monotonic() - t0
    assert 0.4 <= elapsed < 3.0
    assert len(out) == 1
    assert new_idx >= idx


def test_blocking_query_stale_index_returns_immediately(api):
    client, server = api
    job = mock.job()
    job.task_groups[0].count = 1
    client.jobs.register(job)
    assert wait_until(lambda: len(client.jobs.allocations(job.id)[0]) == 1)

    _, cur = client.jobs.allocations(job.id)
    t0 = time.monotonic()
    out, new_idx = client.jobs.allocations(job.id, index=max(cur - 1, 1),
                                           wait=5.0)
    assert time.monotonic() - t0 < 1.0
    assert len(out) == 1 and new_idx >= cur


def test_internal_dequeue_echoes_effective_timeout(api, monkeypatch):
    client, server = api
    addr = client.address.rstrip("/")
    monkeypatch.setattr(http_mod, "MAX_BLOCKING_WAIT", 0.2)
    status, _h, out = _raw_request(
        addr, "/v1/internal/eval/dequeue", method="POST",
        body={"schedulers": [], "timeout": 99999.0})
    assert status == 200
    assert out["timeout"] == 0.2
    assert out["eval"] is None
    status, _h, out = _raw_request(
        addr, "/v1/internal/eval/dequeue", method="POST",
        body={"schedulers": [], "timeout": 0.05})
    assert status == 200
    assert out["timeout"] == 0.05


def test_admission_red_sheds_writes_with_retry_after(api):
    client, server = api
    addr = client.address.rstrip("/")
    server.admission.force_level("red")
    try:
        status, headers, out = _raw_request(
            addr, "/v1/jobs", method="PUT",
            body={"job": to_dict(mock.job())})
        assert status == 503
        assert float(headers["Retry-After"]) > 0
        assert "retry_after" in out
        status, _h, _out = _raw_request(addr, "/v1/metrics?format=json")
        assert status == 200
        status, _h, out = _raw_request(
            addr, "/v1/internal/eval/dequeue", method="POST",
            body={"schedulers": [], "timeout": 0.01})
        assert status == 200
    finally:
        server.admission.force_level(None)
    assert client.jobs.register(mock.job())


def test_admission_yellow_rate_limits_writes_429(api):
    client, server = api
    addr = client.address.rstrip("/")
    server.admission._write.rate = 0.0
    server.admission._write.burst = 0.0
    with server.admission._write._lock:
        server.admission._write._tokens = 0.0
    server.admission.force_level("yellow")
    try:
        status, headers, _out = _raw_request(
            addr, "/v1/jobs", method="PUT",
            body={"job": to_dict(mock.job())})
        assert status == 429
        assert float(headers["Retry-After"]) > 0
        status, _h, _out = _raw_request(addr, "/v1/jobs")
        assert status == 200
    finally:
        server.admission.force_level(None)
        server.admission._write.rate = 50.0
        server.admission._write.burst = 100.0


@pytest.mark.parametrize("path", [
    "/v1/client/fs/ls/a1", "/v1/client/fs/stat/a1", "/v1/client/fs/cat/a1",
    "/v1/client/fs/readat/a1", "/v1/client/fs/logs/a1", "/v1/client/stats",
    "/v1/client/allocation/a1/stats", "/v1/client/allocation/a1/snapshot",
])
def test_client_routes_answer_501_without_a_client(api, path):
    """No client agent is attached: every /v1/client/* route answers
    501, as the JAX HTTPServer does with no client."""
    client, _server = api
    status, _h, out = _raw_request(client.address, path)
    assert status == 501
    assert out["error"] == "no client agent attached to this HTTP server"


# ------------------------------------ tests/test_debug_endpoints.py


@pytest.fixture
def debug_servers():
    srv = Server(ServerConfig(num_schedulers=0))
    srv.start()
    on = HTTPServer(srv, enable_debug=True)
    on.start()
    off = HTTPServer(srv)
    off.start()
    yield on, off
    on.stop()
    off.stop()
    srv.shutdown()


def _get_text(addr, path):
    with urllib.request.urlopen(addr + path, timeout=10) as r:
        return r.read().decode()


def test_debug_disabled_by_default_returns_404(debug_servers):
    _, off = debug_servers
    for path in ("/debug/stacks", "/debug/profile", "/debug/vars"):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get_text(off.addr, path)
        assert e.value.code == 404


def test_debug_stacks_dumps_every_thread(debug_servers):
    on, _ = debug_servers
    out = _get_text(on.addr, "/debug/stacks")
    assert "== thread" in out
    assert "_debug_stacks" in out


def test_debug_profile_samples_stacks(debug_servers):
    on, _ = debug_servers
    out = _get_text(on.addr, "/debug/profile?seconds=0.3")
    assert "sampling rounds" in out
    assert "\t" in out.splitlines()[1]


def test_debug_vars_reports_runtime(debug_servers):
    on, _ = debug_servers
    data = json.loads(_get_text(on.addr, "/debug/vars"))
    assert data["threads"] > 0
    assert data["max_rss_kb"] > 0
    assert "python" in data


# -------------------------------------- tests/test_httppool.py:41-121


@pytest.fixture
def pooled():
    server = Server(ServerConfig(num_schedulers=1, eval_nack_timeout=5.0))
    server.start()
    http = HTTPServer(server)
    http.start()
    client = Client(http.addr, timeout=10.0)
    yield client, server, http
    http.stop()
    server.shutdown()


def test_sequential_requests_reuse_one_socket(pooled):
    client, server, http = pooled
    client.jobs.register(mock.job())
    _, index = client.jobs.list()
    for _ in range(10):
        client.jobs.list()
        client.jobs.list(index=index, wait=0.05)
        client.nodes.list()
    assert client.pool.dials == 1
    assert http.connections_accepted == 1


def test_puts_and_errors_keep_the_socket(pooled):
    client, server, http = pooled
    for _ in range(5):
        client.jobs.register(mock.job())
        with pytest.raises(APIError) as e:
            client.jobs.info("no-such-job")
        assert e.value.status == 404
    assert client.pool.dials == 1
    assert http.connections_accepted == 1


def test_stale_pooled_socket_redials_once(pooled):
    client, server, http = pooled
    client.jobs.list()
    assert client.pool.dials == 1
    with client.pool._lock:
        assert client.pool._idle
        for conn in client.pool._idle:
            conn.sock.shutdown(socket.SHUT_RDWR)
    client.jobs.list()
    assert client.pool.dials == 2


def test_longpoll_clients_use_linear_sockets(pooled):
    """Many long-polling clients, each issuing several sequential
    blocking queries, hold O(clients) sockets, not O(requests)."""
    client, server, http = pooled
    client.jobs.register(mock.job())
    _, index = client.jobs.list()
    before = http.connections_accepted

    n_clients, polls_each = 500, 3
    errors = []

    def poll_loop():
        try:
            c = Client(http.addr, timeout=10.0)
            for _ in range(polls_each):
                c.jobs.list(index=index, wait=0.1)
            assert c.pool.dials == 1
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=poll_loop) for _ in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not errors
    opened = http.connections_accepted - before
    assert n_clients <= opened <= n_clients * 1.1, opened


# ------------------------- tests/test_trace.py:425, test_profile.py:573


PROM_LINE = re.compile(
    r'^(#.*|[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*\})? '
    r'([-+0-9.eE]+|\+Inf|-Inf|NaN))$')


def _dense_server(**over):
    cfg = dict(num_schedulers=4,
               scheduler_factories={"service": "service-gpu"},
               eval_batch_size=16, eval_nack_timeout=60.0)
    cfg.update(over)
    server = Server(ServerConfig(**cfg))
    server.start()
    for _ in range(4):
        node = mock.node()
        node.compute_class()
        server.node_register(node)
    return server


def _wait_complete(server, ev_id):
    assert wait_until(
        lambda: (lambda e: e is not None and e.status
                 == consts.EVAL_STATUS_COMPLETE)(
            server.fsm.state.eval_by_id(ev_id)), 30.0)


def test_http_trace_and_metrics_endpoints():
    rec = get_recorder()
    rec.reset()
    rec.set_enabled(True)
    server = _dense_server(num_schedulers=1)
    http = HTTPServer(server)
    http.start()
    client = Client(http.addr, timeout=10.0)
    try:
        ev_id, _ = server.job_register(mock.job())
        _wait_complete(server, ev_id)
        assert wait_until(lambda: rec.trace_for(ev_id) is not None, 10.0)

        out, _idx = client.get("/v1/agent/trace")
        assert out["recent"], "no recent traces over HTTP"
        assert out["recorder"]["completed"] >= 1
        assert "stages" in out and "e2e" in out["stages"]
        one, _ = client.get(f"/v1/agent/trace?eval={ev_id}")
        assert one["trace"]["eval_id"] == ev_id
        names = {s["name"] for s in one["trace"]["spans"]}
        assert set(LIFECYCLE_CORE_STAGES) <= names

        text = client.get_raw("/v1/metrics").decode()
        assert text.strip(), "empty exposition"
        for line in text.strip().splitlines():
            assert PROM_LINE.match(line), f"invalid exposition line: {line!r}"
        assert "_bucket{le=" in text
        assert '_bucket{le="+Inf"}' in text
        assert re.search(r"nomad_tpu_http_request_GET_\w+_count", text)
        assert "\nnomad_tpu_http_request_count" not in text
    finally:
        http.stop()
        server.shutdown()
        rec.reset()


def test_http_profile_and_chrome_endpoints():
    prof = get_profiler()
    prof.reset()
    prof.set_enabled(True)
    server = _dense_server(num_schedulers=2, eval_batch_size=8)
    http = HTTPServer(server)
    http.start()
    client = Client(http.addr, timeout=10.0)
    try:
        ev_id, _ = server.job_register(mock.job())
        _wait_complete(server, ev_id)

        stats = server.stats()["profile"]
        assert stats["enabled"] is True
        assert stats["locks"]["server.broker"]["acquires"] > 0

        out, _ = client.get("/v1/agent/profile")
        assert out["enabled"] is True
        assert "server.broker" in out["locks"]
        assert "gil" in out and "convoys" in out and "runq" in out
        one, _ = client.get("/v1/agent/profile?lock=server.broker")
        assert one["site"] == "server.broker"
        assert one["stats"]["acquires"] > 0
        threads, _ = client.get("/v1/agent/profile?threads=1")
        assert isinstance(threads.get("threads"), dict)
        with pytest.raises(APIError) as e:
            client.get("/v1/agent/profile?lock=no.such.site")
        assert e.value.status == 404

        doc = json.loads(client.get_raw(
            "/v1/agent/trace?format=chrome").decode())
        assert validate_chrome_trace(doc) == []
        assert any(e["ph"] == "M" and e["args"]["name"]
                   == "pipeline timeline" for e in doc["traceEvents"])
        assert any(e["ph"] == "X" for e in doc["traceEvents"])

        text = client.get_raw("/v1/metrics").decode()
        assert "nomad_tpu_profile_lock_hold_ms" in text
        assert "nomad_tpu_profile_convoy_max_width" in text
    finally:
        http.stop()
        server.shutdown()
        prof.reset()
        prof.set_enabled(True)


# ------------------------------------------ tests/test_tls.py:281,355


@pytest.fixture(scope="module")
def certs(tmp_path_factory):
    """A CA plus one node cert (SAN 127.0.0.1), as PEM files."""
    cryptography = pytest.importorskip("cryptography")
    del cryptography
    import datetime
    import ipaddress

    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    d = tmp_path_factory.mktemp("certs")
    now = datetime.datetime.now(datetime.timezone.utc)

    def write_key(path, key):
        path.write_bytes(key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.TraditionalOpenSSL,
            serialization.NoEncryption()))

    ca_key = ec.generate_private_key(ec.SECP256R1())
    ca_name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, "test-ca")])
    ca = (x509.CertificateBuilder().subject_name(ca_name)
          .issuer_name(ca_name).public_key(ca_key.public_key())
          .serial_number(x509.random_serial_number())
          .not_valid_before(now - datetime.timedelta(days=1))
          .not_valid_after(now + datetime.timedelta(days=1))
          .add_extension(x509.BasicConstraints(ca=True, path_length=None),
                         critical=True)
          .sign(ca_key, hashes.SHA256()))
    key = ec.generate_private_key(ec.SECP256R1())
    cert = (x509.CertificateBuilder()
            .subject_name(x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, "node")]))
            .issuer_name(ca_name).public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(days=1))
            .not_valid_after(now + datetime.timedelta(days=1))
            .add_extension(x509.SubjectAlternativeName([
                x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                x509.DNSName("localhost")]), critical=False)
            .sign(ca_key, hashes.SHA256()))
    (d / "ca.pem").write_bytes(ca.public_bytes(serialization.Encoding.PEM))
    (d / "node.pem").write_bytes(
        cert.public_bytes(serialization.Encoding.PEM))
    write_key(d / "node.key", key)
    return d


def _tls_http(certs, server):
    from nomad_tpu_torch.utils import tlsutil

    http = HTTPServer(
        server, host="127.0.0.1", port=0,
        ssl_context=tlsutil.server_context(
            str(certs / "ca.pem"), str(certs / "node.pem"),
            str(certs / "node.key"), verify_client=False))
    http.start()
    return http


def test_tls_http_serves_https_and_refuses_plaintext(certs):
    """The agent tls block's effect on the HTTP API: https is served
    (``/v1/status/leader``) and a plaintext request fails."""
    srv = Server(ServerConfig(num_schedulers=1))
    srv.start()
    http = _tls_http(certs, srv)
    try:
        assert http.addr.startswith("https://")
        ctx = ssl.create_default_context(cafile=str(certs / "ca.pem"))
        ctx.check_hostname = False
        with urllib.request.urlopen(f"{http.addr}/v1/status/leader",
                                    context=ctx, timeout=5.0) as resp:
            assert resp.status == 200
        with pytest.raises(Exception):
            urllib.request.urlopen(
                http.addr.replace("https://", "http://")
                + "/v1/status/leader", timeout=2.0)
    finally:
        http.stop()
        srv.shutdown()


def test_http_api_over_tls_and_secret_gate(certs):
    from nomad_tpu_torch.utils import tlsutil

    srv = Server(ServerConfig(num_schedulers=0))
    srv.start()
    http = _tls_http(certs, srv)
    try:
        node = mock.node()
        srv.node_register(node)

        api = Client(http.addr, ssl_context=tlsutil.client_context(
            str(certs / "ca.pem"), str(certs / "node.pem"),
            str(certs / "node.key")))
        listing, _ = api.nodes.list()
        assert any(n["id"] == node.id for n in listing)

        plain = Client(f"http://127.0.0.1:{http.port}")
        with pytest.raises(APIError):
            plain.nodes.list()

        for bad in ("", "wrong-secret"):
            with pytest.raises(APIError) as e:
                api.nodes.allocations(node.id, secret=bad)
            assert e.value.status == 403
        allocs, _ = api.nodes.allocations(node.id, secret=node.secret_id)
        assert allocs == []
    finally:
        http.stop()
        srv.shutdown()


# ------------------------------------------------------ route parity


def _seed_entries(seed):
    """Seeded writes as (msg_type, payload) of JAX objects with fixed
    ids: nodes, jobs, their evals and their allocs."""
    import random

    rng = random.Random(seed)
    nodes, jobs, evals, allocs = [], [], [], []
    for i in range(4):
        node = ref_mock.node()
        node.id = f"node-{seed}-{i}"
        node.secret_id = f"secret-{i}"
        node.resources.cpu = rng.choice([4000, 8000])
        node.compute_class()
        nodes.append(node)
    for i in range(3):
        job = ref_mock.job()
        job.id = f"job-{seed}-{i}"
        job.task_groups[0].count = 2
        jobs.append(job)
        ev = ref_mock.eval()
        ev.id = f"eval-{seed}-{i}"
        ev.job_id = job.id
        ev.status = "complete"
        evals.append(ev)
        for k in range(2):
            alloc = ref_mock.alloc()
            alloc.id = f"alloc-{seed}-{i}-{k}"
            alloc.job_id, alloc.job = job.id, job
            alloc.eval_id = ev.id
            alloc.node_id = nodes[rng.randrange(len(nodes))].id
            alloc.client_status = "running"
            allocs.append(alloc)
    out = [("node_register", {"node": n}) for n in nodes]
    out += [("job_register", {"job": j}) for j in jobs]
    out += [("eval_update", {"evals": evals})]
    out += [("alloc_update", {"allocs": allocs})]
    return out, nodes, jobs, evals, allocs


_PORT_CLASS = {RefNode: Node, RefJob: Job, RefEvaluation: Evaluation,
               RefAllocation: Allocation}


def _carry(value):
    """A JAX object (or a list of them) as the port's, through plain
    dicts."""
    if isinstance(value, list):
        return [_carry(v) for v in value]
    return from_dict(_PORT_CLASS[type(value)], ref_to_dict(value))


@pytest.fixture
def pair():
    """A JAX and a port dev server, each behind its HTTPServer, holding
    the same seeded state written through their logs in the same order
    (so every raft index agrees). No scheduler runs on either."""
    entries, nodes, jobs, evals, allocs = _seed_entries(7)
    ref = RefServer(RefConfig(num_schedulers=0))
    port = Server(ServerConfig(num_schedulers=0))
    for msg_type, payload in entries:
        ref.log.apply(msg_type, payload)
        port.log.apply(msg_type, {k: _carry(v) for k, v in payload.items()})
    ref.start()
    port.start()
    ref_http, port_http = RefHTTPServer(ref), HTTPServer(port)
    ref_http.start()
    port_http.start()
    yield dict(ref=ref, port=port, ref_http=ref_http, port_http=port_http,
               nodes=nodes, jobs=jobs, evals=evals, allocs=allocs)
    ref_http.stop()
    port_http.stop()
    ref.shutdown()
    port.shutdown()


_TIME_KEYS = ("submit_time", "create_time", "modify_time",
              "status_updated_at")
_UUID = re.compile(
    r"^[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}$")


def _normal(value, addr):
    """Created eval ids (UUIDs: the seeded ids are not), stamped times
    and the server's own address replaced by placeholders."""
    if isinstance(value, dict):
        return {k: ("<time>" if k in _TIME_KEYS else _normal(v, addr))
                for k, v in value.items()}
    if isinstance(value, list):
        return [_normal(v, addr) for v in value]
    if isinstance(value, str):
        if _UUID.match(value):
            return "<id>"
        return value.replace(addr, "<addr>")
    return value


def _both(p, path, method="GET", body=None):
    outs = []
    for side in ("ref_http", "port_http"):
        addr = p[side].addr
        status, headers, out = _raw_request(addr, path, method, body)
        outs.append((status, headers.get("X-Nomad-Index"),
                     _normal(out, addr)))
    return outs


def _parity_paths(p):
    job, node = p["jobs"][0], p["nodes"][0]
    ev, alloc = p["evals"][1], p["allocs"][3]
    return [
        "/v1/jobs", "/v1/jobs?prefix=job-7-1", f"/v1/job/{job.id}",
        f"/v1/job/{job.id}/allocations", f"/v1/job/{job.id}/evaluations",
        f"/v1/job/{job.id}/summary", "/v1/job/nope", "/v1/nodes",
        f"/v1/node/{node.id}", f"/v1/node/{node.id}/allocations",
        f"/v1/node/{node.id}/allocations?secret={node.secret_id}",
        "/v1/allocations", f"/v1/allocation/{alloc.id}",
        "/v1/allocation/nope", "/v1/evaluations", f"/v1/evaluation/{ev.id}",
        f"/v1/evaluation/{ev.id}/allocations", "/v1/evaluation/nope",
        "/v1/regions", "/v1/status/leader", "/v1/status/peers",
        "/v1/agent/servers", "/v1/agent/members",
        "/v1/jobs?stale", "/v1/jobs?consistent", "/v1/jobs?stale&consistent",
        "/v1/agent/force-leave", "/v1/bogus", "/debug/vars",
        "/v1/client/stats", "/v1/client/fs/ls/x",
        f"/v1/job/{job.id}?index=1&wait=5",
        f"/v1/job/{job.id}/allocations?index=999&wait=0.2",
    ]


def test_read_routes_answer_alike(pair):
    for path in _parity_paths(pair):
        ref, port = _both(pair, path)
        assert port == ref, path


def test_write_routes_answer_alike(pair):
    """The same writes through both APIs: the same status and index,
    equal bodies (created eval ids and stamped times normalised), and
    the state they leave reads back alike."""
    job = ref_mock.job()
    job.id = "job-written"
    job.task_groups[0].count = 3
    node = pair["nodes"][1]
    writes = [
        ("PUT", "/v1/jobs", {"job": ref_to_dict(job)}),
        ("PUT", f"/v1/job/{job.id}/plan", {"job": ref_to_dict(job)}),
        ("PUT", f"/v1/job/{job.id}/evaluate", None),
        ("PUT", f"/v1/node/{node.id}/drain", {"drain": True}),
        ("PUT", "/v1/jobs", {"Job": {"id": 3}}),
        ("PUT", "/v1/job/other", {"job": ref_to_dict(job)}),
        ("DELETE", f"/v1/job/{pair['jobs'][2].id}", None),
        ("PUT", "/v1/system/gc", None),
    ]
    for method, path, body in writes:
        ref, port = _both(pair, path, method, body)
        assert port == ref, (method, path)
    for path in (f"/v1/job/{job.id}", f"/v1/node/{node.id}",
                 f"/v1/job/{job.id}/summary", "/v1/jobs"):
        ref, port = _both(pair, path)
        assert port == ref, path


def test_blocking_queries_wake_alike(pair):
    """A parked query on each side, then the same write: both wake with
    the same index and body."""
    job = pair["jobs"][0]
    _s, idx, _b = _both(pair, f"/v1/job/{job.id}")[0]
    results = {}

    def blocker(side):
        addr = pair[side].addr
        status, headers, out = _raw_request(
            addr, f"/v1/job/{job.id}?index={idx}&wait=10")
        results[side] = (status, headers.get("X-Nomad-Index"),
                         _normal(out, addr))

    threads = [threading.Thread(target=blocker, args=(side,))
               for side in ("ref_http", "port_http")]
    for t in threads:
        t.start()
    assert wait_until(lambda: pair["port"].read_mux.stats()["parked"] == 1
                      and pair["ref"].read_mux.stats()["parked"] == 1)
    changed = ref_mock.job()
    changed.id = job.id
    changed.priority = 70
    pair["ref"].log.apply("job_register", {"job": changed})
    pair["port"].log.apply("job_register", {"job": _carry(changed)})
    for t in threads:
        t.join(15.0)
    assert results["port_http"] == results["ref_http"]
    assert int(results["port_http"][1]) > int(idx)
    assert results["port_http"][2]["priority"] == 70


# ------------------------------------------------ wire compatibility


def test_port_sdk_against_the_jax_api():
    """The port's SDK drives a JAX server through its HTTPServer: the
    job goes in as the port's struct and comes back as one."""
    server = RefServer(RefConfig(num_schedulers=1, eval_nack_timeout=5.0))
    server.start()
    node = ref_mock.node()
    server.node_register(node)
    http = RefHTTPServer(server)
    http.start()
    try:
        client = Client(http.addr, timeout=10.0)
        job = mock.job()
        job.task_groups[0].count = 1
        eval_id = client.jobs.register(job)
        assert wait_until(lambda: client.evaluations.info(eval_id)[0].status
                          == consts.EVAL_STATUS_COMPLETE)
        got, idx = client.jobs.info(job.id)
        assert isinstance(got, Job) and got.id == job.id and idx > 0
        allocs, aidx = client.jobs.allocations(job.id)
        assert len(allocs) == 1
        nodes, _ = client.nodes.list()
        assert [n["id"] for n in nodes] == [node.id]
        info, _ = client.nodes.info(node.id)
        assert isinstance(info, Node) and info.id == node.id
        evals, _ = client.evaluations.list()
        assert all(isinstance(e, Evaluation) for e in evals)
        t0 = time.monotonic()
        _out, new = client.jobs.allocations(job.id, index=aidx, wait=0.3)
        assert new >= aidx and time.monotonic() - t0 >= 0.25
        assert client.agent.leader() == http.addr
        remote = RemoteLeader(http.addr)
        assert remote.eval_dequeue_many([consts.JOB_TYPE_SERVICE], 4) == []
    finally:
        http.stop()
        server.shutdown()


def test_jax_sdk_against_the_port_api():
    """The JAX package's SDK drives the port's server through the
    port's HTTPServer, blocking query included."""
    server = Server(ServerConfig(num_schedulers=1, eval_nack_timeout=5.0))
    server.start()
    mc = MockClient(server)
    mc.start()
    http = HTTPServer(server)
    http.start()
    try:
        client = RefClient(http.addr, timeout=10.0)
        job = ref_mock.job()
        job.task_groups[0].count = 1
        eval_id = client.jobs.register(job)
        assert wait_until(lambda: client.evaluations.info(eval_id)[0].status
                          == consts.EVAL_STATUS_COMPLETE)
        got, idx = client.jobs.info(job.id)
        assert isinstance(got, RefJob) and got.id == job.id and idx > 0
        allocs, aidx = client.jobs.allocations(job.id)
        assert len(allocs) == 1
        assert client.nodes.list()[0][0]["id"] == mc.node.id
        results = {}

        def blocker():
            results["out"] = client.jobs.allocations(
                job.id, index=aidx, wait=10.0)

        t = threading.Thread(target=blocker)
        t.start()
        assert wait_until(lambda: server.read_mux.stats()["parked"] >= 1)
        client.jobs.deregister(job.id)
        t.join(15.0)
        assert results["out"][1] > aidx
        assert client.agent.self()["stats"]["leader"] is True
        assert client.regions.list() == ["global"]
    finally:
        http.stop()
        mc.stop()
        server.shutdown()
