"""The rest of the port's runtime utilities (nomad_tpu_torch/utils:
backoff.py, pool.py, timer.py, httppool.py, tlsutil.py, interpolate.py).

- The reference's own tests of Backoff/poll_until (tests/test_backoff.py)
  and of TimerWheel/WorkPool (tests/test_timer_wheel.py) run on the
  port's modules.
- HTTPPool's reference tests drive a Server through the SDK and wait
  for those modules; here the pool is held directly against a stdlib
  ``http.server`` on 127.0.0.1: one socket reused across GETs, PUTs
  and error replies, a stale pooled socket redialled once, a closed
  pool refusing checkin (the reference's own test).
- tlsutil's reference tests all drive raft, gossip or the HTTP API;
  here its contexts are built on certificates made in the test (the
  reference's ``certs`` fixture) and compared field by field with the
  JAX package's, and one mutual-TLS handshake runs over loopback.
- Parity: Backoff under one ``random.seed``, TimerWheel firing order
  and interpolation give equal results in both packages.
"""

import datetime
import http.server
import random
import socket
import ssl
import threading
import time
from types import SimpleNamespace

import pytest

from nomad_tpu.utils import backoff as ref_backoff
from nomad_tpu.utils import interpolate as ref_interpolate
from nomad_tpu.utils import timer as ref_timer
from nomad_tpu.utils import tlsutil as ref_tlsutil
from nomad_tpu_torch.utils import interpolate, tlsutil
from nomad_tpu_torch.utils.backoff import Backoff, poll_until
from nomad_tpu_torch.utils.httppool import HTTPPool, PoolError
from nomad_tpu_torch.utils.pool import WorkPool
from nomad_tpu_torch.utils.timer import TimerWheel


# ---------------------------------------------------------------------
# utils/backoff.py (mirror of tests/test_backoff.py)


def test_delays_grow_and_cap():
    bo = Backoff(base=0.1, factor=2.0, max_delay=0.35, jitter=0.0)
    assert [round(bo.next_delay(), 3) for _ in range(4)] == [
        0.1, 0.2, 0.35, 0.35]


def test_jitter_spreads_within_band():
    rng = random.Random(7)
    bo = Backoff(base=1.0, factor=1.0, max_delay=1.0, jitter=0.25, rng=rng)
    delays = [bo.next_delay() for _ in range(50)]
    assert all(0.75 <= d <= 1.25 for d in delays)
    assert max(delays) - min(delays) > 0.1  # actually spread, not fixed


def test_attempt_budget_is_retry_count():
    bo = Backoff(base=0.001, jitter=0.0, attempts=2)
    assert bo.sleep() and bo.sleep()
    assert not bo.sleep()


def test_deadline_grants_final_post_sleep_retry():
    """The deadline landing DURING a sleep still grants the caller one
    post-sleep retry (state may have changed while sleeping); the NEXT
    sleep reports expiry."""
    bo = Backoff(base=0.05, jitter=0.0, deadline=0.02)
    assert bo.sleep()  # clamped to the deadline, then one last grant
    assert not bo.sleep()


def test_stop_event_interrupts_sleep():
    stop = threading.Event()
    bo = Backoff(base=5.0, jitter=0.0, stop=stop)
    threading.Timer(0.05, stop.set).start()
    t0 = time.monotonic()
    assert not bo.sleep()
    assert time.monotonic() - t0 < 2.0


def test_reset_returns_to_base():
    bo = Backoff(base=0.1, factor=2.0, jitter=0.0)
    bo.next_delay()
    bo.next_delay()
    bo.reset()
    assert round(bo.next_delay(), 3) == 0.1


def test_poll_until_true_and_timeout():
    assert poll_until(lambda: True, 1.0)
    t0 = time.monotonic()
    assert not poll_until(lambda: False, 0.05)
    assert time.monotonic() - t0 < 1.0


def test_poll_until_sees_late_flip():
    flip_at = time.monotonic() + 0.05
    assert poll_until(lambda: time.monotonic() >= flip_at, 2.0)


def test_poll_until_stop_wins():
    stop = threading.Event()
    stop.set()
    assert not poll_until(lambda: False, 5.0, stop=stop)


# ---------------------------------------------------------------------
# utils/timer.py + utils/pool.py (mirror of tests/test_timer_wheel.py)


def test_timers_fire_in_deadline_order():
    wheel = TimerWheel(name="t-order", dispatch_workers=1)
    fired = []
    lock = threading.Lock()
    done = threading.Event()

    def cb(i):
        with lock:
            fired.append(i)
            if len(fired) == 4:
                done.set()

    # Scheduled out of order; with one dispatch worker, execution order
    # must follow deadlines.
    wheel.schedule(0.20, cb, 3)
    wheel.schedule(0.05, cb, 0)
    wheel.schedule(0.15, cb, 2)
    wheel.schedule(0.10, cb, 1)
    assert done.wait(5.0)
    assert fired == [0, 1, 2, 3]


def test_slow_callback_does_not_delay_others():
    """One blocked callback (a raft apply during leader loss) must not
    make other timers fire late — the round-2 wheel serialized all
    callbacks on the firing thread (ADVICE r2 #1)."""
    wheel = TimerWheel(name="t-slow")
    release = threading.Event()
    fast_fired = threading.Event()

    wheel.schedule(0.01, release.wait, 30.0)  # blocks a worker
    wheel.schedule(0.05, fast_fired.set)
    # The fast timer is due 40ms after the slow one starts blocking;
    # it must still fire promptly on another dispatch worker.
    assert fast_fired.wait(2.0), "fast timer was head-of-line blocked"
    release.set()


def test_cancel_before_fire():
    wheel = TimerWheel(name="t-cancel")
    fired = threading.Event()
    h = wheel.schedule(0.15, fired.set)
    h.cancel()
    assert not fired.wait(0.4)
    assert wheel.pending() == 0


def test_cancel_after_fire_is_noop():
    wheel = TimerWheel(name="t-cancel2")
    fired = threading.Event()
    h = wheel.schedule(0.01, fired.set)
    assert fired.wait(2.0)
    h.cancel()  # must not raise or corrupt the wheel
    ok = threading.Event()
    wheel.schedule(0.01, ok.set)
    assert ok.wait(2.0)


def test_cancel_race_under_concurrent_fire():
    """Hammer schedule+cancel while other timers fire: a handle
    cancelled before its deadline must never run, and the wheel must
    stay functional."""
    wheel = TimerWheel(name="t-race")
    fired = set()
    lock = threading.Lock()

    def cb(i):
        with lock:
            fired.add(i)

    handles = []
    for i in range(200):
        # Evens fire fast (keep the wheel busy); odds get a comfortable
        # deadline so cancelling them below is unambiguously pre-fire.
        delay = 0.001 + (i % 10) * 0.002 if i % 2 == 0 else 0.8
        handles.append(wheel.schedule(delay, cb, i))
    for i in range(1, 200, 2):
        handles[i].cancel()
    time.sleep(1.2)
    with lock:
        assert fired == set(range(0, 200, 2))
    # Wheel still functional afterwards.
    ok = threading.Event()
    wheel.schedule(0.01, ok.set)
    assert ok.wait(2.0)


def test_exception_in_callback_does_not_kill_wheel():
    wheel = TimerWheel(name="t-exc")

    def boom():
        raise RuntimeError("bad timer")

    wheel.schedule(0.01, boom)
    ok = threading.Event()
    wheel.schedule(0.05, ok.set)
    assert ok.wait(2.0)


def test_storm_of_timers_all_fire():
    wheel = TimerWheel(name="t-storm")
    n = 500
    count = [0]
    done = threading.Event()
    lock = threading.Lock()

    def cb():
        with lock:
            count[0] += 1
            if count[0] == n:
                done.set()

    for i in range(n):
        wheel.schedule(0.001 + (i % 20) * 0.001, cb)
    assert done.wait(10.0)
    assert count[0] == n


# ---------------------------------------------------------------- pool


def test_pool_bounded_worker_count():
    pool = WorkPool(3, name="p-bound")
    release = threading.Event()
    started = []
    lock = threading.Lock()

    def task(i):
        with lock:
            started.append(i)
        release.wait(10.0)
        return i

    futs = [pool.submit(task, i) for i in range(10)]
    time.sleep(0.3)
    assert pool.worker_count() <= 3
    with lock:
        assert len(started) <= 3  # only `size` tasks run concurrently
    release.set()
    assert sorted(f.result(10.0) for f in futs) == list(range(10))
    assert pool.worker_count() <= 3


def test_pool_future_delivers_result_and_exception():
    pool = WorkPool(2, name="p-fut")
    assert pool.submit(lambda: 41 + 1).result(5.0) == 42

    def boom():
        raise ValueError("nope")

    fut = pool.submit(boom)
    assert fut.wait(5.0)
    with pytest.raises(ValueError, match="nope"):
        fut.result(0.0)


def test_pool_workers_are_reused():
    pool = WorkPool(2, name="p-reuse")
    for _ in range(20):
        pool.submit(lambda: None).result(5.0)
    assert pool.worker_count() <= 2


def test_pool_submit_survives_thread_spawn_failure(monkeypatch):
    """submit() enqueues BEFORE spawning, so a Thread.start failure
    (OS thread pressure) must not raise to the caller — the item is
    already due to run, and raising would hand call sites an item that
    is both 'failed' and still executing (double accounting in the
    dispatch pipeline's slot tracking). The item drains via live
    workers, or via the retried spawn on the next submit."""
    import threading

    pool = WorkPool(3, name="p-spawnfail")
    # Warm one live worker so the queued item has a drain path.
    pool.submit(lambda: None).wait(5.0)

    real_start = threading.Thread.start
    fails = {"n": 0}

    def flaky_start(self):
        if self.name.startswith("p-spawnfail") and fails["n"] == 0:
            fails["n"] += 1
            raise RuntimeError("can't start new thread")
        return real_start(self)

    monkeypatch.setattr(threading.Thread, "start", flaky_start)
    # Saturate the live worker, then submit while a spawn would fire.
    gate = threading.Event()
    blocked = pool.submit(gate.wait, 10.0)
    fut = pool.submit(lambda: 42)  # spawn fails here — must NOT raise
    assert fails["n"] == 1
    gate.set()
    assert blocked.wait(5.0)
    assert fut.result(5.0) == 42  # the enqueued item still ran
    # A later submit retries the spawn successfully.
    assert pool.submit(lambda: 7).result(5.0) == 7


def test_pool_cold_spawn_failure_leaves_item_queued(monkeypatch):
    """Zero live workers + persistent spawn failure: submit must not
    raise, must not run the task inline (a never-block submitter like
    the dispatch pipeline's dispatcher would block), and must not drop
    it — the item stays honestly queued and the NEXT submit's spawn
    retry drains it."""
    import threading

    pool = WorkPool(2, name="p-coldfail")
    real_start = threading.Thread.start
    fails = {"n": 0}

    def flaky_start(self):
        # Both attempts (initial + immediate retry) of the first
        # submit fail; later spawns succeed.
        if self.name.startswith("p-coldfail") and fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("can't start new thread")
        return real_start(self)

    monkeypatch.setattr(threading.Thread, "start", flaky_start)
    order = []
    first = pool.submit(order.append, "first")
    assert fails["n"] == 2
    assert not first.done()  # queued, NOT run inline on this thread
    assert pool.queued() == 1
    # The next submit re-fires the spawn trigger; one worker drains
    # both items in FIFO order.
    second = pool.submit(order.append, "second")
    assert first.wait(5.0) and second.wait(5.0)
    assert order == ["first", "second"]


# ---------------------------------------------------------------------
# utils/httppool.py against a stdlib server on loopback


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"  # keep-alive

    def _reply(self, status, body):
        self.send_response(status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path.startswith("/missing"):
            self._reply(404, b"no such thing")
        else:
            self._reply(200, self.path.encode())

    def do_PUT(self):
        n = int(self.headers.get("Content-Length", 0))
        self._reply(200, self.rfile.read(n))

    def log_message(self, *args):
        pass


class _CountingServer(http.server.ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self):
        super().__init__(("127.0.0.1", 0), _Handler)
        self.accepted = 0

    def get_request(self):
        conn = super().get_request()
        self.accepted += 1
        return conn


@pytest.fixture
def http_srv():
    srv = _CountingServer()
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    pool = HTTPPool(f"http://127.0.0.1:{srv.server_address[1]}",
                    timeout=10.0)
    yield srv, pool
    pool.close()
    srv.shutdown()
    srv.server_close()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_sequential_requests_reuse_one_socket(http_srv):
    srv, pool = http_srv
    for i in range(10):
        status, _h, body = pool.request("GET", f"/v1/jobs?i={i}")
        assert (status, body) == (200, f"/v1/jobs?i={i}".encode())
    assert pool.dials == 1
    assert srv.accepted == 1


def test_puts_and_errors_keep_the_socket(http_srv):
    srv, pool = http_srv
    for i in range(5):
        status, _h, body = pool.request("PUT", "/v1/jobs",
                                        body=f"job-{i}".encode())
        assert (status, body) == (200, f"job-{i}".encode())
        status, _h, _b = pool.request("GET", "/missing/job")
        assert status == 404
    # Error replies carry Content-Length and must not poison reuse.
    assert pool.dials == 1
    assert srv.accepted == 1


def test_stale_pooled_socket_redials_once(http_srv):
    srv, pool = http_srv
    pool.request("GET", "/v1/jobs")
    assert pool.dials == 1
    # Kill the idle socket under the pool (what a server-side idle
    # timeout does between requests): shutdown, not close, so the fd
    # stays valid, checkout hands it out and the request fails; the
    # next request retries once on a fresh dial.
    with pool._lock:
        assert pool._idle
        for conn in pool._idle:
            conn.sock.shutdown(socket.SHUT_RDWR)
    status, _h, body = pool.request("GET", "/v1/nodes")
    assert (status, body) == (200, b"/v1/nodes")
    assert pool.dials == 2
    assert srv.accepted == 2


def test_unreachable_address_raises_pool_error():
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()  # nothing listens there now
    pool = HTTPPool(f"http://127.0.0.1:{port}", timeout=2.0)
    with pytest.raises(PoolError):
        pool.request("GET", "/v1/jobs")


def test_closed_pool_refuses_checkin():
    """A request in flight when close() runs must not park its socket
    into the closed pool's idle list (the SDK swaps pools on address
    change mid-request)."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    pool = HTTPPool(f"http://127.0.0.1:{port}")

    conn, _pooled = pool._checkout(5.0)
    conn.connect()
    pool.close()
    pool._checkin(conn)
    assert pool._idle == []
    assert conn.sock is None  # closed, not pooled
    srv.close()


# ---------------------------------------------------------------------
# utils/tlsutil.py on certificates made here


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


def _fields(ctx):
    return (ctx.protocol, ctx.verify_mode, ctx.check_hostname,
            ctx.minimum_version)


def test_contexts_match_the_reference_field_by_field(certs):
    files = (str(certs / "ca.pem"), str(certs / "node.pem"),
             str(certs / "node.key"))
    for verify_client in (True, False):
        got = tlsutil.server_context(*files, verify_client=verify_client)
        want = ref_tlsutil.server_context(*files,
                                          verify_client=verify_client)
        assert _fields(got) == _fields(want)
        assert got.verify_mode == (ssl.CERT_REQUIRED if verify_client
                                   else ssl.CERT_NONE)
    got, want = tlsutil.client_context(*files), \
        ref_tlsutil.client_context(*files)
    assert _fields(got) == _fields(want)
    assert got.check_hostname is False
    assert got.minimum_version == ssl.TLSVersion.TLSv1_2


@pytest.mark.parametrize("rpc,http_", [(True, True), (True, False),
                                       (False, True)])
def test_contexts_from_block_match_the_reference(certs, rpc, http_):
    block = SimpleNamespace(enabled=True, ca_file=str(certs / "ca.pem"),
                            cert_file=str(certs / "node.pem"),
                            key_file=str(certs / "node.key"),
                            rpc=rpc, http=http_)
    got = tlsutil.contexts_from_block(block)
    want = ref_tlsutil.contexts_from_block(block)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert _fields(g) == _fields(w)
    assert (got[0] is not None) == rpc and (got[1] is not None) == http_
    off = SimpleNamespace(enabled=False)
    assert tlsutil.contexts_from_block(off) == (None, None, None)


def test_contexts_refuse_missing_material(certs):
    partial = SimpleNamespace(enabled=True, ca_file=str(certs / "ca.pem"),
                              cert_file="", key_file="", rpc=True,
                              http=True)
    with pytest.raises(tlsutil.TLSConfigError):
        tlsutil.contexts_from_block(partial)
    with pytest.raises(tlsutil.TLSConfigError):
        tlsutil.client_context(str(certs / "ca.pem"),
                               str(certs / "no-such.pem"),
                               str(certs / "node.key"))


def _handshake(server_ctx, client_ctx):
    """One TLS handshake over loopback; returns the echoed bytes or
    raises the client's ssl error."""
    lst = socket.socket()
    lst.bind(("127.0.0.1", 0))
    lst.listen(1)
    port = lst.getsockname()[1]

    def serve():
        conn, _ = lst.accept()
        try:
            with server_ctx.wrap_socket(conn, server_side=True) as tls:
                tls.sendall(tls.recv(16))
        except (ssl.SSLError, OSError):
            pass

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=5.0) as s:
            with client_ctx.wrap_socket(s) as tls:
                tls.sendall(b"ping")
                return tls.recv(16)
    finally:
        t.join(timeout=5.0)
        lst.close()


def test_mutual_tls_handshake_and_wrong_ca_rejected(certs):
    files = (str(certs / "ca.pem"), str(certs / "node.pem"),
             str(certs / "node.key"))
    assert _handshake(tlsutil.server_context(*files),
                      tlsutil.client_context(*files)) == b"ping"
    rogue = tlsutil.client_context(str(certs / "rogue-ca.pem"),
                                   str(certs / "rogue.pem"),
                                   str(certs / "rogue.key"))
    with pytest.raises((ssl.SSLError, OSError)):
        _handshake(tlsutil.server_context(*files), rogue)


# ---------------------------------------------------------------------
# parity with the JAX package


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_backoff_delays_equal_under_one_seed(seed):
    kw = dict(base=0.05, factor=1.7, max_delay=1.5, jitter=0.25)
    random.seed(seed)
    port = Backoff(**kw)
    got = [port.next_delay() for _ in range(24)]
    random.seed(seed)
    ref = ref_backoff.Backoff(**kw)
    want = [ref.next_delay() for _ in range(24)]
    assert got == want


def test_timer_wheels_fire_in_the_same_order():
    delays = [0.12, 0.02, 0.09, 0.05, 0.15, 0.07, 0.03]
    orders = []
    for wheel_cls in (TimerWheel, ref_timer.TimerWheel):
        wheel = wheel_cls(name="t-parity", dispatch_workers=1)
        fired, lock, done = [], threading.Lock(), threading.Event()

        def cb(i, fired=fired, lock=lock, done=done):
            with lock:
                fired.append(i)
                if len(fired) == len(delays):
                    done.set()

        for i, d in enumerate(delays):
            wheel.schedule(d, cb, i)
        assert done.wait(5.0)
        orders.append(fired)
    assert orders[0] == orders[1] == sorted(range(len(delays)),
                                            key=lambda i: delays[i])


@pytest.mark.parametrize("value", [
    "${NOMAD_ALLOC_ID}-${ unknown }-${NOMAD_TASK_NAME}",
    ["a", "${NOMAD_JOB_NAME}", 3, None],
    {"args": ["--id=${NOMAD_ALLOC_ID}", {"x": "${NOMAD_REGION}"}],
     "n": 2.5, "raw": "$NOMAD_ALLOC_ID"},
])
def test_interpolation_equal(value):
    env = {"NOMAD_ALLOC_ID": "a1", "NOMAD_TASK_NAME": "web",
           "NOMAD_JOB_NAME": "example", "NOMAD_REGION": "global"}
    assert interpolate.interpolate_value(value, env) == \
        ref_interpolate.interpolate_value(value, env)
