"""The read plane on the port (the cases of tests/test_readplane.py on
nomad_tpu_torch's ReadMux, HTTPServer and Server): scoped-index
blocking queries, the parked-watcher mux, consistency modes, and
red-pressure read degradation; then the same write sequence through
both packages' read muxes, which must wake the same scopes."""

import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from torch_server import MockClient

from nomad_tpu import mock as ref_mock
from nomad_tpu.readplane import ReadMux as RefReadMux
from nomad_tpu.state import watch as ref_watch
from nomad_tpu.state.store import StateStore as RefStateStore
from nomad_tpu_torch import mock
from nomad_tpu_torch.api import Client, HTTPServer
from nomad_tpu_torch.api import http as http_mod
from nomad_tpu_torch.readplane import ReadMux
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.raft import InmemTransport
from nomad_tpu_torch.state import watch
from nomad_tpu_torch.state.store import StateStore


def wait_until(fn, timeout=5.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


def _raw_request(addr, path, method="GET", body=None, timeout=10.0):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(addr + path, data=data, method=method)
    req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
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


# ------------------------------------------------------ scoped indexes


def test_scope_index_tracks_per_item():
    store = StateStore()
    j1, j2 = mock.job(), mock.job()
    store.upsert_job(5, j1)
    store.upsert_job(9, j2)
    assert store.scope_index([watch.job(j1.id)]) == 5
    assert store.scope_index([watch.job(j2.id)]) == 9
    # table scope moves with every job write
    assert store.scope_index([watch.table("jobs")]) == 9
    # a scope never written reports the floor (0 on a fresh store)
    assert store.scope_index([watch.job("nope")]) == 0
    # max across a multi-item scope set
    assert store.scope_index([watch.job(j1.id), watch.job(j2.id)]) == 9


def test_scope_index_survives_persist_restore(tmp_path):
    store = StateStore()
    j = mock.job()
    store.upsert_job(7, j)
    blob = store.persist()
    restored = StateStore.restore(blob)
    assert restored.scope_index([watch.job(j.id)]) == 7
    assert restored.scope_index([watch.job("never-written")]) == 0


def test_legacy_snapshot_degrades_to_conservative_floor():
    store = StateStore()
    store.upsert_job(7, mock.job())
    blob = store.persist()
    blob.pop("scope_indexes", None)
    blob.pop("scope_floor", None)
    restored = StateStore.restore(blob)
    # Without persisted scopes every scope reports the global index:
    # conservative (global-style wakes), never missed ones.
    assert restored.scope_index([watch.job("anything")]) == 7


# --------------------------------------------------------- mux (unit)


def test_mux_storm_wakes_exactly_one_scope():
    """~200 parked watchers on disjoint scopes; ONE scope written →
    exactly that watcher re-ran, zero spurious wake-ups."""
    store = StateStore()
    mux = ReadMux(lambda: store, workers=2, max_parked=1024)
    mux.start()
    try:
        jobs = [mock.job() for _ in range(200)]
        for i, j in enumerate(jobs):
            store.upsert_job(i + 1, j)
        served = {}
        for i, j in enumerate(jobs):
            scopes = [watch.job(j.id)]

            def make_serve(slot):
                def serve(reason):
                    served[slot] = reason
                return serve

            assert mux.park(scopes, store.scope_index(scopes),
                            time.monotonic() + 30.0, make_serve(i))
        assert mux.stats()["parked"] == 200

        store.upsert_job(1000, jobs[37])
        assert wait_until(lambda: 37 in served)
        time.sleep(0.3)  # let any (wrong) extra wakes surface
        assert served == {37: "wake"}
        stats = mux.stats()
        assert stats["served"] == 1
        assert stats["spurious"] == 0
        assert stats["parked"] == 199
    finally:
        mux.stop()


def test_mux_expiry_is_thread_bounded():
    """Parking N watchers costs zero threads; serving N expirations
    uses only the fixed wake-owner + serve-pool threads."""
    store = StateStore()
    mux = ReadMux(lambda: store, workers=2)
    mux.start()
    try:
        time.sleep(0.1)
        ceiling = threading.active_count() + 2  # serve pool spawns lazily
        done = []
        for i in range(200):
            mux.park([("job", f"j{i}")], 10 ** 9,
                     time.monotonic() + 0.4, lambda reason: done.append(reason))
        assert threading.active_count() <= ceiling
        assert wait_until(lambda: len(done) == 200)
        assert all(r == "timeout" for r in done)
        assert mux.stats()["parked"] == 0
        assert mux.stats()["timeouts"] == 200
        assert threading.active_count() <= ceiling
    finally:
        mux.stop()


def test_mux_refuses_when_full_or_stopped():
    store = StateStore()
    mux = ReadMux(lambda: store, workers=1, max_parked=2)
    # not started yet → refuse (caller thread-parks)
    assert not mux.park([("job", "a")], 10 ** 9,
                        time.monotonic() + 5.0, lambda r: None)
    mux.start()
    try:
        assert mux.park([("job", "a")], 10 ** 9,
                        time.monotonic() + 5.0, lambda r: None)
        assert mux.park([("job", "b")], 10 ** 9,
                        time.monotonic() + 5.0, lambda r: None)
        assert not mux.park([("job", "c")], 10 ** 9,
                            time.monotonic() + 5.0, lambda r: None)
    finally:
        mux.stop()


def test_mux_park_closes_check_then_park_race():
    """A commit landing between the caller's index check and park()
    must still wake the continuation (post-registration recheck)."""
    store = StateStore()
    j = mock.job()
    store.upsert_job(1, j)
    mux = ReadMux(lambda: store, workers=1)
    mux.start()
    try:
        # Simulate: caller checked at index 1, then the write landed
        # BEFORE park() registered the continuation.
        store.upsert_job(2, j)
        served = []
        assert mux.park([watch.job(j.id)], 1,
                        time.monotonic() + 30.0, lambda r: served.append(r))
        assert wait_until(lambda: served == ["wake"])
    finally:
        mux.stop()


# ----------------------------------------------------- HTTP long-polls


def _park_raw(host, port, path):
    s = socket.create_connection((host, port), timeout=15)
    s.sendall(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    return s


def _read_raw_response(s):
    # A served park keeps the connection alive (pooled SDK clients
    # reuse it for their next poll), so read the Content-Length frame —
    # recv-to-EOF would hang until the idle timeout.
    buf = b""
    while b"\r\n\r\n" not in buf:
        chunk = s.recv(65536)
        if not chunk:
            break
        buf = buf + chunk
    head, _, payload = buf.partition(b"\r\n\r\n")
    lines = head.decode().split("\r\n")
    status = int(lines[0].split()[1])
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip()] = v.strip()
    want = int(headers.get("Content-Length", len(payload)))
    while len(payload) < want:
        chunk = s.recv(65536)
        if not chunk:
            break
        payload = payload + chunk
    return status, headers, json.loads(payload)


def test_http_storm_parks_without_threads_and_wakes_one_scope(api):
    """End to end: 200 blocking queries on disjoint alloc_job scopes
    hold ZERO handler threads while parked; a write touching one scope
    wakes only that watcher."""
    client, server = api
    host, port = client.address.split("//")[1].split(":")
    port = int(port)
    baseline = threading.active_count()
    socks = [
        _park_raw(host, port,
                  f"/v1/job/storm-{i}/allocations?index=1&wait=30")
        for i in range(200)
    ]
    try:
        assert wait_until(
            lambda: server.read_mux.stats()["parked"] >= 200, timeout=15.0)
        # Handler threads exit on park: no thread per parked watcher.
        assert wait_until(
            lambda: threading.active_count() <= baseline + 8, timeout=10.0)

        # Touch exactly one watched scope.
        a = mock.alloc()
        a.job_id = "storm-37"
        server.fsm.state.upsert_allocs(
            server.fsm.state.latest_index() + 1, [a])

        assert wait_until(
            lambda: server.read_mux.stats()["served"] >= 1, timeout=5.0
        ), server.read_mux.stats()
        status, headers, body = _read_raw_response(socks[37])
        assert status == 200
        assert len(body) == 1 and body[0]["job_id"] == "storm-37"
        assert int(headers["X-Nomad-Index"]) > 0
        assert headers.get("Connection") == "keep-alive"

        # Nobody else woke: the other sockets are still silent.
        for i in (0, 100, 199):
            socks[i].settimeout(0.05)
            with pytest.raises(socket.timeout):
                socks[i].recv(1)
        stats = server.read_mux.stats()
        assert stats["spurious"] == 0
        assert stats["served"] == 1
        assert stats["parked"] == 199

        # The woken socket was handed BACK to the server: the same
        # connection carries the next blocking query (the SDK pool's
        # O(clients)-sockets contract — tests/test_httppool.py).
        socks[37].settimeout(15)
        idx = int(headers["X-Nomad-Index"])
        socks[37].sendall(
            f"GET /v1/job/storm-37/allocations?index={idx}&wait=30"
            " HTTP/1.1\r\nHost: t\r\n\r\n".encode())
        assert wait_until(
            lambda: server.read_mux.stats()["parked"] >= 200, timeout=10.0
        ), server.read_mux.stats()
    finally:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass


def test_blocking_query_wakes_on_scope_write_only(api):
    """A write to job B must not satisfy a watcher of job A's allocs —
    the scoped-index replacement for the global-index wake."""
    client, server = api
    job_a = mock.job()
    job_a.task_groups[0].count = 1
    client.jobs.register(job_a)
    assert wait_until(lambda: len(client.jobs.allocations(job_a.id)[0]) == 1)
    _, idx = client.jobs.allocations(job_a.id)

    results = {}

    def blocker():
        t0 = time.monotonic()
        out, new_idx = client.jobs.allocations(job_a.id, index=idx, wait=3.0)
        results["elapsed"] = time.monotonic() - t0
        results["index"] = new_idx

    t = threading.Thread(target=blocker)
    t.start()
    time.sleep(0.3)
    # Unrelated write: registering job B churns the jobs table, evals,
    # and job B's alloc scopes — none of them job A's alloc scope.
    job_b = mock.job()
    job_b.task_groups[0].count = 1
    client.jobs.register(job_b)
    time.sleep(0.7)
    assert t.is_alive(), "watcher woke on an unrelated scope"
    # Now a write that IS in scope.
    server.job_deregister(job_a.id)
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert results["index"] > idx
    assert results["elapsed"] < 3.0


BLOCKING_ROUTES = [
    "/v1/jobs",
    "/v1/job/nope",
    "/v1/job/nope/allocations",
    "/v1/job/nope/evaluations",
    "/v1/job/nope/summary",
    "/v1/nodes",
    "/v1/node/nope",
    "/v1/node/nope/allocations",
    "/v1/allocations",
    "/v1/allocation/nope",
    "/v1/evaluations",
    "/v1/evaluation/nope",
    "/v1/evaluation/nope/allocations",
]


@pytest.mark.parametrize("path", BLOCKING_ROUTES)
def test_effective_wait_echoed_on_every_blocking_route(api, monkeypatch,
                                                       path):
    """An over-limit ?wait= is clamped AND the clamp is reported, on
    all 13 blocking routes (the PR 5 dequeue contract, generalized)."""
    client, _server = api
    monkeypatch.setattr(http_mod, "MAX_BLOCKING_WAIT", 0.2)
    _status, headers, _body = _raw_request(
        client.address, path + "?index=999999999&wait=99999")
    assert headers.get("X-Nomad-Effective-Wait") == "0.200"


def test_effective_wait_absent_without_wait_param(api):
    client, _server = api
    _status, headers, _body = _raw_request(client.address, "/v1/jobs")
    assert "X-Nomad-Effective-Wait" not in headers


# ---------------------------------------------------- consistency modes


def test_stale_read_stamps_staleness_headers(api):
    client, _server = api
    status, headers, _body = _raw_request(client.address, "/v1/jobs?stale")
    assert status == 200
    # The dev server IS the leader: zero staleness, leader known.
    assert headers.get("X-Nomad-LastContact") == "0"
    assert headers.get("X-Nomad-KnownLeader") == "true"


def test_stale_and_consistent_are_exclusive(api):
    client, _server = api
    status, _headers, body = _raw_request(
        client.address, "/v1/jobs?stale&consistent")
    assert status == 400
    assert "mutually exclusive" in body["error"]


def test_consistent_read_observes_commit_on_follower():
    """?consistent on a follower waits for the FSM to reach the
    leader's last-known commit index before serving."""
    transport = InmemTransport()
    cluster = {}
    ids = ["s0", "s1", "s2"]
    servers = []
    for node_id in ids:
        cfg = ServerConfig(num_schedulers=1, eval_nack_timeout=5.0)
        cfg.node_name = node_id
        server = Server(cfg)
        server.start_with_raft(node_id, ids, transport, cluster)
        servers.append(server)
    http = None
    try:
        assert wait_until(
            lambda: len([s for s in servers if s.is_leader()]) == 1,
            timeout=10.0)
        leader = next(s for s in servers if s.is_leader())
        follower = next(s for s in servers if not s.is_leader())
        http = HTTPServer(follower)
        http.start()

        job = mock.job()
        _eval_id, idx = leader.job_register(job)
        # The follower has HEARD of the commit (leader_commit piggyback)
        # before the consistent read is issued; ?consistent then makes
        # the local FSM catch up to it before serving.
        assert wait_until(
            lambda: follower.raft.known_commit_index() >= idx, timeout=10.0)
        status, headers, body = _raw_request(
            http.addr, f"/v1/job/{job.id}?consistent")
        assert status == 200
        assert body["id"] == job.id

        # And the stale mode on the same follower reports its leader
        # contact age instead of forwarding.
        status, headers, _body = _raw_request(
            http.addr, f"/v1/job/{job.id}?stale")
        assert status == 200
        assert int(headers["X-Nomad-LastContact"]) >= 0
        assert headers["X-Nomad-KnownLeader"] == "true"
    finally:
        if http is not None:
            http.stop()
        for s in servers:
            s.shutdown()


# ------------------------------------------------- degradation coupling


def test_red_pressure_degrades_reads_to_stale(api):
    """Over-budget red reads serve the local replica in stale mode
    (X-Nomad-Degraded) instead of 429ing, once state exists. The read
    bucket is held empty by its own refill rate, 0: the reference test
    drains it and races its refill."""
    client, server = api
    client.jobs.register(mock.job())
    ctl = server.admission
    bucket = ctl._read
    rate, burst = bucket.rate, bucket.burst
    with bucket._lock:
        bucket.rate, bucket.burst, bucket._tokens = 0.0, 0.0, 0.0
    ctl.force_level("red")
    try:
        status, headers, _body = _raw_request(client.address, "/v1/jobs")
        assert status == 200
        assert headers.get("X-Nomad-Degraded") == "stale"
        assert headers.get("X-Nomad-KnownLeader") == "true"
        assert "X-Nomad-LastContact" in headers
        assert bucket.stats()["rejected"] >= 1
    finally:
        ctl.force_level(None)
        with bucket._lock:
            bucket.rate, bucket.burst = rate, burst


def test_mux_disabled_falls_back_to_thread_parking():
    """read_mux_enabled=false restores the classic handler-thread park:
    blocking queries still work, no continuation is registered."""
    cfg = ServerConfig(num_schedulers=1, read_mux_enabled=False)
    server = Server(cfg)
    server.start()
    http = HTTPServer(server)
    http.start()
    client = Client(http.addr, timeout=10.0)
    try:
        job = mock.job()
        client.jobs.register(job)
        _, idx = client.jobs.list()
        results = {}

        def blocker():
            out, new_idx = client.jobs.list(index=idx, wait=5.0)
            results["index"] = new_idx

        t = threading.Thread(target=blocker)
        t.start()
        time.sleep(0.3)
        client.jobs.register(mock.job())
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert results["index"] > idx
        assert server.read_mux.stats()["parked_total"] == 0
    finally:
        http.stop()
        server.shutdown()


# ------------------------------------------- the two packages' muxes


def _mux_pair_step(muxes):
    """Let each mux's wake loop take every queued notification and its
    serve pool run what it woke."""
    for mux in muxes:
        assert wait_until(lambda mux=mux: not mux._pending
                          and mux._pool.queued() == 0)
    time.sleep(0.3)


def _jobs_and_allocs(mock_mod, n_jobs):
    jobs = []
    for i in range(n_jobs):
        job = mock_mod.job()
        job.id = f"job-{i}"
        jobs.append(job)
    allocs = []
    for i in range(n_jobs):
        alloc = mock_mod.alloc()
        alloc.id = f"alloc-{i}"
        alloc.job_id = jobs[i].id
        alloc.job = jobs[i]
        alloc.node_id = f"node-{i % 3}"
        allocs.append(alloc)
    return jobs, allocs


@pytest.mark.parametrize("seed", [0, 1])
def test_both_muxes_wake_the_same_scopes(seed):
    """The same parked watchers and the same write sequence through the
    JAX package's ReadMux over its StateStore and the port's over its
    own: after every write, the same watchers were served, for the same
    reason, and the counters agree."""
    import random

    rng = random.Random(seed)
    n_jobs = 12
    pkgs = [(RefStateStore, RefReadMux, ref_watch, ref_mock),
            (StateStore, ReadMux, watch, mock)]
    sides = []
    for store_cls, mux_cls, watch_mod, mock_mod in pkgs:
        store = store_cls()
        jobs, allocs = _jobs_and_allocs(mock_mod, n_jobs)
        for i, job in enumerate(jobs):
            store.upsert_job(i + 1, job)
        mux = mux_cls(lambda store=store: store, workers=2)
        mux.start()
        sides.append(dict(store=store, mux=mux, jobs=jobs, allocs=allocs,
                          watch=watch_mod, served=[]))

    def scopes_of(w, k):
        kinds = [lambda i: w.job(f"job-{i}"),
                 lambda i: w.alloc_job(f"job-{i}"),
                 lambda i: w.alloc_node(f"node-{i % 3}"),
                 lambda i: w.table("jobs"),
                 lambda i: w.table("allocs")]
        return [kinds[k % len(kinds)](k)]

    try:
        for side in sides:
            w, store = side["watch"], side["store"]
            for k in range(3 * n_jobs):
                scopes = scopes_of(w, k)

                def serve(reason, k=k, side=side):
                    side["served"].append((k, reason))

                assert side["mux"].park(scopes, store.scope_index(scopes),
                                        time.monotonic() + 60.0, serve)
        writes = []
        for step in range(8):
            i = rng.randrange(n_jobs)
            writes.append(("job", i) if rng.random() < 0.5
                          else ("alloc", i))
        index = n_jobs + 1
        for kind, i in writes:
            index += 1
            for side in sides:
                if kind == "job":
                    side["store"].upsert_job(index, side["jobs"][i])
                else:
                    side["store"].upsert_allocs(index, [side["allocs"][i]])
            _mux_pair_step([s["mux"] for s in sides])
            ref, port = (sorted(s["served"]) for s in sides)
            assert port == ref, (kind, i)
        assert sides[0]["served"], writes
        counters = ("parked", "parked_total", "spurious", "served",
                    "timeouts", "write_errors")
        ref, port = ({c: s["mux"].stats()[c] for c in counters}
                     for s in sides)
        assert port == ref
    finally:
        for side in sides:
            side["mux"].stop()
