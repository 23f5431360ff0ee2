"""The port's serf gossip (nomad_tpu_torch/server/serf.py): the
TestSerf cases and the digest anti-entropy cases of tests/test_serf.py,
and the serf parity: ``_outranks``, ``_diff_digest`` and ``_merge``
give the JAX package's member tables on seeded inputs, and a port
member and a JAX member gossip with each other over the same frames."""

import random
import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu.server import serf as ref_serf
from nomad_tpu_torch.server import serf as serf_mod
from nomad_tpu_torch.server.serf import ALIVE, FAILED, LEFT, Serf


def wait_until(fn, timeout=20.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return fn()


class TestSerf:
    def test_join_and_member_exchange(self):
        events = []
        a = Serf("a.global", probe_interval=0.1)
        b = Serf("b.global", on_event=lambda ev, m: events.append((ev, m.name)),
                 probe_interval=0.1)
        try:
            addr_a = a.serve()
            b.serve()
            assert b.join([addr_a]) == 1
            assert wait_until(lambda: len(a.members()) == 2)
            assert {m.name for m in a.members()} == {"a.global", "b.global"}
            assert ("member-join", "a.global") in events
        finally:
            a.shutdown()
            b.shutdown()

    def test_transitive_membership_via_gossip(self):
        """c joins b only; a learns about c through the gossip rounds."""
        a, b, c = Serf("a", probe_interval=0.05), Serf("b", probe_interval=0.05), \
            Serf("c", probe_interval=0.05)
        try:
            addr_a = a.serve()
            addr_b = b.serve()
            c.serve()
            b.join([addr_a])
            c.join([addr_b])
            assert wait_until(lambda: len(a.members()) == 3)
        finally:
            for s in (a, b, c):
                s.shutdown()

    def test_graceful_leave(self):
        a = Serf("a", probe_interval=0.05)
        b = Serf("b", probe_interval=0.05)
        try:
            addr_a = a.serve()
            b.serve()
            b.join([addr_a])
            wait_until(lambda: len(a.members()) == 2)
            b.leave()
            assert wait_until(
                lambda: any(
                    m.name == "b" and m.status == LEFT for m in a.members()
                )
            )
        finally:
            a.shutdown()
            b.shutdown()

    def test_failure_detection(self):
        a = Serf("a", probe_interval=0.05, suspicion_probes=2)
        b = Serf("b", probe_interval=0.05)
        try:
            addr_a = a.serve()
            b.serve()
            b.join([addr_a])
            wait_until(lambda: len(a.members()) == 2)
            # Hard-kill b (no graceful leave): a must mark it failed.
            b.shutdown()
            assert wait_until(
                lambda: any(
                    m.name == "b" and m.status == FAILED for m in a.members()
                ),
                timeout=20.0,
            )
        finally:
            a.shutdown()

    def test_force_leave(self):
        a = Serf("a", probe_interval=0.05)
        b = Serf("b", probe_interval=0.05)
        try:
            addr_a = a.serve()
            b.serve()
            b.join([addr_a])
            wait_until(lambda: len(a.members()) == 2)
            assert a.force_leave("b")
            assert [m for m in a.members() if m.name == "b"][0].status == LEFT
        finally:
            a.shutdown()
            b.shutdown()


@pytest.fixture()
def two_region_cluster():
    """One dev server per region, gossip-joined, each with HTTP."""
    servers, https = [], []
    for region in ("global", "east"):
        cfg = ServerConfig(region=region, node_name=f"srv-{region}",
                           num_schedulers=1)
        srv = Server(cfg)
        srv.start()
        http = HTTPServer(srv)
        http.start()
        srv.setup_serf(http_addr=http.addr)
        # speed up gossip for tests
        srv.serf.probe_interval = 0.05
        servers.append(srv)
        https.append(http)
    servers[1].serf_join([servers[0].serf.local_member.addr])
    assert wait_until(
        lambda: len(servers[0].regions()) == 2 and len(servers[1].regions()) == 2
    )
    yield servers, https
    for http in https:
        http.stop()
    for srv in servers:
        srv.shutdown()



def test_digest_diff_semantics():
    """_diff_digest: newer-here rows become updates, newer-there rows
    become wants, and a status edge at EQUAL incarnation still
    propagates (failure detection is a status edge)."""
    from nomad_tpu_torch.server.serf import ALIVE, FAILED, Member, Serf

    s = Serf("a")
    with s._lock:
        s._members["b"] = Member(name="b", incarnation=3, status=ALIVE)
        s._members["c"] = Member(name="c", incarnation=1, status=FAILED)
    updates, want = s._diff_digest({
        "a": [0, ALIVE],         # equal: not sent
        "b": [2, ALIVE],         # we are newer: update
        "c": [1, ALIVE],         # equal incarnation, status differs: update
        "d": [5, ALIVE],         # unknown here: want
    })
    assert sorted(m.name for m in updates) == ["b", "c"]
    assert want == ["d"]


def test_digest_push_pull_converges_and_sends_no_steady_state_records():
    """Two members converge through the digest protocol, and once
    converged a sync round ships ZERO member records either way —
    the O(members^2)-state-per-round concern the full-table exchange
    had."""
    from nomad_tpu_torch.server.serf import Serf

    a = Serf("a", probe_interval=999)  # no background gossip: drive by hand
    b = Serf("b", probe_interval=999)
    addr_a = a.serve("127.0.0.1", 0)
    addr_b = b.serve("127.0.0.1", 0)
    try:
        a.set_tags({"role": "server"})
        assert a._push_pull(addr_b)
        # The responder merges the initiator's reply frame in its
        # handler thread; poll for the propagation.
        assert wait_until(
            lambda: {m.name for m in b.members()} == {"a", "b"})
        assert any(m.tags.get("role") == "server"
                   for m in b.members() if m.name == "a")
        assert b._push_pull(addr_a)
        assert wait_until(
            lambda: {m.name for m in a.members()} == {"a", "b"})

        # Converged: a further round must carry no records.
        updates_ab, want_ab = b._diff_digest(a._digest())
        assert updates_ab == [] and want_ab == []
    finally:
        a.shutdown()
        b.shutdown()


def test_digest_semantics_update_test_follows_status_rank():
    """Equal-incarnation rules: FAILED/LEFT outrank ALIVE in both
    directions — our terminal row is an update against their ALIVE,
    their terminal row is a want against our ALIVE — and an ALIVE row
    never pulls back a terminal one."""
    from nomad_tpu_torch.server.serf import ALIVE, FAILED, LEFT, Member, Serf

    s = Serf("a")
    with s._lock:
        s._members["x"] = Member(name="x", incarnation=2, status=FAILED)
        s._members["y"] = Member(name="y", incarnation=1, status=ALIVE)
        s._members["z"] = Member(name="z", incarnation=1, status=ALIVE)
    updates, want = s._diff_digest({
        "a": [0, ALIVE],
        "x": [2, ALIVE],   # our FAILED outranks their ALIVE: update
        "y": [1, LEFT],    # their LEFT outranks our ALIVE: want
        "z": [1, ALIVE],   # identical: silence
    })
    assert sorted(m.name for m in updates) == ["x"]
    assert want == ["y"]


def test_failed_status_propagates_and_is_not_reverted():
    """A detector's FAILED marking must spread through gossip and must
    NOT be erased by a peer still holding ALIVE at the same
    incarnation (the regression a naive equal-incarnation
    last-writer-wins merge reintroduces)."""
    from nomad_tpu_torch.server.serf import FAILED, Serf

    a = Serf("a", probe_interval=999)
    b = Serf("b", probe_interval=999)
    addr_a = a.serve("127.0.0.1", 0)
    addr_b = b.serve("127.0.0.1", 0)
    c = Serf("c", probe_interval=999)
    addr_c = c.serve("127.0.0.1", 0)
    try:
        a.join([addr_b, addr_c])
        # Spread C to B (the B sync during join ran before A knew C).
        assert a._push_pull(addr_b)
        assert wait_until(lambda: len(b.members()) == 3
                          and len(c.members()) == 3)
        c.shutdown()
        a._mark_failed("c")
        assert a.member_status("c") == FAILED if hasattr(a, "member_status") \
            else [m for m in a.members() if m.name == "c"][0].status == FAILED

        # A -> B: the FAILED edge crosses at c's unchanged incarnation.
        assert a._push_pull(addr_b)
        assert wait_until(lambda: [
            m for m in b.members() if m.name == "c"][0].status == FAILED)
        # B -> A with B's (now shared) view: A's marking survives.
        assert b._push_pull(addr_a)
        assert [m for m in a.members()
                if m.name == "c"][0].status == FAILED
    finally:
        a.shutdown()
        b.shutdown()


def test_legacy_peer_fallback_full_table():
    """A digest initiator talking to a pre-digest responder falls back
    to the full-table exchange instead of counting the peer failed."""
    import socketserver
    import threading

    from nomad_tpu_torch.server.serf import Member, Serf, _recv_frame, _send_frame

    state = {"members": []}

    class LegacyHandler(socketserver.BaseRequestHandler):
        def handle(self):
            try:
                msg = _recv_frame(self.request)
                if msg is None:
                    return
                if msg.get("kind") == "push_pull":
                    state["members"] = msg["members"]
                    _send_frame(self.request, {"members": [
                        Member(name="legacy", addr="x").to_wire()]})
                # unknown kinds: drop, like the old implementation
            except OSError:
                pass

    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), LegacyHandler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    addr = "%s:%d" % srv.server_address
    s = Serf("new", probe_interval=999)
    s.serve("127.0.0.1", 0)
    try:
        assert s._push_pull(addr) is True
        assert any(m.name == "legacy" for m in s.members())
        assert any(m["name"] == "new" for m in state["members"])
    finally:
        s.shutdown()
        srv.shutdown()
        srv.server_close()


def test_randomized_gossip_convergence():
    """Seeded fuzz: N members with random join order, tag updates, one
    graceful leave, and one hard kill (detected by a random survivor,
    spread as a FAILED edge), driven by explicit push-pull rounds in
    random directions — every surviving member must converge to the
    same view (names, statuses, incarnations) within a bounded number
    of rounds. Protocol-level confidence for the digest path's
    update/want symmetry and dead-state dominance."""
    rng = random.Random(1234)
    n = 6
    members = [Serf(f"m{i}", probe_interval=999) for i in range(n)]
    addrs = [m.serve("127.0.0.1", 0) for m in members]
    alive = set(range(n))
    try:
        # Random joins: each member syncs with a few random peers.
        for i in range(n):
            for j in rng.sample([x for x in range(n) if x != i], 2):
                members[i]._push_pull(addrs[j])
        # Random activity: tag bumps, one graceful leave, one hard
        # kill detected by a random survivor.
        for _ in range(4):
            members[rng.choice(sorted(alive))].set_tags(
                {"v": str(rng.randint(1, 9))})
        leaver = rng.choice(sorted(alive - {0}))
        members[leaver].leave()
        alive.discard(leaver)
        victim = rng.choice(sorted(alive - {0}))
        members[victim].shutdown()
        alive.discard(victim)
        detector = rng.choice(sorted(alive))
        # The detector must already KNOW the victim (handler-thread
        # merges lag _push_pull), and the marking must visibly take —
        # a silent no-op here would surface 120 rounds later as an
        # inscrutable convergence failure.
        assert wait_until(lambda: any(
            m.name == f"m{victim}" for m in members[detector].members()))
        members[detector]._mark_failed(f"m{victim}")
        assert [m for m in members[detector].members()
                if m.name == f"m{victim}"][0].status == FAILED

        # Anti-entropy rounds in random directions until converged.
        # The responder merges the final updates frame in its handler
        # thread AFTER _push_pull returns: give each round a short
        # settle so the check doesn't race that merge.
        def views():
            out = {}
            for i in sorted(alive):
                out[i] = {(m.name, m.status, m.incarnation)
                          for m in members[i].members()}
            return out

        for _round in range(120):
            i = rng.choice(sorted(alive))
            targets = [j for j in alive if j != i]
            members[i]._push_pull(addrs[rng.choice(targets)])
            time.sleep(0.02)
            v = views()
            if len({frozenset(x) for x in v.values()}) == 1:
                converged = v
                break
        else:
            raise AssertionError(f"never converged: {views()}")

        # The leaver is LEFT everywhere, the killed member FAILED
        # everywhere (dead-state dominance spread one detector's
        # marking), everyone else ALIVE.
        sample = next(iter(converged.values()))
        statuses = {name: status for name, status, _inc in sample}
        assert statuses[f"m{leaver}"] == LEFT
        assert statuses[f"m{victim}"] == FAILED
        for i in sorted(alive):
            assert statuses[f"m{i}"] == ALIVE
    finally:
        for i in sorted(alive):
            members[i].shutdown()


# ------------------------------------------------------------ parity

STATUSES = (ALIVE, FAILED, LEFT, "unknown")


@pytest.mark.parametrize("a", STATUSES)
@pytest.mark.parametrize("b", STATUSES)
def test_outranks_matches_the_reference(a, b):
    assert serf_mod._outranks(a, b) == ref_serf._outranks(a, b)


def seeded_members(mod, rng, names):
    """Member records of ``mod`` (either package's serf module) with
    seeded incarnations, statuses and tags."""
    return [mod.Member(
        name=name, region=rng.choice(["global", "east"]),
        datacenter=rng.choice(["dc1", "dc2"]),
        addr=f"127.0.0.1:{rng.randint(1024, 65535)}",
        status=rng.choice([ALIVE, FAILED, LEFT]),
        incarnation=rng.randint(0, 4),
        tags={"rpc_addr": f"10.0.0.{rng.randint(1, 9)}:4647",
              "v": str(rng.randint(0, 3))})
        for name in names]


def table(serf):
    """A member table as plain data, by name."""
    return {m.name: m.to_wire() for m in serf.members()}


def seeded_pair(seed):
    """A port Serf and a JAX Serf holding the same seeded table."""
    rng = random.Random(seed)
    names = [f"m{i}" for i in range(8)]
    rows = seeded_members(ref_serf, rng, names)
    ours, ref = Serf("local"), ref_serf.Serf("local")
    with ours._lock, ref._lock:
        for m in rows:
            ours._members[m.name] = serf_mod.Member.from_wire(m.to_wire())
            ref._members[m.name] = ref_serf.Member.from_wire(m.to_wire())
    return rng, names, ours, ref


@pytest.mark.parametrize("seed", range(6))
def test_diff_digest_matches_the_reference(seed):
    """The same table against the same seeded digest (known, unknown
    and absent names, every status at equal and other incarnations):
    equal updates (as wire records, in order) and equal wants."""
    rng, names, ours, ref = seeded_pair(seed)
    digest = {}
    for name in names[2:] + ["local", "x0", "x1"]:
        digest[name] = [rng.randint(0, 4), rng.choice([ALIVE, FAILED, LEFT])]
    got_up, got_want = ours._diff_digest(digest)
    want_up, want_want = ref._diff_digest(digest)
    assert [m.to_wire() for m in got_up] == [m.to_wire() for m in want_up]
    assert got_want == want_want


@pytest.mark.parametrize("seed", range(6))
def test_merge_matches_the_reference(seed):
    """Seeded remote tables (rumours of the local member's own death
    among them) merged into equal local tables: equal member tables,
    equal local incarnations, and the same events in the same order."""
    rng, names, ours, ref = seeded_pair(seed)
    events = {"ours": [], "ref": []}
    ours.on_event = lambda ev, m: events["ours"].append((ev, m.to_wire()))
    ref.on_event = lambda ev, m: events["ref"].append((ev, m.to_wire()))
    for _round in range(3):
        remote = seeded_members(
            ref_serf, rng, rng.sample(names + ["local", "new0", "new1"], 6))
        ours._merge([serf_mod.Member.from_wire(m.to_wire()) for m in remote])
        ref._merge([ref_serf.Member.from_wire(m.to_wire()) for m in remote])
        assert table(ours) == table(ref)
        assert ours.local_member.incarnation == ref.local_member.incarnation
    assert events["ours"] == events["ref"]


def test_port_and_reference_members_gossip_together():
    """A port member and a JAX member converge through the digest
    push-pull in both directions: the frames are the same."""
    ours = Serf("port", probe_interval=999)
    ref = ref_serf.Serf("ref", probe_interval=999)
    addr_ours = ours.serve("127.0.0.1", 0)
    addr_ref = ref.serve("127.0.0.1", 0)
    try:
        ours.set_tags({"role": "nomad"})
        ref.set_tags({"rpc_addr": "127.0.0.1:4647"})
        assert ours._push_pull(addr_ref)
        assert wait_until(lambda: {m.name for m in ref.members()}
                          == {"port", "ref"})
        assert ref._push_pull(addr_ours)
        assert wait_until(lambda: {m.name for m in ours.members()}
                          == {"port", "ref"})
        assert wait_until(lambda: table(ours) == table(ref))
    finally:
        ours.shutdown()
        ref.shutdown()
