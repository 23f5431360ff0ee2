"""The port's raft against the JAX package's, on the same inputs.

- Handlers: a JAX RaftNode and a port RaftNode, neither started, take
  the same seeded script of request_vote (votes and pre-votes),
  append_entries (config entries, conflicts and stale terms among them)
  and install_snapshot dicts on one fake clock. Their responses, logs
  (term, index, type), commit index, term, vote and members are equal
  after every step (exact equality).
- Storage: both packages' RaftStorage write byte-identical meta, log and
  snapshot files for the same entries, and each loads the other's.
- Wire: both ``_encode_payload``s give equal JSON for the same FSM
  payloads (the structs carried across with ``carry.py``), the port's
  ``fsm_payload_decoder`` yields the port's structs equal to the carried
  ones, and one port RaftNode with two JAX RaftNodes over TCPTransport
  elect a leader and apply the same entries in the same order.
"""

import json
import random
import time

import pytest

import torch_parity  # noqa: F401  (the port on the CPU)
from nomad_tpu import mock as ref_mock
from nomad_tpu.scheduler.testing import Harness
from nomad_tpu.server import raft as ref_raft
from nomad_tpu.server import raft_storage as ref_storage
from nomad_tpu.server import transport as ref_transport
from nomad_tpu.server.vault import VaultAccessor as RefVaultAccessor
from nomad_tpu.structs import consts
from nomad_tpu.utils.codec import to_dict as ref_to_dict
from nomad_tpu_torch import carry
from nomad_tpu_torch.server import raft
from nomad_tpu_torch.server import raft_storage
from nomad_tpu_torch.server import transport
from nomad_tpu_torch.server.vault import VaultAccessor
from nomad_tpu_torch.utils.codec import from_dict, to_dict

IDS = ["n0", "n1", "n2"]


class FakeClock:
    """One monotonic clock for both packages' raft modules, advanced by
    the script: the pre-vote's recent-leader window reads it."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    for mod in (raft, ref_raft):
        monkeypatch.setattr(mod, "time", fake)
    return fake


def make_nodes(restored):
    """A port and a JAX RaftNode "n0" of the cluster n0-n2, not started;
    their snapshot restores are recorded in ``restored``."""
    nodes = {}
    for name, mod in (("port", raft), ("ref", ref_raft)):
        nodes[name] = mod.RaftNode(
            "n0", IDS, mod.InmemTransport(), lambda *a: None,
            lambda _leader: None,
            fsm_restore=lambda data, name=name: restored[name].append(data))
    return nodes["port"], nodes["ref"]


def view(node):
    with node._lock:
        return dict(
            log=[(e.term, e.index, e.msg_type) for e in node.log],
            commit=node.commit_index, term=node.current_term,
            vote=node.voted_for, members=node._members_locked(),
            state=node.state, leader=node.leader_id,
            offset=node.log_offset, snapshot_term=node.snapshot_term,
            removed=node.removed)


def script(rng, ref, steps):
    """Seeded RPC dicts for node n0, mostly consistent with its log (read
    from the JAX node as the script goes) and now and then stale,
    conflicting or out of range."""
    for _ in range(steps):
        kind = rng.choices(["vote", "append", "snapshot", "tick"],
                           [3, 8, 1, 1])[0]
        term = max(1, ref.current_term + rng.choices(
            [-1, 0, 1, 2], [1, 12, 2, 1])[0])
        leader = rng.choice(["n1", "n2"])
        last = ref._last_log_index()
        if kind == "tick":
            yield "tick", rng.choice([0.05, 0.1, 0.2, 0.4])
        elif kind == "vote":
            yield "vote", {
                "term": term, "candidate_id": leader,
                "last_log_index": max(0, last + rng.randint(-2, 2)),
                "last_log_term": max(0, ref._last_log_term()
                                     + rng.randint(-1, 1)),
                **({"prevote": True} if rng.random() < 0.4 else {})}
        elif kind == "append":
            prev = max(0, min(last, last - rng.choice([0, 0, 0, 1, 2]))
                       + rng.choice([0, 0, 0, 0, 1]))
            entry = ref._entry_at(prev)
            if prev == ref.log_offset:
                prev_term = ref.snapshot_term
            else:
                prev_term = entry.term if entry is not None else 0
            if rng.random() < 0.1:
                prev_term += 1  # a mismatch
            entries = []
            for i in range(rng.randint(0, 3)):
                if rng.random() < 0.2:
                    members = sorted(set(rng.sample(IDS + ["n3", "n4"], 3))
                                     | {"n0"} if rng.random() < 0.8
                                     else set(rng.sample(["n1", "n2", "n3"],
                                                         2)))
                    mtype, payload = raft.CONFIG_TYPE, {"peers": members}
                elif rng.random() < 0.1:
                    mtype, payload = raft.NOOP_TYPE, None
                else:
                    mtype, payload = "test", {"v": rng.randint(0, 99)}
                entries.append({"term": term, "index": prev + 1 + i,
                                "msg_type": mtype, "payload": payload})
            yield "append", {
                "term": term, "leader_id": leader,
                "prev_log_index": prev, "prev_log_term": prev_term,
                "entries": entries,
                "leader_commit": max(0, last + rng.randint(-2, 3))}
        else:
            index = max(0, ref.log_offset + rng.randint(-1, 6))
            data = {"k": rng.randint(0, 99)}
            if rng.random() < 0.7:
                data = {"__raft_fsm__": data, "__raft_peers__": sorted(
                    set(rng.sample(IDS + ["n3"], 3)) | {"n0"})}
            yield "snapshot", {"term": term, "leader_id": leader,
                               "last_index": index,
                               "last_term": max(0, term - rng.randint(0, 1)),
                               "data": data}


HANDLERS = {"vote": "handle_request_vote",
            "append": "handle_append_entries",
            "snapshot": "handle_install_snapshot"}


@pytest.mark.parametrize("seed", range(8))
def test_handlers_match_the_reference_step_by_step(seed, clock):
    restored = {"port": [], "ref": []}
    port, ref = make_nodes(restored)
    rng = random.Random(seed)
    seen = set()
    for step, (kind, args) in enumerate(script(rng, ref, 150)):
        if kind == "tick":
            clock.sleep(args)
            continue
        got = getattr(port, HANDLERS[kind])(json.loads(json.dumps(args)))
        want = getattr(ref, HANDLERS[kind])(json.loads(json.dumps(args)))
        assert got == want, (step, kind, args)
        assert view(port) == view(ref), (step, kind, args)
        assert restored["port"] == restored["ref"]
        if got.get("vote_granted") or got.get("success"):
            seen.add((kind, args.get("prevote", False)))
        if ref.commit_index > 0 and len(ref.log) > 1:
            seen.add("log")
        if ref._members_locked() != IDS:
            seen.add("config")
        clock.sleep(0.01)
    # The script reached the states it exists for: votes and pre-votes
    # granted, appends accepted, a committed log, a member change and
    # a snapshot installed.
    assert {("vote", False), ("vote", True), ("append", False), "log",
            "config"} <= seen, seen
    assert restored["ref"]


# ------------------------------------------------------------- storage


def reference_cluster(seed, n_nodes=6):
    """A JAX store with nodes, a job, its allocs and an eval, and the
    port's store carried over from its persisted dicts."""
    h = Harness(seed=seed)
    nodes = []
    for _ in range(n_nodes):
        node = ref_mock.node()
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
        nodes.append(node)
    job = ref_mock.job()
    h.state.upsert_job(h.next_index(), job)
    allocs = []
    for i in range(3):
        alloc = ref_mock.alloc()
        alloc.job = job
        alloc.job_id = job.id
        alloc.node_id = nodes[i].id
        allocs.append(alloc)
    h.state.upsert_allocs(h.next_index(), allocs)
    ev = ref_mock.eval()
    ev.job_id = job.id
    h.state.upsert_evals(h.next_index(), [ev])
    ported = carry.state_from_reference(h.state.persist())
    return h.state, ported, job, nodes, allocs, ev


def payload_pairs(ref_state, port_state, job, nodes, allocs, ev):
    """(msg type, JAX payload, port payload) for each FSM message whose
    payload holds structs: the JAX records and the port's carried ones
    by id."""
    port_job = port_state.job_by_id(job.id)
    accessor = RefVaultAccessor(accessor="acc-1", alloc_id=allocs[0].id,
                                task="web", node_id=nodes[0].id,
                                policies=["p"])
    return [
        ("node_register", {"node": ref_state.node_by_id(nodes[0].id)},
         {"node": port_state.node_by_id(nodes[0].id)}),
        ("job_register", {"job": ref_state.job_by_id(job.id),
                          "enforce_index": True, "job_modify_index": 3},
         {"job": port_job, "enforce_index": True, "job_modify_index": 3}),
        ("eval_update", {"evals": [ref_state.eval_by_id(ev.id)],
                         "token": "t"},
         {"evals": [port_state.eval_by_id(ev.id)], "token": "t"}),
        ("alloc_update",
         {"allocs": [ref_state.alloc_by_id(a.id) for a in allocs],
          "job": ref_state.job_by_id(job.id)},
         {"allocs": [port_state.alloc_by_id(a.id) for a in allocs],
          "job": port_job}),
        ("alloc_client_update",
         {"allocs": [ref_state.alloc_by_id(allocs[1].id)]},
         {"allocs": [port_state.alloc_by_id(allocs[1].id)]}),
        ("vault_accessor_register", {"accessors": [accessor]},
         {"accessors": [from_dict(VaultAccessor, ref_to_dict(accessor))]}),
        ("node_update_status", {"node_id": nodes[1].id, "status": "down"},
         {"node_id": nodes[1].id, "status": "down"}),
    ]


@pytest.mark.parametrize("seed", [0, 1])
def test_storage_files_are_identical_and_cross_load(seed, tmp_path):
    ref_state, port_state, *rest = reference_cluster(seed)
    pairs = payload_pairs(ref_state, port_state, *rest)
    dirs = {}
    for name, smod, rmod, tmod, side in (
            ("port", raft_storage, raft, transport, 2),
            ("ref", ref_storage, ref_raft, ref_transport, 1)):
        d = tmp_path / name
        st = smod.RaftStorage(
            str(d), encode=lambda mt, p, t=tmod: t._encode_payload(p),
            decode=tmod.fsm_payload_decoder)
        st.save_meta(3, "n1")
        entries = [rmod.LogEntry(2, i + 1, p[0], p[side])
                   for i, p in enumerate(pairs)]
        for e in entries[:4]:
            st.append_entry(e)
        st.rewrite_log(entries[2:6])
        for e in entries[6:]:
            st.append_entry(e)
        for index in (2, 4, 6):
            st.save_snapshot(index, 2, {"__raft_fsm__": {"i": index},
                                        "__raft_peers__": IDS})
        st.close()
        dirs[name] = d
    names = sorted(p.name for p in dirs["ref"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert len([n for n in names if n.startswith("snapshot-")]) == 2
    for n in names:
        assert (dirs["port"] / n).read_bytes() == (dirs["ref"] / n).read_bytes(), n

    # Each package loads the other's directory.
    ours = raft_storage.RaftStorage(str(dirs["ref"]),
                                    decode=transport.fsm_payload_decoder)
    theirs = ref_storage.RaftStorage(str(dirs["port"]),
                                     decode=ref_transport.fsm_payload_decoder)
    assert ours.load_meta() == theirs.load_meta() == (3, "n1")
    assert ours.load_latest_snapshot() == theirs.load_latest_snapshot()
    got = ours.load_log(raft.LogEntry)
    want = theirs.load_log(ref_raft.LogEntry)
    assert [(e.term, e.index, e.msg_type) for e in got] == [
        (e.term, e.index, e.msg_type) for e in want] == [
        (2, i + 3, p[0]) for i, p in enumerate(pairs[2:])]
    for g, w, (_mt, _ref_payload, port_payload) in zip(got, want, pairs[2:]):
        assert g.payload == port_payload
        assert to_dict(g.payload) == ref_to_dict(w.payload)


# ---------------------------------------------------------------- wire


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encoded_payloads_are_equal_and_decode_to_carried_structs(seed):
    ref_state, port_state, *rest = reference_cluster(seed)
    for mtype, ref_payload, port_payload in payload_pairs(
            ref_state, port_state, *rest):
        got = json.dumps(transport._encode_payload(port_payload),
                         sort_keys=True)
        want = json.dumps(ref_transport._encode_payload(ref_payload),
                          sort_keys=True)
        assert got == want, mtype
        decoded = transport.fsm_payload_decoder(mtype, json.loads(want))
        assert decoded == port_payload, mtype
        for value in decoded.values():
            for item in value if isinstance(value, list) else [value]:
                if not isinstance(item, (str, int, bool, type(None))):
                    assert type(item).__module__.startswith(
                        "nomad_tpu_torch."), (mtype, type(item))


def test_port_node_and_reference_nodes_agree_over_tcp():
    """One port RaftNode and two JAX RaftNodes, each on its package's
    TCPTransport: they elect one leader and every node applies the same
    entries in the same order, each decoding its own package's structs
    from the same frames."""
    mods = [(raft, transport), (ref_raft, ref_transport),
            (ref_raft, ref_transport)]
    transports = [t.TCPTransport(t.fsm_payload_decoder) for _, t in mods]
    addrs = [t.serve("127.0.0.1", 0) for t in transports]
    applied = [[] for _ in mods]
    nodes = []
    for i, ((rmod, _t), tr) in enumerate(zip(mods, transports)):
        node = rmod.RaftNode(
            addrs[i], addrs, tr,
            lambda index, mtype, payload, i=i: applied[i].append(
                (index, mtype, payload)),
            lambda _leader: None)
        tr.register(node)
        nodes.append(node)
    for n in nodes:
        n.start()

    def leader():
        leaders = [n for n in nodes if n.is_leader()]
        return leaders[0] if len(leaders) == 1 else None

    def wait_until(fn, timeout=20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if fn():
                return True
            time.sleep(0.02)
        return False

    ref_state, port_state, *rest = reference_cluster(5)
    pairs = payload_pairs(ref_state, port_state, *rest)
    try:
        assert wait_until(lambda: leader() is not None)
        for k, (mtype, ref_payload, port_payload) in enumerate(pairs):
            # Alternate the writer: the leader, then a follower whose
            # write forwards to it; each writes its own package's structs.
            lead = leader()
            follower = next(n for n in nodes if n is not lead)
            writer = lead if k % 2 == 0 else follower
            payload = port_payload if writer is nodes[0] else ref_payload
            writer.apply(mtype, payload)
        assert wait_until(lambda: all(len(a) == len(pairs) for a in applied))
        order = [[(i, m) for i, m, _ in a] for a in applied]
        assert order[0] == order[1] == order[2]
        assert [m for _, m in order[0]] == [p[0] for p in pairs]
        for (_i, mtype, got), (_j, _m, want) in zip(applied[0], applied[1]):
            assert json.dumps(transport._encode_payload(got), sort_keys=True) \
                == json.dumps(ref_transport._encode_payload(want),
                              sort_keys=True), mtype
    finally:
        for n in nodes:
            n.stop()
        for t in transports:
            t.close()


def test_eval_type_constants_agree():
    """The message types the decoder keys on are the JAX FSM's."""
    from nomad_tpu.server import fsm as ref_fsm
    from nomad_tpu_torch.server import fsm

    for name in ("NODE_REGISTER", "JOB_REGISTER", "EVAL_UPDATE",
                 "ALLOC_UPDATE", "ALLOC_CLIENT_UPDATE",
                 "VAULT_ACCESSOR_REGISTER"):
        assert getattr(fsm, name) == getattr(ref_fsm, name)
    assert consts.EVAL_STATUS_PENDING == "pending"
