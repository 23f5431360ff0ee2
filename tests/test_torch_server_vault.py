"""The JAX package's tests/test_vault.py on the port (its client-side
cases wait for the port's client agent).

Vault integration tests: token derivation, renewal, revocation.

Reference behaviors: nomad/vault.go (token lifecycle + accessor
tracking), Node.DeriveVaultToken (node_endpoint.go:940), vault policy
checks at job submit (job_endpoint.go:84-120), accessor GC with
reaped allocs, and the client-side renewal manager
(client/vaultclient/vaultclient.go).
"""

import torch_parity  # noqa: F401  (the port on the CPU)
import os
import time

import pytest

from nomad_tpu_torch import mock
from nomad_tpu_torch.server import Server, ServerConfig
from nomad_tpu_torch.server.vault import StubVault, VaultError
from nomad_tpu_torch.structs import Vault, consts


def wait_until(fn, timeout=8.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(interval)
    return False


class TestStubVault:
    def test_create_and_lookup(self):
        v = StubVault()
        token, accessor, ttl = v.create_token(["web-read"])
        assert token.startswith("s.") and accessor and ttl > 0
        assert v.lookup(token) == ["web-read"]

    def test_root_policy_rejected(self):
        with pytest.raises(VaultError, match="root"):
            StubVault().create_token(["root"])

    def test_allowed_policies_enforced(self):
        v = StubVault(allowed_policies=["a"])
        v.create_token(["a"])
        with pytest.raises(VaultError, match="not allowed"):
            v.create_token(["b"])

    def test_revoke_kills_token(self):
        v = StubVault()
        token, accessor, _ = v.create_token(["p"])
        v.revoke_tokens([accessor])
        assert v.lookup(token) is None
        with pytest.raises(VaultError):
            v.renew_token(token)

    def test_expiry_and_renewal(self):
        v = StubVault(ttl=0.1)
        token, _, _ = v.create_token(["p"])
        v.renew_token(token)
        time.sleep(0.15)
        assert v.lookup(token) is None
        with pytest.raises(VaultError, match="expired"):
            v.renew_token(token)


@pytest.fixture
def server():
    srv = Server(ServerConfig(num_schedulers=0))
    srv.start()
    yield srv
    srv.shutdown()


def seed_vault_alloc(srv, policies=("web-read",)):
    """Node + job with a vault task + one alloc placed on the node."""
    node = mock.node()
    node.secret_id = "node-secret"
    srv.node_register(node)
    job = mock.job()
    task = job.task_groups[0].tasks[0]
    task.vault = Vault(policies=list(policies))
    alloc = mock.alloc()
    alloc.node_id = node.id
    alloc.job = job
    alloc.job_id = job.id
    alloc.task_group = job.task_groups[0].name
    from nomad_tpu_torch.server import fsm as fsm_msgs

    srv.log.apply(fsm_msgs.ALLOC_UPDATE, {"allocs": [alloc], "job": job})
    return node, job, alloc


class TestDeriveVaultToken:
    def test_derive_happy_path(self, server):
        node, job, alloc = seed_vault_alloc(server)
        tokens, ttl = server.derive_vault_token(
            node.id, "node-secret", alloc.id, [job.task_groups[0].tasks[0].name]
        )
        assert ttl > 0
        task_name = job.task_groups[0].tasks[0].name
        assert server.vault.lookup(tokens[task_name]) == ["web-read"]
        # Accessor is tracked in state (vault_accessors table).
        accs = server.fsm.state.vault_accessors_by_alloc(alloc.id)
        assert len(accs) == 1
        assert accs[0].task == task_name
        assert accs[0].node_id == node.id

    def test_wrong_node_secret_rejected(self, server):
        node, job, alloc = seed_vault_alloc(server)
        with pytest.raises(PermissionError):
            server.derive_vault_token(
                node.id, "bogus", alloc.id, [job.task_groups[0].tasks[0].name]
            )

    def test_empty_secret_rejected(self, server):
        """An empty caller secret must NOT bypass node authentication."""
        node, job, alloc = seed_vault_alloc(server)
        with pytest.raises(PermissionError):
            server.derive_vault_token(
                node.id, "", alloc.id, [job.task_groups[0].tasks[0].name]
            )

    def test_partial_mint_failure_revokes_minted_tokens(self, server):
        """If a later task's mint fails, earlier tokens from the same
        request are revoked, not leaked untracked."""
        node, job, alloc = seed_vault_alloc(server)
        task_name = job.task_groups[0].tasks[0].name
        with pytest.raises(ValueError):
            server.derive_vault_token(
                node.id, "node-secret", alloc.id, [task_name, "missing-task"]
            )
        # Nothing tracked, and the authority holds no live tokens.
        assert server.fsm.state.vault_accessors_by_alloc(alloc.id) == []
        assert server.vault._by_token == {}

    def test_alloc_not_on_node_rejected(self, server):
        node, job, alloc = seed_vault_alloc(server)
        other = mock.node()
        server.node_register(other)
        with pytest.raises(PermissionError):
            server.derive_vault_token(
                other.id, other.secret_id, alloc.id,
                [job.task_groups[0].tasks[0].name],
            )

    def test_task_without_vault_block_rejected(self, server):
        node, job, alloc = seed_vault_alloc(server)
        with pytest.raises(ValueError, match="vault block"):
            server.derive_vault_token(
                node.id, "node-secret", alloc.id, ["no-such-task"]
            )

    def test_reap_revokes_accessors(self, server):
        node, job, alloc = seed_vault_alloc(server)
        task_name = job.task_groups[0].tasks[0].name
        tokens, _ = server.derive_vault_token(
            node.id, "node-secret", alloc.id, [task_name]
        )
        server.eval_reap([], [alloc.id])
        assert server.vault.lookup(tokens[task_name]) is None
        assert server.fsm.state.vault_accessors_by_alloc(alloc.id) == []

    def test_job_register_rejects_root_policy(self, server):
        job = mock.job()
        job.task_groups[0].tasks[0].vault = Vault(policies=["root"])
        with pytest.raises(ValueError, match="root"):
            server.job_register(job)

    def test_job_register_rejects_disallowed_policy(self):
        srv = Server(ServerConfig(num_schedulers=0,
                                  vault_allowed_policies=["ok"]))
        srv.start()
        try:
            job = mock.job()
            job.task_groups[0].tasks[0].vault = Vault(policies=["nope"])
            with pytest.raises(ValueError, match="not allowed"):
                srv.job_register(job)
        finally:
            srv.shutdown()

    def test_job_register_rejects_empty_policies(self, server):
        job = mock.job()
        job.task_groups[0].tasks[0].vault = Vault(policies=[])
        with pytest.raises(ValueError, match="needs policies"):
            server.job_register(job)


