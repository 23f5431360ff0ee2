"""Shared fixtures of the tests that hold the PyTorch port
(nomad_tpu_torch) against the JAX package on the same inputs.

The port runs on the CPU here (its plain PyTorch versions); the JAX
package runs on the CPU as tests/conftest.py configures it. Inputs come
from numpy with a seed and cross over as plain data: numpy arrays, and
the JAX store's ``persist()`` dicts loaded with the port's own
``from_dict`` (nomad_tpu_torch/carry.py).
"""

from __future__ import annotations

import numpy as np
import torch

from nomad_tpu import mock
from nomad_tpu.scheduler.testing import Harness
from nomad_tpu.structs import Constraint, consts
from nomad_tpu_torch import carry
from nomad_tpu_torch.device import set_default_device
from nomad_tpu_torch.scheduler.testing import Harness as PortHarness
from nomad_tpu_torch.structs import Evaluation as PortEvaluation
from nomad_tpu_torch.utils.codec import from_dict
from nomad_tpu.utils.codec import to_dict

set_default_device("cpu")
# Small shapes need no intra-op threads, and the suite runs several
# test processes at once: one torch thread each keeps them from
# oversubscribing the cores under timing-sensitive tests elsewhere.
torch.set_num_threads(1)


def build_reference_cluster(n_nodes: int, seed: int, allocs_per_node=2,
                            datacenters=("dc1", "dc2"), harness_seed=0):
    """A JAX-package Harness holding n_nodes mock nodes of varied
    capacity over ``datacenters``, each with filler allocs of a seeded
    footprint: distinct node utilizations, so scores rarely tie."""
    rng = np.random.default_rng(seed)
    h = Harness(seed=harness_seed)
    filler = mock.job()
    filler.id = "filler"
    filler.task_groups[0].tasks[0].resources.networks = []
    h.state.upsert_job(h.next_index(), filler)
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = datacenters[i % len(datacenters)]
        node.resources.cpu = int(rng.choice([4000, 6000, 8000]))
        node.resources.memory_mb = int(rng.choice([8192, 12288, 16384]))
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
        allocs = []
        for _ in range(allocs_per_node):
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = filler.id
            alloc.job = filler
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = int(rng.integers(20, 400))
                tr.memory_mb = int(rng.integers(32, 1024))
                tr.networks = []
            alloc.resources = None
            allocs.append(alloc)
        if allocs:
            h.state.upsert_allocs(h.next_index(), allocs)
    return h


def distinct_hosts_job(count: int, job_id: str = "dh"):
    """Config 4's job shape: one task group with dynamic ports under
    TG-level distinct_hosts."""
    job = mock.job()
    job.id = job_id
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.constraints.append(Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return job


def two_group_job(counts=(12, 10), job_id: str = "two"):
    """Two task groups of different footprints, no distinct_hosts: the
    greedy scan's shape."""
    job = mock.job()
    job.id = job_id
    job.datacenters = ["dc1", "dc2"]
    tg0 = job.task_groups[0]
    tg1 = tg0.copy()
    tg1.name = "api"
    tg1.tasks[0].resources.cpu = 250
    tg1.tasks[0].resources.memory_mb = 384
    tg0.count, tg1.count = counts
    job.task_groups = [tg0, tg1]
    return job


def carry_over(h: Harness) -> PortHarness:
    """The port's Harness over the same state, seed and index clock."""
    hp = PortHarness(state=carry.state_from_reference(h.state.persist()),
                     seed=h.seed)
    hp._next_index = h._next_index
    return hp


def port_eval(ev) -> PortEvaluation:
    return from_dict(PortEvaluation, to_dict(ev))


def plan_view(plan):
    """{alloc name: (node id, {score key: score}, {task: ports})}."""
    out = {}
    for allocs in plan.node_allocation.values():
        for a in allocs:
            ports = {
                t: [(p.label, p.value) for n in (r.networks or [])
                    for p in list(n.reserved_ports) + list(n.dynamic_ports)]
                for t, r in a.task_resources.items()}
            out[a.name] = (a.node_id, dict(a.metrics.scores), ports)
    return out


def failed_view(ev):
    """Failed-TG metrics of an eval update, as comparable plain data."""
    return {name: (m.nodes_evaluated, m.nodes_filtered, m.nodes_exhausted,
                   m.coalesced_failures, dict(m.nodes_available))
            for name, m in (ev.failed_tg_allocs or {}).items()}


def preemptions_view(plan):
    """{node id: [victim alloc ids, in staging order]} of a plan's
    preemption leg (victims are carried-over allocs: same ids in both
    packages)."""
    return {node: [a.id for a in victims]
            for node, victims in plan.node_preemptions.items()}


def gang_view(plan):
    """{gang key: [member alloc names, in staging order]} of a plan's
    gang leg (new allocs get fresh ids in each package, so members are
    named)."""
    names = {a.id: a.name for allocs in plan.node_allocation.values()
             for a in allocs}
    return {key: [names[i] for i in ids]
            for key, ids in plan.gang_groups.items()}
