"""The plan applier's per-node verification: the port of the JAX
package's server/plan_apply.py evaluate_node_preemptions and
evaluate_node_plan (reference: nomad/plan_apply.go:318
evaluateNodePlan). The differential rig (kernels/differential.py) judges
every dense plan with exactly these checks; the applier loop
(PlanApplier) is not ported yet.
"""

from __future__ import annotations

from ..structs import Plan, allocs_fit, consts


def evaluate_node_preemptions(snapshot, plan: Plan, node_id: str) -> bool:
    """Per-victim verification of a preemption leg: every victim must
    still exist, be non-terminal, and be STRICTLY lower-priority than
    the plan; otherwise the node's freed-capacity discount is void and
    the whole node is rejected."""
    victims = plan.node_preemptions.get(node_id)
    if not victims:
        return True
    from ..migrate import victim_priority

    live = {a.id: a
            for a in snapshot.allocs_by_node_terminal(node_id, False)}
    for victim in victims:
        stored = live.get(victim.id)
        if stored is None or stored.terminal_status():
            return False
        if victim_priority(stored) >= plan.priority:
            return False
    return True


def evaluate_node_plan(snapshot, plan: Plan, node_id: str) -> bool:
    """Whether the plan's changes to one node can be applied against the
    given state (plan_apply.go:318 evaluateNodePlan)."""
    if not evaluate_node_preemptions(snapshot, plan, node_id):
        return False
    if not plan.node_allocation.get(node_id):
        return True  # evictions only: always safe

    node = snapshot.node_by_id(node_id)
    if node is None:
        return False
    if node.status != consts.NODE_STATUS_READY or node.drain:
        return False

    from ..scheduler.util import proposed_allocs_for_node

    proposed = proposed_allocs_for_node(snapshot, plan, node_id)
    fit, _, _ = allocs_fit(node, proposed)
    return fit
