"""The control plane's server side, in dev mode: the eval broker,
blocked evals, plan queue and applier, FSM over the dev log, workers,
heartbeats, periodic dispatch, core GC, vault, the scheduler executive
and the Server that composes them (the port of the JAX package's
server package; raft, serf and leader forwarding are not ported
yet)."""

from .broker import EvalBroker
from .blocked import BlockedEvals
from .config import ServerConfig
from .fsm import FSM, DevLog
from .plan_apply import PlanApplier, evaluate_node_plan
from .plan_queue import PlanQueue
from .server import Server
from .timetable import TimeTable
from .worker import Worker

__all__ = [
    "EvalBroker",
    "BlockedEvals",
    "ServerConfig",
    "FSM",
    "DevLog",
    "PlanApplier",
    "evaluate_node_plan",
    "PlanQueue",
    "Server",
    "TimeTable",
    "Worker",
]
