"""The control plane's server side: the eval broker, blocked evals,
plan queue and applier, FSM over the dev log or the raft log, workers,
heartbeats, periodic dispatch, core GC, vault, the scheduler executive,
the multi-server layer (raft and its storage, the TCP transport, serf
gossip, leader forwarding) and the Server that composes them (the port
of the JAX package's server package)."""

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
