"""Overload protection for the control plane: the port of the JAX
package's admission package, without its device-path circuit breaker.
The port has no breaker: a device fault is never routed to the host, it
fails the eval, which the broker redelivers.

Three cooperating pieces:

- :mod:`pressure` — one green/yellow/red overload level computed from
  broker depth, dispatch saturation, and the flight recorder's rolling
  e2e p99;
- :mod:`limiter` — token-bucket admission control on the HTTP/RPC
  intake, thresholds driven by the pressure level;
- :mod:`deadline` — priority-scaled eval deadlines, enforced at broker
  dequeue and dispatch-pipeline launch.

The bounded-queue shed policy itself lives in the broker
(server/broker.py): shedding must happen under the broker lock, where
the queues are.
"""

from .deadline import deadline_for, priority_factor, stamp  # noqa: F401
from .limiter import (  # noqa: F401
    ROUTE_EXEMPT,
    ROUTE_READ,
    ROUTE_WRITE,
    RPC_EXEMPT_KINDS,
    AdmissionController,
    AdmissionRejected,
    TokenBucket,
    classify_http,
)
from .pressure import (  # noqa: F401
    LEVEL_GREEN,
    LEVEL_NUM,
    LEVEL_RED,
    LEVEL_YELLOW,
    PressureMonitor,
)
