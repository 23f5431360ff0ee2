"""Central dispatch pipeline: a leader-side placement service that
fills the device lanes.

The per-worker drain-then-place loop (server/worker.py) caps dispatch
occupancy at whatever one worker happens to find ready at its own
dequeue moment, and pays a full device round-trip per plan-conflict
retry. This package centralizes the dense path the way continuous-
batching inference servers centralize request admission: one drain,
full batches, pipelined submits, conflict retries folded back into the
accumulating batch. See pipeline.py for the stage breakdown.
"""

from .pipeline import DispatchPipeline, PipelineSession

__all__ = ["DispatchPipeline", "PipelineSession"]
