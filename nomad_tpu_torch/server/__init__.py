"""Server-side pieces of the port. Only the plan applier's pure
per-node checks are ported so far (plan_apply.py); the applier loop,
raft and the server wait for their own slice."""
