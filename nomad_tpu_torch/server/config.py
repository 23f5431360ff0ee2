"""Server configuration: the port of the JAX package's
server/config.py, with its fields and defaults for every part the port
carries.

Reference: nomad/config.go (defaults at :225-238) and
command/agent/agent.go:129 (num_schedulers overlay).

Left out until their parts are ported, so that no option is accepted
and then ignored: the multi-server ones (``node_name``,
``bootstrap_expect``), the executive's thread count, the defrag loop's
tuning, the read plane (``read_mux_*``, ``read_scoped_index``), and the
device-path breaker (``breaker_*``: the port has none, a device fault
fails the eval and the broker redelivers it). The pipeline-off
``dispatch_pipeline=False`` arm is not carried either: dense evals
always go through the dispatch pipeline when ``eval_batch_size > 1``.
``scheduler_executive=True`` and ``defrag_enabled=True`` make Server()
raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ServerConfig:
    region: str = "global"
    datacenter: str = "dc1"

    # Scheduling workers (reference default 1; the agent sets NumCPU).
    num_schedulers: int = 1
    # Which scheduler types this server's workers service.
    enabled_schedulers: List[str] = field(
        default_factory=lambda: ["service", "batch", "system", "_core"]
    )
    # Per-type factory overrides, e.g. {"service": "service-gpu"} routes
    # service evals to the dense placement backend on the card (new
    # factories, unchanged control plane).
    scheduler_factories: Dict[str, str] = field(default_factory=dict)

    # Eval broker (config.go:233-234)
    eval_nack_timeout: float = 60.0
    eval_delivery_limit: int = 3

    # Max evals the dispatch pipeline packs into one batched device
    # dispatch when the eval's factory is a dense one (extension over
    # the reference's single dequeue, eval_broker.go:259). 1 disables
    # the pipeline: each worker then runs its eval alone.
    # Default = the batcher's MAX_BATCH: per-dispatch cost dominates,
    # so fewer, fuller dispatches win. Lone/interactive evals never see this (the
    # dense_min_batch router sends them to the host pipeline).
    eval_batch_size: int = 64

    # Latency-aware routing: a dense factory only pays off when the
    # device dispatch amortizes over a batch; a lone interactive eval
    # would eat the full batch-window + dispatch latency for nothing.
    # Drained groups smaller than this run on the host (CPU iterator)
    # factory instead — same placement semantics (host/dense parity is
    # a test invariant), millisecond latency. 1 forces dense always.
    dense_min_batch: int = 2

    # Central dispatch pipeline (nomad_tpu_torch/dispatch): dense-path evals
    # from EVERY worker flow into one leader-side accumulator that
    # packs full device batches, launches them pipelined (next batch
    # accumulates during the in-flight device sync + plan submits),
    # and requeues plan-conflict retries into the ACCUMULATING batch.
    # Batches allowed in flight at once: overlap hides the device
    # round-trip + plan-submit tail behind the next accumulation.
    dispatch_max_inflight: int = 2
    # Accumulation window while another batch is in flight (its
    # round-trip is the budget being amortized); the idle grace is all
    # a batch waits when nothing is in flight — a lone interactive
    # eval pays only this before routing to the host path.
    dispatch_window: float = 0.05
    dispatch_idle_grace: float = 0.004
    # Conflict-rejected evals rejoin the accumulating batch at most
    # this many times before falling back to the scheduler's own
    # inline retry loop (bounded like MAX_SERVICE_SCHEDULE_ATTEMPTS).
    dispatch_max_requeues: int = 3

    # ---- Scheduler executive (not ported yet: True raises) ----
    # Replace the thread-per-eval dense worker model with a batched
    # event-loop executive: one drain-owner thread pulls whole cohorts
    # from the broker, reconciles them as arrays host-side
    # (scheduler/util.py cohort_reconcile), hands complete batches
    # straight to the device via the batcher's no-park cohort dispatch
    # (place_cohort), and fans results back out through per-eval
    # plan-submit + ack — an evaluation's identity is a batch row, not
    # a parked thread. False (the default) keeps the dispatch-pipeline
    # + worker fan-out path, the only one the port has.
    scheduler_executive: bool = False

    # In-batch conflict pre-resolution: serialize the eval axis of a
    # shared-base device dispatch so batch members see each other's
    # capacity claims (ops/binpack.py PlacementConfig.pre_resolve) —
    # cuts plan-applier rejections, each of which costs a replan +
    # dispatch round-trip. False = independent evals.
    dense_pre_resolve: bool = True

    # ---- Placement kernel (nomad_tpu_torch/kernels) ----
    # Which dense placement kernel the *-gpu factories run: "greedy"
    # (the sequential masked-argmax reference reformulation) or
    # "convex" (the convex-relaxation bin-packer), plus any kernel a
    # plugin registered. Validated at server init — a typo fails
    # before the first eval, not inside it. None = leave the
    # process-global active kernel alone (it starts as "greedy"); an
    # EXPLICIT value — including "greedy" — sets it. Per-scheduler-
    # type pins are also available through scheduler_factories (e.g.
    # {"service": "service-convex-gpu"}).
    placement_kernel: Optional[str] = None

    # ---- Device-resident node state (models/resident.py) ----
    # The dense path's [N, R] node matrix lives on device; plan commits
    # and node up/down/drain transitions apply as small scatter deltas
    # keyed on log index instead of re-shipping the full matrix per
    # batch. False reverts to per-snapshot rebuild + re-upload (the
    # bench A/B arm).
    device_resident: bool = True
    # Max delta-refilled rows before a full rebuild is the better deal;
    # 0 = auto (max(64, N/4)).
    resident_rebuild_rows: int = 0

    # ---- Churn control (nomad_tpu_torch/migrate) ----
    # In-flight migration budget: how many drain-displaced allocs may
    # be claimed by scheduling attempts at once, cluster-wide (the
    # reference's drain max_parallel analog). Displaced allocs past
    # the budget ride follow-up migration evals — a 100-node drain
    # storm re-places in bounded waves instead of thundering-herding
    # the plan queue. 0 = unbounded.
    migrate_max_parallel: int = 32
    # Priority preemption (ops/preempt.py): allow a red-pressure,
    # above-threshold-priority eval whose placements found no room to
    # evict lowest-priority allocs in the same dense pass. Off by
    # default: with it off, a red cluster sheds exactly per the
    # admission policy (nomad_tpu_torch/admission).
    preemption_enabled: bool = False
    # Evals must STRICTLY outrank this to preempt (50 = the default
    # job priority, so only above-normal work may evict).
    preempt_priority_threshold: int = 50

    # ---- Continuous defragmentation (the loop is not ported yet:
    # defrag_enabled=True raises) ----
    # Leader-side background optimizer: periodically solves the relaxed
    # GLOBAL re-placement (the convex kernel's mirror-descent program,
    # warm-started across rounds) over the device-resident node state
    # and proposes bounded migration waves through the migration budget
    # + verified eviction legs. Off by default — it moves healthy
    # allocs, which is an operator's call to enable.
    defrag_enabled: bool = False

    # ---- Overload protection (nomad_tpu_torch/admission) ----
    # Bounded broker ready queues: default per-scheduler-type depth cap
    # (0 = unbounded) plus per-type overrides. A full queue sheds the
    # lowest-priority newest eval with a structured outcome.
    eval_ready_cap: int = 0
    eval_ready_caps: Dict[str, int] = field(default_factory=dict)
    # Eval deadline base TTL in seconds (0 = no deadlines). The
    # effective TTL scales with priority (admission/deadline.py):
    # default-priority evals get exactly this, priority 100 gets 1.5x.
    eval_deadline_ttl: float = 0.0
    # Token-bucket admission control on the HTTP/RPC intake. Buckets
    # only engage past green pressure, so the defaults are inert on an
    # unloaded server; leader-forward + raft + client control traffic
    # and the observability routes are always exempt.
    admission_enabled: bool = True
    admission_write_rate: float = 50.0
    admission_write_burst: float = 100.0
    admission_read_rate: float = 200.0
    admission_read_burst: float = 400.0
    # Retry-After hint (seconds) on red-pressure 503 sheds.
    admission_red_retry_after: float = 1.0
    # Absolute broker-depth thresholds (ready+unacked) used when ready
    # queues are UNcapped; capped queues use fractions of the cap.
    admission_depth_yellow: int = 256
    admission_depth_red: int = 1024
    # Rolling e2e p99 thresholds in ms (0 disables the latency input —
    # absolute latency bars are deployment-specific).
    admission_p99_yellow_ms: float = 0.0
    admission_p99_red_ms: float = 0.0

    # ---- Contention observatory (nomad_tpu_torch/profile) ----
    # Always-on lock/GIL/pipeline profiler, like the flight recorder:
    # ProfiledLock wait/hold histograms on the hot locks, the
    # GIL-pressure sampler thread, and the batch-boundary convoy
    # detector. False disables recording (the bench --profile-off arm)
    # and stops the sampler; the lock wrappers stay in place either
    # way.
    profile_enabled: bool = True
    # GIL sampler sleep-request interval in seconds (~200 wakes/s at
    # the default; the overshoot distribution is the measurement).
    # Values <= 0 are ignored (a zero interval would spin); to stop
    # the sampler, disable the observatory via profile_enabled.
    gil_sampler_interval: float = 0.005
    # Pressure-monitor thresholds on the WORST per-site contended
    # lock-wait p99 in ms (0 disables the input — like the e2e p99
    # thresholds, absolute bars are deployment-specific). When set,
    # yellow/red pressure reasons cite the hottest lock site.
    admission_lock_wait_yellow_ms: float = 0.0
    admission_lock_wait_red_ms: float = 0.0

    # Telemetry gauge emission period (command.go:570 setupTelemetry)
    telemetry_interval: float = 10.0
    statsd_addr: str = ""

    # Heartbeats (config.go:235-238)
    min_heartbeat_ttl: float = 10.0
    max_heartbeats_per_second: float = 50.0
    heartbeat_grace: float = 10.0

    # GC (config.go:227-232)
    eval_gc_interval: float = 300.0
    eval_gc_threshold: float = 3600.0
    job_gc_interval: float = 300.0
    job_gc_threshold: float = 4 * 3600.0
    node_gc_interval: float = 300.0
    node_gc_threshold: float = 24 * 3600.0

    # Plan verification pool size (plan_apply.go:48: NumCPU/2).
    plan_verify_workers: int = 2

    # Blocked-evals failed-eval unblock cadence (leader.go:441).
    failed_eval_unblock_interval: float = 60.0

    # Vault token authority (nomad/vault.go). With vault_addr set the
    # server talks to a real Vault over HTTP using vault_token as its
    # own token (renewed at half-life); otherwise an in-process stub
    # keeps the derive→renew→revoke lifecycle working vault-less.
    vault_enabled: bool = True
    vault_addr: str = ""
    vault_token: str = ""
    vault_token_ttl: float = 3600.0
    # None = any policy except root; else an allowlist.
    vault_allowed_policies: Optional[List[str]] = None

    def factory_for(self, eval_type: str) -> str:
        return self.scheduler_factories.get(eval_type, eval_type)
