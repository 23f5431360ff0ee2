"""Status and type constants of the data model.

Reference: nomad/structs/structs.go (status const blocks around
Job/Node/Alloc/Eval definitions at structs.go:629,1068,2854,3219).
"""

# --- Job types (structs.go JobType*) ---
JOB_TYPE_SERVICE = "service"
JOB_TYPE_BATCH = "batch"
JOB_TYPE_SYSTEM = "system"
JOB_TYPE_CORE = "_core"

# --- Job statuses ---
JOB_STATUS_PENDING = "pending"
JOB_STATUS_RUNNING = "running"
JOB_STATUS_DEAD = "dead"

# --- Priorities ---
JOB_MIN_PRIORITY = 1
JOB_DEFAULT_PRIORITY = 50
JOB_MAX_PRIORITY = 100
CORE_JOB_PRIORITY = JOB_MAX_PRIORITY * 2

# --- Node statuses ---
NODE_STATUS_INIT = "initializing"
NODE_STATUS_READY = "ready"
NODE_STATUS_DOWN = "down"

# --- Allocation desired statuses ---
ALLOC_DESIRED_RUN = "run"
ALLOC_DESIRED_STOP = "stop"
ALLOC_DESIRED_EVICT = "evict"

# --- Allocation client statuses ---
ALLOC_CLIENT_PENDING = "pending"
ALLOC_CLIENT_RUNNING = "running"
ALLOC_CLIENT_COMPLETE = "complete"
ALLOC_CLIENT_FAILED = "failed"
ALLOC_CLIENT_LOST = "lost"

# --- Evaluation statuses ---
EVAL_STATUS_BLOCKED = "blocked"
EVAL_STATUS_PENDING = "pending"
EVAL_STATUS_COMPLETE = "complete"
EVAL_STATUS_FAILED = "failed"
EVAL_STATUS_CANCELLED = "canceled"

# --- Evaluation trigger reasons (structs.go:3183-3190) ---
EVAL_TRIGGER_JOB_REGISTER = "job-register"
EVAL_TRIGGER_JOB_DEREGISTER = "job-deregister"
EVAL_TRIGGER_PERIODIC_JOB = "periodic-job"
EVAL_TRIGGER_NODE_UPDATE = "node-update"
EVAL_TRIGGER_SCHEDULED = "scheduled"
EVAL_TRIGGER_ROLLING_UPDATE = "rolling-update"
EVAL_TRIGGER_MAX_PLANS = "max-plan-attempts"
# Broker delivery-limit exhaustion: the eval was dead-lettered to the
# failed queue with a structured reason (server/broker.py nack()).
EVAL_TRIGGER_DEAD_LETTER = "delivery-limit-exhausted"
# Overload protection (nomad_tpu/admission): the eval was shed from a
# full bounded ready queue (priority-aware, lowest-priority newest-first;
# server/broker.py _shed_locked) ...
EVAL_TRIGGER_SHED = "shed-overload"
# ... or its creation-stamped deadline passed before it could be
# dispatched (broker dequeue skip / dispatch-pipeline launch drop).
EVAL_TRIGGER_EXPIRED = "deadline-expired"
# Churn workflows (nomad_tpu/migrate): a drain storm's displaced allocs
# that exceeded the in-flight migration budget ride a follow-up eval
# with this trigger (the budget analog of rolling-update follow-ups) ...
EVAL_TRIGGER_MIGRATION = "migration-budget"
# ... and a job whose alloc was evicted by a higher-priority eval's
# preemption pass gets a replacement eval with this trigger (it
# typically blocks until capacity returns — the cluster was red).
EVAL_TRIGGER_PREEMPTION = "preemption"
# Continuous defragmentation (nomad_tpu/defrag): the leader-side
# optimizer's bounded migration waves ride evals with this trigger,
# carrying the alloc ids to move (Evaluation.defrag_alloc_ids) and the
# solver's target nodes (Evaluation.defrag_targets) — the scheduler
# treats the marked allocs as budget-exempt migrations (the loop holds
# the governor slots) and prefers the solver's target for each
# replacement placement.
EVAL_TRIGGER_DEFRAG = "defrag-migration"

# --- Task states (structs.go:2317) ---
TASK_STATE_PENDING = "pending"
TASK_STATE_RUNNING = "running"
TASK_STATE_DEAD = "dead"

# --- Task events (structs.go:2434) ---
TASK_EVENT_STARTED = "Started"
TASK_EVENT_TERMINATED = "Terminated"
TASK_EVENT_FAILED_VALIDATION = "Failed Validation"
TASK_EVENT_DRIVER_FAILURE = "Driver Failure"
TASK_EVENT_RECEIVED = "Received"
TASK_EVENT_RESTARTING = "Restarting"
TASK_EVENT_NOT_RESTARTING = "Not Restarting"
TASK_EVENT_KILLING = "Killing"
TASK_EVENT_KILLED = "Killed"
TASK_EVENT_DOWNLOADING_ARTIFACTS = "Downloading Artifacts"
TASK_EVENT_ARTIFACT_DOWNLOAD_FAILED = "Failed Artifact Download"
TASK_EVENT_SIGNALING = "Signaling"
TASK_EVENT_RESTART_SIGNAL = "Restart Signaled"
TASK_EVENT_DISK_EXCEEDED = "Disk Resources Exceeded"

# --- Constraint operands (structs.go:2713-2715, feasible.go:337-371) ---
CONSTRAINT_DISTINCT_HOSTS = "distinct_hosts"
CONSTRAINT_REGEX = "regexp"
CONSTRAINT_VERSION = "version"

# --- Restart policy modes (structs.go RestartPolicy) ---
RESTART_POLICY_MODE_DELAY = "delay"
RESTART_POLICY_MODE_FAIL = "fail"

# --- Dynamic port range (structs/network.go:11-19) ---
MIN_DYNAMIC_PORT = 20000
MAX_DYNAMIC_PORT = 60000
MAX_VALID_PORT = 65536
MAX_RAND_PORT_ATTEMPTS = 20

# --- Core (GC) job ids (core_sched.go) ---
CORE_JOB_EVAL_GC = "eval-gc"
CORE_JOB_NODE_GC = "node-gc"
CORE_JOB_JOB_GC = "job-gc"
CORE_JOB_FORCE_GC = "force-gc"

# Node unique-attribute namespace excluded from computed class
# (structs/node_class.go:13).
NODE_UNIQUE_NAMESPACE = "unique."
