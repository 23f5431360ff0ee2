#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nomad_tpu_torch) on one NVIDIA
card: the port's main path end to end, and every kernel of that path
held against its plain PyTorch version.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero and prints no result):

1. Card identity (``nvidia-smi`` name and power limit) and the kernels'
   build from the sources in nomad_tpu_torch/csrc.
2. The cluster of the north-star shape: 10,000 nodes over dc1/dc2 (node
   bucket 10,240), 5 filler allocs per node (50,000 allocs), built with
   the port's own mock from ``--seed``.
3. Evals through ``Harness.process("service-gpu", eval)``, the port's
   scheduler entry point: (a) the north-star job (dynamic ports,
   distinct_hosts, count 8); (b) a two-task-group job with 512 + 512
   asks; (c) job (b) scaled up after (a) and (b) commit. Each is
   checked against the port's host "service" scheduler on the same
   state (placed counts equal), every dense placement against the
   host's feasibility and AllocsFit checks, and the launch count of
   every kernel of the path against zero.
4. The eval storm, the JAX package's bench config 4 driven the way
   its executive arm drives it (bench.py bench_tpu_e2e), on a fresh
   cluster of the same shape: 4 rounds x 64 evals of config 4's job
   (one job per eval) through ``PlacementBatcher.place_cohort`` with
   pre_resolve on (the server default): rows built on a 4-thread pool
   (ClusterMatrix + asks), one cohort dispatch, finalize (port offers,
   Allocation objects) on a 4-thread pool, and the round's plans
   committed, so each later round's base is a delta of the last (K4,
   fused into the dispatch; each delta held bit-equal to the plain
   version, its parent unchanged and its four arrays one allocation).
   Prints evals/s, per-eval p50/p99, the batcher's dispatches,
   occupancy and stack/issue/sync times; checks
   with bench.py's applier-style replay that no eval conflicts, holds
   one round against the same cohort through a CPU batcher (the plain
   versions), and counts conflicts of one round with pre_resolve off.
   Then a greedy storm (16 evals of a 512 + 512 two-group job, K1 in
   sequential mode; with the share of its scan steps whose ask has the
   last step's resources, bandwidth and ports), a greedy round of 64
   such evals with pre_resolve off (one stacked dispatch over one base,
   the scan drawing its own noise), a parked storm (64 threads calling
   ``place()`` after ``add_cohort(64)``), and token-less cohorts that
   take the stacked-state path (K1 and K2 with a base per eval), each
   checked.
5. Preemption on a red cluster of the same size: four filler jobs at
   priorities 10-40 hold five allocs on each node (footprints from
   ``--seed``), leaving room for the high job's ask on 256 nodes only.
   A priority-70 job (config 4's task, distinct_hosts, count 1,024)
   runs through ``service-gpu`` with preemption on and a red pressure
   probe: all 1,024 placed, 256 by the main pass and 768 through K6;
   each victim staged once, below priority 70, and on every node the
   lowest-priority-first prefix the host oracle
   (``migrate.select_victims_host``) picks; the plan commits and the
   preempted filler jobs get follow-up evals. The same eval with
   preemption off leaves 768 unplaced. K6 is held against its plain
   version on the scheduler's own inputs, and ``build_victims``' host
   time is printed.
6. Gangs on the same size with node meta ``rack`` (250 racks of 40,
   g_pad 256) and ``ici`` (625 groups of 16, g_pad 1,024), through
   ``service-gpu``: a rack slice and an ici slice at K = 64, a rack
   spread at K = 512, ici affinity at K = 128, a free gang under
   distinct_hosts at K = 1,024, and a rack slice under distinct_hosts
   at K = 64 (larger than any rack); then, on a cluster of the same
   size without topology meta (every node its own group, g_pad
   10,240), a free gang and a rack spread at K = 512 and rack affinity
   at K = 128. Each gang is all K or none; a slice lies in the
   tightest covering group; the spread cap holds; distinct_hosts
   holds; the plan's gang leg lists every member; the rejected gang
   records one failure with K-1 coalesced. K7 is held against its
   plain version on each gang's own call (every output and the final
   carry).
7. Each kernel against its plain PyTorch version on the card at the
   main path's widths, with free ports and distinct_hosts that limit
   placement: noise bits equal; greedy and top-k choices and all five
   carried tensors equal, scores within 1e-4; overlay outputs and base
   deltas equal. K0-K3 at N = 10,240, K = 1,024, G = 2, B in {1, 64};
   the sequential scans at B = 4 x K = 1,024 and B = 64 x K = 64 (K1)
   and B = 64 x K = 8 (K2); the stacked scans at B = 4; K4 at R = 256
   and 4,096 (with its launches and allocations a call, its host span
   and device time); K6 on phase 5's own call (K = 1,024) and its
   first 8 asks (choices, victim counts, the carry and the victim mask
   equal), with its plan (CTAs, threads, resident or streamed), the
   launches of one call held to one, both chain terms (the bound takes
   the smaller), its host span and device time, and ``uncached_ms``
   (the call with the score cache off, held too);
   K7 on phase 6's own calls: the free gang (K = 1,024, g_pad = 256),
   the ici slice (K = 64, g_pad = 1,024) and the spread without meta
   (K = 512, g_pad = 10,240); K8a and K8b on phase 8's own calls (the
   512 + 512 eval, B = 1 x K = 1,024: the batcher pads no registered
   kernel's batch, and all 64 evals of the convex storm, K = 8 under
   seq; K8a's full launch gives the path's pref bit for bit; K8b fed
   the plain relaxation's pref: choices and carry equal) and K9 on the
   four defrag solves (K = 512 x N = 10,240 cold and warm, and over
   node classes). K8a and K9 outputs are held to RELAX_TOLS: logits
   within 1e-4 relative to max(1, |logit|), x within 1e-3 of its row's
   largest entry, pref within 1e-3; or, where float32 rounding moves
   the plain version itself (the relaxation can be chaotic), within
   10x the plain version's own distance from its float64 run, a bound
   that must stay under 0.1.
   With median CUDA-event times, the plain version's time (fewer runs
   for the slow plain scans: the count is in each record), a library
   call's time where one PyTorch call computes the same function, and
   the least time the card could take: the larger of this run's bytes
   over the HBM rate and its operations over the peak rate, and for
   the scans also the measured time of their chain of block-wide
   argmax rounds alone. The greedy scan's records (K1 at B = 1 and 64,
   K5a-greedy at 4 x 1,024 and 64 x 64, K5b-greedy) also give the
   cluster the plan took (CTAs, threads, resident or streamed, waves),
   the launches of one call (counted around it, held to one), both
   chain terms (the one-block argmax, nt_argmax_chain, and the
   cluster's exchange at the plan's shape, nt_argmax_chain_cluster),
   the share of the record's steps whose ask has the last step's
   resources, bandwidth and ports (the steps the kernel's score cache
   serves: all of them in these records), and the same call on asks
   that differ at every step (``varied_ms``: none served), held
   against the plain version too. K7's and K8b's records (both on the
   greedy scan's cluster: csrc/gang_scan.cu and the greedy scan's
   rounding-bias case) give the same: their plan (CTAs, threads,
   resident or streamed; K7 also where its group counts live), the
   launches of one call held to one, both chain terms (the bound takes
   the smaller), the call's host span and profiler device time, and the
   call on asks that differ at every step (K8b's ``varied_ms``; a gang's
   members are one ask, so K7's record gives ``uncached_ms``, the call
   with the score cache off), held against the plain version. On phase
   9's calls: K10a-K10d, then K10e (the
   gang programs: outputs and every shard's carry), K10f (the defrag
   solves) and K10g-a (the 512 + 512 eval and all 64 storm evals) to
   RELAX_TOLS as K8a and K9, and K10g-b (choices and carry equal its
   plain version's, and K8b's on the whole node axis fed the same
   pref). K10c, K10e and K10g-b are held and timed on both routes: the
   one-card route (one launch of K1's or K7's cluster kernel over the
   shards' segments, held to one launch a call; with its plan, its
   profiler device time and its host span) and the per-shard route on
   the same shards (``force_shards``; K x (W + 1) + W launches an
   eval, its own ``..._shards`` record). K8a, K9, K10f and K10g-a (one
   persistent launch a card, csrc/relax.cuh) also give their launches
   a call, counted around one call and held to one, the host span of a
   call beside its device time, and their calls by shape over phases 3
   to 9 (ShapeCalls); the K8a record also the cost of one grid
   barrier.

8. The convex kernel and the defrag solve (they run before phase 7's
   holds, which use their recorded calls): (a) config 4's job and the
   512 + 512 job through ``service-convex-gpu`` on phase 3's cluster,
   each placed as the host oracle places it and checked as phase 3's,
   with a greedy arm (``service-greedy-gpu``, nothing committed) on the
   same state; (e) the quality board's fragmentation and bin-pack
   medians of both arms; (b) a convex storm: 64 evals of config 4's job
   through ``place_cohort`` with pre_resolve on phase 4's cluster (K8
   eval by eval on one stream), 0 conflicts, all placed; (c) the oracle
   differential rig on the card: convex, greedy, gangs, defrag waves;
   (d) ``compute_defrag_plan`` at full width on a fragmented layout of
   10,000 nodes (phase 3's cluster has nothing to move): cold and warm
   at K = 512 x N = 10,240, then over node classes; fragmentation never
   rises; the moves become wave evals through ``service-gpu`` and every
   plan passes ``judge_migration_plan``.
9. The node-sharded mesh path on 4 shards (slices of cuda:0 on one
   card, the cards round-robin on two or more): after a warm-up round,
   2 rounds x 64 evals of config 4's job through a mesh batcher's
   ``place_cohort`` with pre_resolve on phase 4's cluster (K0 and K3 a
   shard, K10d; round 2's base a K10a delta child of round 1's), plans,
   choices and scores identical to the unsharded batcher's on the same
   rows; the 512 + 512 eval through K10c (B = 1: a sharded base runs
   the live rows only; one launch of K1's cluster kernel over the
   shards' segments), equal to K1's; K10b over one-node groups
   (g_pad 10,240) and racks of 40 (g_pad 256), equal to the one-device
   node-order sum; K10a's and K10b's launches counted around their
   calls, one a call on a card (K10b's combine adds one where the
   shards span cards). Then the last three node-sharded programs on the
   same mesh: config 4's job and the 512 + 512 job through
   ``service-convex-gpu`` on a mesh batcher on phase 3's cluster (K0 and
   K3 a shard, K10g-a's relaxation with its cross-shard softmax and
   maxima, K10g-b's rounding over the shards), each placed as the host
   oracle places it and checked as phase 8's, its pref within 5e-3 of
   the unsharded convex eval's on the same state and key (or, where
   float32 drifts, held by the float64 run) and the number of
   placements that differ from that eval's printed; a 64-eval convex
   storm through the mesh batcher's ``place_cohort`` with pre_resolve
   (0 conflicts, all placed); ``compute_defrag_plan(..., mesh=)`` on
   phase 8's fragmented layout, cold then warm at K = 512 x N = 10,240
   (K10f; fragmentation never rises, the warm plan's moves pass
   ``judge_migration_plan``); and phase 6's free gang, ici slice and
   meta-less spread through ``shard_gang_inputs`` + ``gang_placement``
   (K10e: one launch of K7's cluster kernel over the shards, the group
   sums inside it; on distinct cards K10b's sums and a launch a shard
   a step), equal to K7's choices, scores and slice group on the same
   call. Phase 7 holds K10a-K10g against their
   plain versions on these calls, with each record's launches a call
   read from the launch counts around one call (K10a and K10b held to
   one a card, and given their device time, the library's, and the
   host span of a call beside its device time; topk_profile.py
   --sections shards splits that span into its parts; K10a's library
   also on the call's footing, the host payload split by shard,
   uploaded and set by torch.index_put a shard), and K10d's per-shard
   path (csrc/sharded_topk.cu, which the one-card mesh never takes) on
   the first storm call's rows re-split into 16 shards of cuda:0:
   choices, scores and carry equal the plain version's and K2's, its
   launches (W + 1 an eval and W) counted around that one call.
10. Config 5, the JAX package's drain storm (bench.py ``config_5``),
   after phase 9 and before phase 7's holds: (a) 10,000 nodes in 200
   racks, 200 rack-scoped system jobs, 10% of the nodes drained, one
   node-update eval a job through ``"system"`` and ``"system-gpu"`` on
   two harnesses of the same nodes (evals/s and p99 of each; the two
   held job by job afterwards: the same allocs, statuses and queued
   counts, none on a drained node; no kernel launches: both are host
   passes); (b) the migration arm: 1,000 nodes, 20 service jobs x 24
   allocs through ``service-gpu``, the 10% most occupied nodes drained,
   the node-update and follow-up migration evals through
   ``service-gpu`` under a migration budget of 8 (migrations/s,
   disruption p99; bench.py's checks: something displaced and
   migrated, the high water within the budget, deferrals, 24 live
   allocs a job, none on a drained node; a main-path kernel launched).
   Its figures print as ``system drain figures: {...}``.
11. The runtime on the card (nomad_tpu_torch/trace and profile/, wired
   into the scheduler, the batcher and the storm driver), in three
   parts. (a) After phase 3, each of its evals' traces in the port's
   flight recorder holds matrix.build, matrix.update, matrix.compress,
   device.dispatch and device.solve under the eval's trace id;
   device.solve lies inside device.dispatch and names the placement
   kernel whose CUDA kernels the eval's launch counts show ran;
   matrix.update's kind is "full", "delta", "full" (eval (c)'s plan
   already holds in-place updates when its matrix is built, which
   makes its base uncacheable); printed as ``main path spans: {...}``.
   (b) Phase 4's rounds pass one (eval id, trace id) a row and trace
   each eval as bench.py's executive arm does (the row's stage spans,
   device.dispatch over the cohort dispatch, host.finalize, complete);
   after the config 4 rounds each eval holds exactly one device.solve
   whose batch is its cohort's live count; the rounds' stage table
   (``stage_stats``), the lock table of the batcher's, the matrix's and
   the recorder's sites, the GIL sampler's overshoot (running over the
   rounds), and, after the parked storm, its ``batch_park`` run-queue
   table and convoy table. (c) After phase 10, on a fresh cluster of
   the same shape: 4 pairs of arms of 3 config 4 rounds each, with the
   recorder and the profiler on in one arm of a pair and off in the
   other (on-off, off-on, on-off, off-on); each arm's evals/s, p50/p99
   and GC pauses, and each pair's on/off throughput ratio (printed,
   never a gate). All print as ``runtime figures: {...}``. The phase launches
   no kernel of its own.
12. Config 8 through the port's dev-mode ``Server`` (bench.py:1210
   ``config_8``, the dense arm of ``_live_pipeline``, bench.py:985-1140),
   after phase 11 (c), on the ServerConfig default path: the dispatch
   pipeline, 4 workers, ``{"service": "service-gpu"}``, nack timeout
   60 s. 10,000 mock nodes through ``log.apply("node_register")`` and 5
   filler allocs a node (cpu 50/100, memory 64/128, no networks, from
   ``--seed``) through ``alloc_update``; two unmeasured warm waves of 60
   jobs (one group of 8, cpu 20, 16 MB, dynamic ports, distinct_hosts),
   each registered with the workers parked, released, waited on and
   deregistered the same way; the measured storm of 60 such jobs (K5a
   uniform, K3; its base is the warm waves' re-keyed); a greedy wave of
   8 two-group jobs of phase 4's 512 + 512 shape (K0, K5a greedy, K3,
   K4 on the delta after the storm's commits), each placing what the
   host oracle places on the state before the wave, every placement
   feasible on its node (``check_placements``); a wave with
   ``pre_resolve`` off (4 config 8 jobs and 4 two-group jobs of 32 + 32
   small asks: K2 and K1's independent forms, rejections back through
   the pipeline's conflict requeue); the same with 8 two-group jobs
   of phase 4's networked asks, 64 + 64 (K1), held to every eval
   terminal, a failed one only on the scheduler's attempt limit, and
   every applier rejection of a dense plan explained by a commit after
   its matrix; 6 lone registrations on an idle
   broker, each routed to the host factory (no launch). Holds: every
   eval complete; 480 of 480 storm allocs, each job on 8 distinct
   nodes; no node holds a port twice and every node's live allocs fit
   (``allocs_fit``) in the final state; in the storm no eval routed to
   the host on its first delivery (a conflict requeue that comes back
   alone takes the host route, as in the reference: two batch members
   can offer one dynamic port on a node) and no rejection of a dense
   plan that its matrix cannot explain; the pipeline's ``routed_host``
   is 6 over the lone evals; no ERROR record on the port's loggers. Prints evals/s, p50/p99 per eval from release to
   complete, the lone p50/p99 from register to complete, the batcher's
   dispatches, occupancy and stack/issue/sync, the pipeline's batches,
   occupancy and retries per eval, the applier's rejections, the
   storm's gen-2 GC pauses and the flight recorder's stage table over
   the storm, as ``server storm figures: {...}``.
13. The scheduler executive and the live defrag loop through the port's
   ``Server`` (``scheduler_executive=True``, 4 workers, 4 executive
   threads, ``service-gpu``, nack timeout 60 s), after phase 12. (a)
   Config 8 as bench.py's ``_live_pipeline`` runs it (bench.py:1035-1039,
   :1210): phase 12's cluster, warm waves, storm and lone evals, the
   warm waves and the storm registered with the workers and the
   executive's drain parked. Holds: every eval complete, 480 of 480
   allocs on 8 distinct nodes a job, ports unique and ``allocs_fit`` on
   every node, the dispatch pipeline disabled, at least one cohort and
   one fast eval, a cohort dispatch, K5a uniform (or K2) and K3
   launched and no K0, no storm eval routed to the host on its first
   delivery, no device fault, the 6 lone evals routed to the host with
   no launch. Prints ``server executive figures: {...}`` (evals/s,
   p50/p99 release to complete, lone p50/p99, the executive's cohorts,
   occupancy, fast/legacy evals with reasons and drain/build/dispatch/
   finalize time, the applier's counters, gen-2 GC pauses, the stage
   table) and phase 12's pipeline figures beside them (printed, never a
   gate). (b) Config 6 (bench.py:1197): 1,000 nodes, no fillers, 120
   jobs x 4 allocs without networks, warm waves of 120, 12 lone evals:
   held as (a), with two or more cohorts (``eval_batch_size`` 64) and
   K5a greedy and K3 launched; ``server config 6 figures: {...}``. (c)
   The live ``DefragLoop`` with ``defrag_enabled`` on phase 8's
   fragmented layout at 10,000 nodes, loaded through the log, budget
   16 (``migrate_max_parallel``), 16 moves a wave, stepped by an
   injected clock for 6 rounds (bench.py:2569 ``_defrag_churn_arm``),
   each wave's evals waited on until terminal (the executive's legacy
   lane, ``service-gpu``, the applier, the FSM). Holds: every displaced
   alloc in exactly one committed eviction leg, stopped, with one
   replacement; the governor's high water within the budget and back at
   0 after a settle tick; fragmentation never rising; one cold solve
   then warm ones; K9 launched (the replacements prefer the solver's
   targets, which the scheduler places on the host, so no scan
   launches); no stale discard, lost wave or ERROR record. Prints ``server defrag figures: {...}``.
14. The multi-server control plane, after phase 13: three servers a
   cluster, each as phase 13's (the executive, 4 workers, 4 executive
   threads, ``service-gpu``, nack timeout 60 s). Each cluster is loaded
   through its leader's raft log from 4 writer threads with the
   collector off, its objects then frozen out of the collector
   (``bulk_load``: a gen-2 pause over three stores would outlast the
   150 ms election floor), a filler entry 100 nodes' allocs, the
   entries made with the collector off too, and each wave and the
   lone evals started with the heap frozen (``settle_heap``); the
   nodes' clients heartbeat every 5 s through the current leader
   (``Clients``). (a) and (c) draw raft's election timeouts from
   [1 s, 2 s), hashicorp/raft's defaults (``election_timeouts``): the
   three servers share one GIL, and under the storm a follower's timer
   could wait past the port's 300 ms and elect a new leader mid-storm;
   (b) measures an election and keeps the port's 150-300 ms. (a) Config 8 over ``InmemTransport``
   (``start_with_raft``): phase 12's 10,000 nodes and 50,000 fillers,
   one warm wave through the leader (``CLUSTER_WARM_WAVES``), the storm of 60 jobs x 8 and 6
   lone evals registered through a follower. Holds: every eval
   complete, 480 of 480 allocs on 8 distinct nodes a job, ports unique
   and ``allocs_fit`` on every node, the three FSMs' node, alloc, eval
   and job tables equal by id with create/modify indexes, K5a uniform
   (or K2) and K3 launched and no K0, no device fault, the lone evals
   with no launch, no ERROR record. Prints ``server cluster figures``
   with evals/s, p50/p99 release to complete, lone p50/p99, a server's
   cohorts, fast evals and placements, forwarded writes, the largest
   follower lag behind the leader's commit index, new terms and
   elections, the stage table, and phase 13 (a)'s figures beside
   (printed, never a gate). (b) Failover during config 6's storm
   (1,000 nodes, warm waves of 120, 120 jobs x 4): the storm registered
   with every server parked, the leader cut off
   (``transport.disconnect``), the two others released once both name
   a new leader (the in-process cluster map would hand them the cut
   leader's broker before that; the cut leader stays parked). Holds: a
   new leader with its broker enabled, all 120 evals complete on it, 4
   allocs a job with no alloc placed twice, the two FSMs equal, K5a
   greedy and K3 launched after the cut. Prints the cut to the new
   leader, to the broker enabled, to the first and the last eval
   complete, and evals/s. (c) Config 6 over ``TCPTransport``: three
   servers ``setup_serf``, ``serf_join`` and ``setup_raft_cluster(
   expect=3)`` on 127.0.0.1 ephemeral ports, each behind the port's
   ``HTTPServer`` on 127.0.0.1:0 whose address it tags into serf; the
   storm registered through the leader, the followers' workers and
   executives dequeuing, submitting plans and acking through the
   leader's HTTP (phase 15 (b)); the followers are released first and
   the leader once a follower has dequeued through its HTTP (released
   together, the leader's executive can drain the whole storm into one
   cohort before a follower's first call arrives). Holds: one leader over the three raft
   addresses, each follower finding the leader's HTTP address, every
   eval complete, the followers' decoded FSMs equal to the leader's
   field by field (``to_dict``, but for the nodes' ``status_updated_at``,
   which each replica stamps with its own clock), K5a greedy and K3
   launched. Prints the bootstrap time, evals/s and p99.
15. The API (nomad_tpu_torch/api, readplane/). (a) Config 8 over HTTP,
   on phase 13 (a)'s loaded server after its lone evals, before it
   stops: the port's ``HTTPServer`` on 127.0.0.1:0 in front of it; the
   storm's 60 jobs x 8 registered through the SDK
   (``Client.jobs.register``) from 4 threads with the workers and the
   executive held; each eval watched by a blocking query,
   ``GET /v1/evaluation/<id>?index=N``, on its own keep-alive socket,
   the 60 sockets read by one thread through a selector, so the
   process's thread count shows the server side. Holds: the 60 queries
   parked on the read mux with fewer Python threads in the process than
   parked queries, every eval complete, 480 of 480 allocs on 8 distinct
   nodes a job, ports unique and ``allocs_fit`` on every node, the read
   mux's wakes each for a scope that moved (no spurious wake, no
   timeout, every blocking answer served by the mux), at least one
   cohort dispatch, K5a uniform (or K2) and K3 launched and no K0, none
   routed to the host on its first delivery; then 6 lone evals
   registered one at a time and watched the same way, routed to the
   host with no launch. Prints ``server API figures: {...}``: evals/s,
   p50/p99 from register to the blocking query's answer of complete
   (and from release), the lone p50/p99, the parked high water and the
   thread counts while parked. (b) Phase 14 (c)'s followers schedule
   through the leader's HTTP: at least one storm eval dequeued by a
   follower through it (counted and printed), and a ``?consistent``
   read of the last eval on each follower's API, once it has heard of
   the leader's last commit, serves at or past the leader's store
   index with the eval as the leader holds it.

Each phase prints ``phase <n>: <name> (at <t> s)`` as it starts, t the
seconds since the script started, and a failure names the phase it
stopped in. Every wait of phase 15 has its own
deadline, and its HTTP servers stop in a ``finally``.

Every path of phases 3 to 6, 8, 9, 10, 11 (c), 12, 13, 14 and 15 runs
with the launch counts set to 0 just before it and read just after, and
fails if a kernel of that path was never launched (10a's evals and the
lone evals of 12, 13, 14 and 15: if any kernel was).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import logging
import os
import random
import statistics
import subprocess
import sys
import time
from collections import Counter
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and float32
# non-tensor FLOP/s (FMA counted as 2).
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
# 32-bit integer operations: 64 INT32 lanes per SM plus the 64 lanes of
# the FMA pipe that also issue integer adds (IMAD), x 132 SMs x 1.98 GHz
# boost (Hopper architecture white paper).
INT32_OPS = 128 * 132 * 1.98e9

SCORE_TOL = 1e-4

# The north-star cluster and the kernels' widths on its main path.
N_NODES = 10_000
ALLOCS_PER_NODE = 5
BENCH_N = 10_240  # the node bucket of 10,000 nodes
BENCH_K = 1_024   # the ask bucket of eval (b)
RUNS = 20         # timed runs per kernel, after warm-up
# Timed runs of the greedy scans' plain versions (2-9 s a call on the
# card at K = 1,024 or B = 64; checked against the kernel just before,
# so no warm-up): one keeps the smoke's wall time for phase 12.
SLOW_PLAIN_RUNS = 1

# Bytes of one node's static row (capacity, sched_capacity, bw_avail,
# node_ok); of one carried row, read once or written back once (util,
# bw_used, ports_free, job_count; tg_count adds 4 a task group); of one
# ask (resources, bw, ports, tg_index, active).
NODE_BYTES = 16 + 16 + 4 + 1
CARRY_ROW_BYTES = 16 + 4 + 4 + 4
ASK_BYTES = 16 + 4 + 4 + 4 + 1


class SmokeFailure(Exception):
    pass


# The phase that runs now, named by a failure.
PHASE = ["start"]
STARTED = time.perf_counter()


def phase(number, name):
    """Name the phase that starts now, on a line of its own."""
    PHASE[0] = f"{number} ({name})"
    print(f"phase {number}: {name} (at {time.perf_counter() - STARTED:.1f}"
          f" s)")


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=60)
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    check(out.returncode == 0 and line, f"nvidia-smi failed: {out.stdout}")
    return line


# ---------------------------------------------------------------- cluster


def build_cluster(harness, n_nodes, allocs_per_node, seed, meta=None):
    """The north-star cluster (the JAX package's bench config 4 shape):
    mock nodes over dc1/dc2, each carrying filler allocs of a modest
    seeded footprint. ``meta(node, i)``, if given, sets node meta
    before the node's class is computed."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    rng = random.Random(seed)
    filler = mock.job()
    filler.id = "filler"
    filler.task_groups[0].tasks[0].resources.networks = []
    harness.state.upsert_job(harness.next_index(), filler)
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = ("dc1", "dc2")[i % 2]
        if meta is not None:
            meta(node, i)
        node.compute_class()
        harness.state.upsert_node(harness.next_index(), node)
        allocs = []
        for _ in range(allocs_per_node):
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = filler.id
            alloc.job = filler
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = rng.choice((50, 100))
                tr.memory_mb = rng.choice((64, 128))
                tr.networks = []
            alloc.resources = None
            allocs.append(alloc)
        harness.state.upsert_allocs(harness.next_index(), allocs)


def north_star_job():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, consts

    job = mock.job()
    job.id = "north-star"
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.name = "g0"
    tg.count = 8
    tg.constraints.append(Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return job


def two_group_job(count):
    from nomad_tpu_torch import mock

    job = mock.job()
    job.id = "two-groups"
    job.datacenters = ["dc1", "dc2"]
    tg0 = job.task_groups[0]
    tg0.count = count
    tg1 = tg0.copy()
    tg1.name = "api"
    tg1.tasks[0].resources.cpu = 250
    tg1.tasks[0].resources.memory_mb = 384
    job.task_groups = [tg0, tg1]
    return job


class _DryRunPlanner:
    """Planner for the host oracle: records the plan, commits nothing."""

    def __init__(self):
        self.plans = []

    def submit_plan(self, plan):
        from nomad_tpu_torch.structs import PlanResult

        self.plans.append(plan)
        return PlanResult(node_allocation=plan.node_allocation,
                          node_update=plan.node_update), None

    def update_eval(self, ev):
        pass

    def create_eval(self, ev):
        pass

    def reblock_eval(self, ev):
        pass


def host_oracle_count(state, ev, seed, existing):
    """Placements the port's host "service" scheduler makes for ``ev``
    on ``state`` (nothing is committed)."""
    from nomad_tpu_torch.scheduler import new_scheduler

    planner = _DryRunPlanner()
    sched = new_scheduler("service", logging.getLogger("smoke.host"),
                          state.snapshot(), planner,
                          rng=random.Random(seed))
    sched.process_eval(ev.copy())
    return sum(len(new_allocs(p, existing)) for p in planner.plans)


def new_allocs(plan, existing):
    """Allocs this plan creates: in-place updates keep their ids."""
    return [a for allocs in plan.node_allocation.values() for a in allocs
            if a.id not in existing]


def check_placements(state, job, plan):
    """Every dense placement passes the host's constraint/driver
    feasibility and AllocsFit on its node, with the plan committed."""
    from nomad_tpu_torch.scheduler.context import EvalContext
    from nomad_tpu_torch.scheduler.feasible import (
        ConstraintChecker,
        DriverChecker,
    )
    from nomad_tpu_torch.structs import Plan, allocs_fit

    snap = state.snapshot()
    ctx = EvalContext(snap, Plan())
    cons = ConstraintChecker(ctx)
    drivers = DriverChecker(ctx)
    groups = {tg.name: tg for tg in job.task_groups}
    for node_id, allocs in plan.node_allocation.items():
        node = snap.node_by_id(node_id)
        check(node is not None and node.ready(), f"node {node_id} not ready")
        for a in allocs:
            tg = groups[a.task_group]
            cs = list(job.constraints) + list(tg.constraints)
            for t in tg.tasks:
                cs.extend(t.constraints)
            cons.set_constraints([c for c in cs if c.operand != "distinct_hosts"])
            drivers.set_drivers({t.driver for t in tg.tasks})
            check(cons.feasible(node) and drivers.feasible(node),
                  f"{a.name} placed on infeasible node {node_id}")
        live = snap.allocs_by_node_terminal(node_id, False)
        fit, dim, _ = allocs_fit(node, live)
        check(fit, f"node {node_id} over capacity after the plan ({dim})")


# The kernels of the service main path (phase 3 launches each).
MAIN_PATH_KERNELS = ("threefry_uniform", "greedy_scan", "uniform_topk",
                     "expand_overlay", "base_delta")


def run_main_path(seed, torch):
    from nomad_tpu_torch import trace
    from nomad_tpu_torch.ops import cuda
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    t0 = time.perf_counter()
    h = Harness(seed=seed)
    build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed)
    n_allocs = len(h.state.allocs())
    print(f"cluster: {N_NODES} nodes, {n_allocs} allocs, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    check(n_allocs == N_NODES * ALLOCS_PER_NODE, "cluster size")

    star = north_star_job()
    two = two_group_job(512)
    grown = two.copy()
    grown.task_groups[0].count = 768
    grown.task_groups[1].count = 768
    steps = [("a: north-star job (ports + distinct_hosts, count 8)", star, 8),
             ("b: two-group job, 512 + 512 asks", two, 1024),
             ("c: two-group job scaled to 768 + 768", grown, 512)]
    batcher = get_batcher()
    stats0 = batcher.stats()
    lat_ms = []
    traced = []  # (label, eval, launches of that eval)
    place_us = dispatch_us(stats0)
    trace.get_recorder().reset()
    cuda.reset_launch_counts()
    with ScanModes("main path"):
        for label, job, expect in steps:
            h.state.upsert_job(h.next_index(), job)
            ev = new_eval(h.state.job_by_id(job.id),
                          consts.EVAL_TRIGGER_JOB_REGISTER)
            existing = {a.id for a in h.state.allocs_by_job(job.id)}
            host_n = host_oracle_count(h.state, ev, seed, existing)
            n_plans = len(h.plans)
            before = Counter(cuda.launch_counts())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            h.process("service-gpu", ev)
            torch.cuda.synchronize()
            lat_ms.append((time.perf_counter() - t1) * 1000.0)
            traced.append((label, ev,
                           Counter(cuda.launch_counts()) - before))
            place_ms = (dispatch_us(batcher.stats()) - place_us) / 1000.0
            place_us = dispatch_us(batcher.stats())
            check(len(h.plans) == n_plans + 1, f"{label}: no plan submitted")
            plan = h.plans[-1]
            fresh = new_allocs(plan, existing)
            dense_n = len(fresh)
            print(f"eval {label}: placed {dense_n} (host oracle {host_n}), "
                  f"{lat_ms[-1]:.1f} ms, of which {place_ms:.1f} ms in the "
                  "batcher's dispatch (uploads, kernels, copy back)")
            check(dense_n == host_n == expect,
                  f"{label}: dense placed {dense_n}, host {host_n}, "
                  f"expected {expect}")
            check(h.evals[-1].status == consts.EVAL_STATUS_COMPLETE,
                  f"{label}: eval status {h.evals[-1].status}")
            check_placements(h.state, h.state.job_by_id(job.id), plan)
            if job is star:
                check(len({a.node_id for a in fresh}) == dense_n,
                      f"{label}: distinct_hosts violated")
    counts = cuda.launch_counts()
    stats = batcher.stats()
    delta = stats_delta(stats0, stats)
    print(f"main path launches: {json.dumps(counts, sort_keys=True)}")
    print(f"batcher: {json.dumps(delta, sort_keys=True)}")
    # K0 draws the noise the greedy scan reads at these shapes (a lone
    # eval padded to 4: PERF.md §6); the uniform top-K draws its own.
    require_launches(counts, "main path", MAIN_PATH_KERNELS)
    check(delta["fused_delta_updates"] > 0, "no fused base delta")
    total_s = sum(lat_ms) / 1000.0
    print(f"main path: {len(lat_ms)} evals, {len(lat_ms) / total_s:.2f} "
          f"evals/s, per-eval ms {[round(x, 3) for x in lat_ms]}")
    spans = check_main_path_spans(traced)
    print(f"main path spans: {json.dumps(spans, sort_keys=True)}")
    return counts, lat_ms, h


# Phase 11 (a): the stages every dense service eval records, and the
# base's build kind each of phase 3's evals must show. Eval (a) builds
# the cluster's first base; (b) follows (a)'s commit, so its base is a
# delta of (a)'s; (c)'s plan already holds in-place updates of (b)'s
# allocs when its matrix is built, which makes its base uncacheable (the
# JAX package's ClusterMatrix rule), so it is built in full again.
DENSE_STAGES = ("matrix.build", "matrix.update", "matrix.compress",
                "device.dispatch", "device.solve")
MAIN_PATH_KINDS = ("full", "delta", "full")
# The placement kernel a device.solve span names -> the launch-count
# names (prefixes) of the CUDA kernels that implement it.
SOLVE_KERNELS = {"greedy": ("greedy_scan", "uniform_topk")}


def check_main_path_spans(traced):
    """Phase 11 (a), read after phase 3's evals: each eval's trace in
    the port's flight recorder holds DENSE_STAGES under its trace id;
    device.solve lies inside device.dispatch and names a kernel the
    eval's launch counts show ran; matrix.update's kind is the one
    MAIN_PATH_KINDS gives. Returns each eval's span table."""
    from nomad_tpu_torch import trace

    rec = trace.get_recorder()
    out = {}
    for (label, ev, launched), kind in zip(traced, MAIN_PATH_KINDS):
        rec.complete(ev.id)
        tr = rec.trace_for(ev.id)
        check(tr is not None, f"{label}: no trace recorded")
        check(tr["trace_id"] == ev.trace_id,
              f"{label}: trace id {tr['trace_id']} is not the eval's")
        names = [sp["name"] for sp in tr["spans"]]
        for stage in DENSE_STAGES:
            check(names.count(stage) == 1,
                  f"{label}: {names.count(stage)} {stage} spans ({names})")
        sp = {x["name"]: x for x in tr["spans"]}
        solve, disp = sp["device.solve"], sp["device.dispatch"]
        check(disp["start_ms"] <= solve["start_ms"]
              and solve["end_ms"] <= disp["end_ms"],
              f"{label}: device.solve {solve} outside device.dispatch "
              f"{disp}")
        kernel = solve["annotations"]["kernel"]
        ran = sorted(k for k, n in launched.items() if n and any(
            k.startswith(x) for x in SOLVE_KERNELS.get(kernel, ())))
        check(ran, f"{label}: device.solve names {kernel!r}, but none of "
              f"its kernels launched ({dict(launched)})")
        update = sp["matrix.update"]["annotations"]
        check(update["kind"] in ("full", "hit", "delta")
              and update["kind"] == kind,
              f"{label}: matrix.update kind {update['kind']!r}, expected "
              f"{kind!r}")
        out[label] = {
            "stages_ms": {x["name"]: x["duration_ms"] for x in tr["spans"]},
            "kind": update["kind"], "delta_rows": update["rows"],
            "kernel": kernel, "batch": solve["annotations"]["batch"],
            "kernels_launched": ran,
            "classes": sp["matrix.compress"]["annotations"]}
    return out


def dispatch_us(stats):
    """Batcher time in dispatches: base uploads, stacking and payload
    upload, kernel issue, and the copy back that waits for the card."""
    return sum(stats[k] for k in ("upload_us", "stack_us", "issue_us",
                                  "sync_us"))


def stats_delta(before, after):
    return {k: after[k] - before[k] for k in after
            if isinstance(after[k], int) and isinstance(before.get(k), int)}


def require_launches(counts, label, names):
    """Each name launched on ``label`` (a tuple of names: any one)."""
    for name in names:
        alts = name if isinstance(name, tuple) else (name,)
        check(any(counts.get(n, 0) > 0 for n in alts),
              f"kernel {' or '.join(alts)} never launched on {label}")


# The uniform top-K (K2, K5 uniform, K10d on one card) draws its noise in
# its kernel, as the greedy scan does where that beats K0 (scan.draws):
# a path through the uniform top-K alone launches no K0.
DRAWN_IN_SCANS = ("threefry_uniform",)


def require_no_launches(counts, label, names):
    for name in names:
        check(counts.get(name, 0) == 0,
              f"kernel {name} launched {counts.get(name)} times on {label}")


# ---------------------------------------------------------------- storm

STORM_ROUNDS = 4
STORM_BATCH = 64
STORM_THREADS = 4
GREEDY_STORM_BATCH = 16


def storm_job(job_id, count=8):
    """Config 4's job (bench.py service_job(networks=True,
    distinct_hosts=True), count 8) under its own id: a storm's evals are
    registrations of distinct jobs."""
    job = north_star_job()
    job.id = job_id
    job.task_groups[0].count = count
    return job


def tg_cycle_of(job):
    return [gi for gi, tg in enumerate(job.task_groups)
            for _ in range(tg.count)]


def placement_config(job, matrix, pre_resolve, kernel=None):
    """The config the dense scheduler builds for ``job``
    (scheduler/tpu.py build_placement_config)."""
    from nomad_tpu_torch.scheduler.tpu import build_placement_config

    tgs = tg_cycle_of(job)
    return build_placement_config(False, pre_resolve, kernel, tgs,
                                  matrix.build_asks(tgs))


class GcPauses:
    """Python's garbage-collector pauses while the block runs (a host
    cost on the storm path: the store holds ~10^5 objects)."""

    def __enter__(self):
        import gc

        self.pauses = []
        self._start = 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._start))

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)

    def summary(self):
        gen2 = [t for g, t in self.pauses if g == 2]
        return dict(gc_collections=len(self.pauses),
                    gc_gen2_collections=len(gen2),
                    gc_total_ms=sum(t for _g, t in self.pauses) * 1000.0,
                    gc_max_pause_ms=max((t for _g, t in self.pauses),
                                        default=0.0) * 1000.0)


def storm_eval_id(job, seed):
    """The trace identity of one storm row's eval."""
    return f"{job.id}#{seed}"


class Storm:
    """bench.py bench_tpu_e2e's executive arm on the port: rows built on
    a small pool, one cohort dispatch, finalize on a second pool."""

    def __init__(self, harness, batcher, threads=STORM_THREADS):
        from concurrent.futures import ThreadPoolExecutor

        self.h = harness
        self.batcher = batcher
        self.pool = ThreadPoolExecutor(max_workers=threads)
        self.finalize_pool = ThreadPoolExecutor(max_workers=threads)

    def close(self):
        self.pool.shutdown(wait=True)
        self.finalize_pool.shutdown(wait=True)

    def jobs(self, prefix, n, make):
        out = []
        for i in range(n):
            job = make(f"{prefix}-{i}")
            self.h.state.upsert_job(self.h.next_index(), job)
            out.append(self.h.state.job_by_id(job.id))
        return out

    def build_row(self, snap, job, seed):
        """One eval's row (job, seed, matrix, asks, key), with the
        executive's stage spans on its trace (the JAX package's
        server/executive.py _build_row): matrix.build over the matrix and
        asks, matrix.update over the base (its build kind and delta
        rows), matrix.compress (the class index's stats). The caller
        completes the trace (``storm_eval_id(job, seed)``)."""
        from nomad_tpu_torch import trace
        from nomad_tpu_torch.models.matrix import ClusterMatrix
        from nomad_tpu_torch.ops.binpack import host_prng_key, make_asks

        eid = storm_eval_id(job, seed)
        t0 = time.monotonic()
        matrix = ClusterMatrix(snap, job)
        t_base = time.monotonic()
        tgs = tg_cycle_of(job)
        asks = make_asks(*matrix.build_asks(tgs))
        trace.record_span(eid, trace.STAGE_MATRIX_BUILD, t0,
                          ann={"placements": len(tgs), "executive": True})
        trace.record_span(eid, trace.STAGE_MATRIX_UPDATE, t0, t_base,
                          ann={"kind": matrix.build_kind,
                               "rows": matrix.delta_rows})
        trace.record_span(eid, trace.STAGE_MATRIX_COMPRESS, t_base, t_base,
                          ann=matrix.class_index.stats())
        return job, seed, matrix, asks, host_prng_key(seed)

    def materialize(self, row, choices, scores):
        """Port offers and Allocation objects for one row's choices
        (bench.py's materialize). Returns the eval's plan."""
        from types import SimpleNamespace

        from nomad_tpu_torch.scheduler.tpu import (
            _build_allocation,
            _offer_networks,
        )
        from nomad_tpu_torch.scheduler.util import AllocTuple
        from nomad_tpu_torch.structs import AllocMetric, Plan

        job, seed, matrix, _asks, _key = row
        rng = random.Random(seed)
        stub = SimpleNamespace(eval=SimpleNamespace(id=f"storm-{seed}"),
                               job=job)
        plan = Plan(job=job)
        net_indexes = {}
        for j, gi in enumerate(tg_cycle_of(job)):
            tg = job.task_groups[gi]
            choice = int(choices[j])
            if not 0 <= choice < matrix.n_real:
                continue
            node = matrix.nodes[choice]
            metrics = AllocMetric()
            metrics.nodes_evaluated = matrix.n_real
            metrics.nodes_available = matrix.nodes_by_dc
            metrics.score_node(node, "binpack", float(scores[j]))
            missing = AllocTuple(name=f"{job.id}.{tg.name}[{j}]",
                                 task_group=tg, alloc=None)
            resources = _offer_networks(rng, missing, node, net_indexes,
                                        matrix)
            if resources is None:
                continue
            plan.append_alloc(_build_allocation(stub, missing, node,
                                                resources, metrics))
        return plan

    def round(self, jobs, seed, config_of):
        """One round: returns (rows, [(choices, scores)], [plan],
        [per-eval seconds from round open], round seconds). Each eval is
        traced as bench.py's executive arm traces it: the row's stage
        spans, device.dispatch over the cohort dispatch (the batcher
        adds device.solve inside it), host.finalize, then complete."""
        from nomad_tpu_torch import trace

        t0 = time.perf_counter()
        snap = self.h.state.snapshot()
        rows = [f.result() for f in [
            self.pool.submit(self.build_row, snap, job, seed + i)
            for i, job in enumerate(jobs)]]
        t_disp = time.monotonic()
        results = self.batcher.place_cohort([
            (m, a, k, config_of(job, m), (storm_eval_id(job, s), ""))
            for job, s, m, a, k in rows])
        t_done = time.monotonic()
        ann = {"cohort": len(rows)}
        for job, s, _m, _a, _k in rows:
            trace.record_span(storm_eval_id(job, s),
                              trace.STAGE_DEVICE_DISPATCH, t_disp, t_done,
                              ann=ann)

        def finalize(row, res):
            t_fin = time.monotonic()
            plan = self.materialize(row, *res)
            eid = storm_eval_id(row[0], row[1])
            trace.record_span(eid, "host.finalize", t_fin)
            trace.complete(eid)
            return plan, time.perf_counter() - t0

        done = [f.result() for f in [
            self.finalize_pool.submit(finalize, row, res)
            for row, res in zip(rows, results)]]
        return (rows, results, [p for p, _t in done], [t for _p, t in done],
                time.perf_counter() - t0)

    def commit(self, plans):
        """All of a round's allocations in one store write: the next
        snapshot's base is a delta child of this round's."""
        allocs = []
        for plan in plans:
            for per_node in plan.node_allocation.values():
                for a in per_node:
                    a.job = plan.job
                    allocs.append(a)
        self.h.state.upsert_allocs(self.h.next_index(), allocs)
        return len(allocs)


def conflicted_evals(rows, results):
    """bench.py's verify_round: the round's placements replayed in order
    against shared claimed capacity (AllocsFit, bandwidth, ports) on the
    round's own base; an eval with a rejected placement would replan.
    distinct_hosts is per eval (distinct jobs) and out of scope."""
    import numpy as np

    vm = rows[0][2]
    res, bw, ports = vm.build_asks(tg_cycle_of(rows[0][0]))[:3]
    claimed_util = np.zeros_like(vm.util)
    claimed_bw = np.zeros_like(vm.bw_used)
    claimed_ports = np.zeros_like(vm.ports_free)
    conflicted = 0
    for row, (choices, _scores) in zip(rows, results):
        bad = False
        for j in range(len(tg_cycle_of(row[0]))):
            c = int(choices[j])
            if not 0 <= c < vm.n_real:
                continue
            ok = (np.all(vm.util[c] + claimed_util[c] + res[j]
                         <= vm.capacity[c])
                  and vm.bw_used[c] + claimed_bw[c] + bw[j] <= vm.bw_avail[c]
                  and vm.ports_free[c] - claimed_ports[c] >= ports[j])
            if not ok:
                bad = True
                continue
            claimed_util[c] += res[j]
            claimed_bw[c] += bw[j]
            claimed_ports[c] += ports[j]
        conflicted += bad
    return conflicted


def hold_against_cpu(label, rows, results, config_of):
    """The same cohort through a CPU batcher (the plain versions):
    choices equal, scores within SCORE_TOL. Returns the score error."""
    import numpy as np

    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher

    cpu = PlacementBatcher("cpu").place_cohort([
        (m, a, k, config_of(job, m), None) for job, _s, m, a, k in rows])
    err = 0.0
    for (c, s), (c_cpu, s_cpu) in zip(results, cpu):
        check(np.array_equal(c, c_cpu), f"{label}: choices differ from "
              "the CPU batcher's")
        err = max(err, float(np.abs(s - s_cpu).max()))
    check(err <= SCORE_TOL, f"{label}: score error {err} against the CPU")
    return err


class ScanModes:
    """The greedy scan's launches inside the block by noise mode:
    ``scan.launch`` wrapped (``binpack.greedy_scan`` looks it up at
    each call), each launch counted by (B, seq, drawn, CTAs). Every
    path's tally is kept in ``SCAN_MODES`` under its label."""

    def __init__(self, label):
        self.label, self.seen = label, Counter()

    def __enter__(self):
        from nomad_tpu_torch.ops import scan

        self.scan, self.orig = scan, scan.launch

        def launch(plan, static, carry, feasible, *args, **kwargs):
            self.seen[(feasible.shape[0], bool(args[3]), plan.drawn,
                       plan.ctas)] += 1
            return self.orig(plan, static, carry, feasible, *args, **kwargs)

        scan.launch = launch
        return self

    def __exit__(self, *exc):
        self.scan.launch = self.orig
        if self.seen:
            drawn = sum(v for key, v in self.seen.items() if key[2])
            SCAN_MODES[self.label] = dict(
                drawn=drawn, read=sum(self.seen.values()) - drawn,
                launches=[dict(b=b, seq=seq, drawn=d, ctas=c, n=v)
                          for (b, seq, d, c), v in sorted(self.seen.items())])
            print(f"{self.label}: greedy scan launches by noise mode "
                  f"{json.dumps(SCAN_MODES[self.label], sort_keys=True)}")


SCAN_MODES = {}


# ``counted``'s ``absent`` for a path that may launch no kernel at all.
ANY_KERNEL = "any kernel"


def counted(total, label, names, fn, absent=()):
    """Run one path with the launch counts set to 0 just before it and
    read just after; fail if a kernel of the path never launched, or if
    a kernel of ``absent`` did (every kernel, with ``ANY_KERNEL``). The
    greedy scan's launches are tallied by noise mode (``ScanModes``)."""
    from nomad_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    with ScanModes(label):
        out = fn()
    counts = cuda.launch_counts()
    print(f"{label} launches: {json.dumps(counts, sort_keys=True)}")
    require_launches(counts, label, names)
    require_no_launches(counts, label,
                        sorted(counts) if absent == ANY_KERNEL else absent)
    total.update(counts)
    return out


def run_storm(seed, torch, total):
    """Phase 4 (see the module docstring). Adds each path's launch
    counts to ``total``; returns the storm's figures."""
    import numpy as np

    from nomad_tpu_torch import profile, trace
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.scheduler.testing import Harness

    t0 = time.perf_counter()
    h = Harness(seed=seed + 1)
    build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed + 1)
    print(f"storm cluster: {N_NODES} nodes, {len(h.state.allocs())} allocs,"
          f" built in {time.perf_counter() - t0:.1f} s (host)")
    batcher = get_batcher()
    storm = Storm(h, batcher)
    on = lambda job, m: placement_config(job, m, True)  # noqa: E731
    off = lambda job, m: placement_config(job, m, False)  # noqa: E731
    figures = {}
    try:
        # Warm-up round on the first snapshot, not committed.
        storm.round(storm.jobs("warm", STORM_BATCH, storm_job), 50_000, on)
        rounds = [storm.jobs(f"storm{r}", STORM_BATCH, storm_job)
                  for r in range(STORM_ROUNDS)]
        stats0 = batcher.stats()

        def config4():
            out = []
            for r, jobs in enumerate(rounds):
                out.append(storm.round(jobs, 60_000 + r * STORM_BATCH, on))
                storm.commit(out[-1][2])
            return out

        # Phase 11 (b): the storm's rounds alone in the recorder and the
        # profiler, the GIL sampler running over them.
        prof = profile.get_profiler()
        trace.get_recorder().reset()
        prof.reset()
        prof.ensure_sampler()
        try:
            with GcPauses() as gc_pauses, \
                    Recorder(binpack, "apply_base_delta",
                             copy=False) as deltas:
                done = counted(total, "config 4 storm", (
                    "uniform_topk_seq", "expand_overlay", "base_delta"),
                    config4, DRAWN_IN_SCANS)
        finally:
            prof.gil.stop()
        runtime = storm_runtime(done, batcher)
        hold_deltas(torch, "config 4 storm", deltas.calls)
        stats = stats_delta(stats0, batcher.stats())
        lat = [t for r in done for t in r[3]]
        wall = sum(r[4] for r in done)
        placed = sum(len(a) for r in done for p in r[2]
                     for a in p.node_allocation.values())
        conflicted = sum(conflicted_evals(r[0], r[1]) for r in done)
        n_evals = STORM_ROUNDS * STORM_BATCH
        figures.update(
            evals=n_evals, evals_per_s=n_evals / wall,
            p50_ms=float(np.percentile(lat, 50)) * 1000.0,
            p99_ms=float(np.percentile(lat, 99)) * 1000.0,
            dispatches=stats["dispatches"],
            occupancy=stats["batched_requests"] / max(stats["dispatches"], 1),
            stack_ms=stats["stack_us"] / 1000.0,
            issue_ms=stats["issue_us"] / 1000.0,
            sync_ms=stats["sync_us"] / 1000.0,
            upload_ms=stats["upload_us"] / 1000.0,
            fused_delta_updates=stats["fused_delta_updates"],
            placed=placed, conflicted_pre_resolve=conflicted)
        print(f"config 4 storm: {n_evals} evals in {wall:.3f} s = "
              f"{figures['evals_per_s']:.2f} evals/s; per-eval p50 "
              f"{figures['p50_ms']:.2f} ms, p99 {figures['p99_ms']:.2f} ms; "
              f"{stats['dispatches']} dispatches, occupancy "
              f"{figures['occupancy']:.1f}; stack {figures['stack_ms']:.1f} "
              f"ms, issue {figures['issue_ms']:.1f} ms, sync "
              f"{figures['sync_ms']:.1f} ms, base uploads "
              f"{figures['upload_ms']:.1f} ms over the {STORM_ROUNDS} rounds;"
              f" {placed} allocs placed; conflicted evals with pre_resolve "
              f"on: {conflicted}")
        figures.update(gc_pauses.summary())
        print(f"  garbage collection in those rounds: "
              f"{json.dumps(gc_pauses.summary(), sort_keys=True)}")
        for r, (_rows, _res, _plans, lat_r, wall_r) in enumerate(done):
            print(f"  round {r}: {wall_r * 1000:.1f} ms, per-eval p50 "
                  f"{np.percentile(lat_r, 50) * 1000:.1f} ms, max "
                  f"{max(lat_r) * 1000:.1f} ms")
        check_placed("config 4 storm", [x for r in done for x in r[1]],
                     placed, n_evals * 8)
        check(conflicted == 0, f"{conflicted} conflicted evals with "
              "pre_resolve on")
        check(stats["pre_resolve_dispatches"] == stats["dispatches"]
              == STORM_ROUNDS, f"storm dispatches: {stats}")
        check(stats["fused_delta_updates"] == STORM_ROUNDS - 1,
              "storm rounds after the first did not fuse their base delta")
        figures.update(device_share(
            torch, lambda: storm.round(
                storm.jobs("profiled", STORM_BATCH, storm_job), 75_000, on)))
        # Round 2 (a fused-delta round) against the plain versions.
        err = hold_against_cpu("config 4 round 2", done[1][0], done[1][1],
                               on)
        print(f"config 4 round 2 through a CPU batcher (plain versions): "
              f"choices equal, max score error {err:.3g}")
        figures["cpu_score_err"] = err

        def pre_resolve_off():
            rows, results, _p, _l, _w = storm.round(
                storm.jobs("off", STORM_BATCH, storm_job), 70_000, off)
            return conflicted_evals(rows, results)

        figures["conflicted_pre_resolve_off"] = counted(
            total, "config 4 round, pre_resolve off", ("uniform_topk",),
            pre_resolve_off, DRAWN_IN_SCANS)
        print("config 4 round with pre_resolve off: conflicted evals "
              f"{figures['conflicted_pre_resolve_off']} of {STORM_BATCH}")

        def greedy():
            jobs = storm.jobs("greedy", GREEDY_STORM_BATCH,
                              lambda i: two_group_job_id(i, 512))
            s0 = batcher.stats()
            rows, results, plans, _lat, wall = storm.round(jobs, 80_000, on)
            return rows, results, plans, wall, stats_delta(
                s0, batcher.stats())

        with AlikeAsks(torch) as alike:
            rows, results, plans, wall, st = counted(
                total, "greedy storm",
                ("threefry_uniform", "greedy_scan_seq", "expand_overlay"),
                greedy)
        placed = sum(len(a) for p in plans for a in p.node_allocation.values())
        conflicted = conflicted_evals(rows, results)
        print(f"greedy storm: {GREEDY_STORM_BATCH} evals x 1,024 asks in "
              f"{wall:.3f} s, {st['dispatches']} dispatch(es), issue "
              f"{st['issue_us'] / 1000:.1f} ms, sync "
              f"{st['sync_us'] / 1000:.1f} ms; {placed} placed; "
              f"conflicted evals with pre_resolve on: {conflicted}")
        check_placed("greedy storm", results, placed,
                     GREEDY_STORM_BATCH * 1024)
        check(conflicted == 0, f"greedy storm: {conflicted} conflicted evals")
        figures.update(greedy_wall_s=wall, greedy_conflicted=conflicted,
                       greedy_asks=alike.figures())
        print(f"greedy storm asks (the batcher's): {alike.figures()}")

        def greedy_off():
            jobs = storm.jobs("greedy-off", STORM_BATCH,
                              lambda i: two_group_job_id(i, 512))
            s0 = batcher.stats()
            rows, results, plans, _lat, wall = storm.round(jobs, 85_000, off)
            return rows, results, plans, wall, stats_delta(
                s0, batcher.stats())

        # A greedy round with pre_resolve off: one stacked dispatch of 64
        # evals over one base, the scan drawing its noise (no K0).
        rows, results, plans, wall, st = counted(
            total, "greedy round, pre_resolve off",
            ("greedy_scan", "expand_overlay"), greedy_off, DRAWN_IN_SCANS)
        check(SCAN_MODES["greedy round, pre_resolve off"]["drawn"] > 0,
              "greedy round, pre_resolve off: the scan read K0's noise")
        placed = sum(len(a) for p in plans for a in p.node_allocation.values())
        conflicted = conflicted_evals(rows, results)
        print(f"greedy round with pre_resolve off: {STORM_BATCH} evals x "
              f"1,024 asks in {wall:.3f} s, {st['dispatches']} "
              f"dispatch(es), sync {st['sync_us'] / 1000:.1f} ms; {placed} "
              f"placed; conflicted evals {conflicted}")
        check_placed("greedy round, pre_resolve off", results, placed,
                     STORM_BATCH * 1024)
        figures.update(greedy_off_wall_s=wall,
                       greedy_off_conflicted=conflicted)

        def parked():
            import threading

            jobs = storm.jobs("parked", STORM_BATCH, storm_job)
            snap = h.state.snapshot()
            s0 = batcher.stats()
            answers, errors = {}, []

            def worker(i):
                try:
                    job, s, m, a, k = storm.build_row(snap, jobs[i],
                                                      90_000 + i)
                    eid = storm_eval_id(job, s)
                    answers[i] = batcher.place(m, a, k, on(job, m),
                                               span=(eid, ""))
                    trace.complete(eid)
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append(e)

            batcher.add_cohort(STORM_BATCH)
            threads = [threading.Thread(target=worker, args=(i,))
                       for i in range(STORM_BATCH)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
            check(not errors, f"parked storm: {errors[:1]}")
            check(len(answers) == STORM_BATCH and all(
                np.shape(c) == (8,) for c, _s in answers.values()),
                "parked storm: a request went unanswered")
            return stats_delta(s0, batcher.stats())

        st = counted(total, "parked storm", ("uniform_topk_seq",), parked,
                     DRAWN_IN_SCANS)
        occupancy = st["batched_requests"] / max(st["dispatches"], 1)
        print(f"parked storm: {STORM_BATCH} place() calls answered in "
              f"{st['dispatches']} dispatch(es), occupancy {occupancy:.1f}")
        check(occupancy > 1, f"parked storm occupancy {occupancy}")
        figures["parked_occupancy"] = occupancy
        # Phase 11 (b): nothing parks in the cohort rounds; the parked
        # storm's threads do, at the batch boundary.
        runq = prof.runq_table()
        check(runq.get("batch_park", {}).get("count", 0) > 0,
              "parked storm: no batch_park run-queue delay recorded")
        convoys = prof.convoy_table()
        check("batcher.place" in convoys["sites"],
              "parked storm: no park at batcher.place")
        runtime.update(parked_runq=runq, parked_convoys={
            k: v for k, v in convoys.items() if k != "recent"})
        figures["runtime"] = runtime

        def stacked():
            # Token-less matrices: the batcher stacks full states, one
            # base per eval (batched_placement_program).
            out = []
            for label, make, pre in (
                    ("config 4 job", storm_job, 60),
                    ("two-group job", lambda i: two_group_job_id(i, 512),
                     61)):
                jobs = storm.jobs(f"stacked{pre}", 4, make)
                snap = h.state.snapshot()
                rows = []
                for i, job in enumerate(jobs):
                    row = storm.build_row(snap, job, pre * 1000 + i)
                    row[2].base_token = row[2].base_delta = None
                    row[2].compact_overlay = None
                    rows.append(row)
                results = batcher.place_cohort([
                    (m, a, k, on(job, m), (storm_eval_id(job, s), ""))
                    for job, s, m, a, k in rows])
                for job, s, _m, _a, _k in rows:
                    trace.complete(storm_eval_id(job, s))
                out.append((label, rows, results))
            return out

        for label, rows, results in counted(
                total, "stacked cohorts",
                ("threefry_uniform", "uniform_topk_stacked",
                 "greedy_scan_stacked"), stacked):
            err = hold_against_cpu(f"stacked {label}", rows, results, on)
            placed = sum(int((c >= 0).sum()) for c, _s in results)
            print(f"stacked cohort of 4 evals, {label}: {placed} asks "
                  f"placed, equal to the CPU batcher's (score error "
                  f"{err:.3g})")
    finally:
        storm.close()
    return figures, h


# The profiled lock sites of the storm path, under the JAX package's
# names (the recorder's three share the trace.recorder. prefix).
RUNTIME_LOCK_SITES = ("scheduler.batcher", "models.matrix.positions",
                      "trace.recorder.stripe", "trace.recorder.hist",
                      "trace.recorder.tail")


def storm_runtime(done, batcher):
    """Phase 11 (b), read after the config 4 storm's rounds: each eval
    carries exactly one device.solve span whose batch is its cohort's
    live count; returns the stage table (stage_stats) of the rounds, the
    lock table of RUNTIME_LOCK_SITES and the GIL sampler's overshoot."""
    from nomad_tpu_torch import profile, trace

    rec, prof = trace.get_recorder(), profile.get_profiler()
    for r, (rows, _res, _plans, _lat, _wall) in enumerate(done):
        check(len(rows) <= batcher.max_batch,
              f"storm round {r}: more rows than one chunk")
        for job, seed, _m, _a, _k in rows:
            tr = rec.trace_for(storm_eval_id(job, seed))
            check(tr is not None, f"storm round {r}: {job.id} untraced")
            solves = [x["annotations"] for x in tr["spans"]
                      if x["name"] == "device.solve"]
            check(len(solves) == 1 and solves[0]["batch"] == len(rows),
                  f"storm round {r}: {job.id} device.solve spans "
                  f"{solves}, cohort of {len(rows)}")
    stages = rec.stage_stats()
    for stage in DENSE_STAGES + ("e2e",):
        check(stages.get(stage, {}).get("count", 0) >= len(done) * len(
            done[0][0]), f"storm stage table lacks {stage}: {stages}")
    locks = prof.lock_table()
    for site in RUNTIME_LOCK_SITES:
        check(site in locks, f"lock site {site} not in the profiler's table")
    gil = prof.gil.stats()
    check(gil["count"] > 0, "the GIL sampler took no sample over the storm")
    return {"storm_stages": stages,
            "storm_locks": {k: locks[k] for k in RUNTIME_LOCK_SITES},
            "storm_gil": gil}


def hold_deltas(torch, label, calls):
    """K4 on a path's own calls, recorded by reference (no copy inside
    the timed window; a cached base is never written, so the recorded
    parent is still the one the call read): each child bit-equal to the
    plain version on the call's inputs, and the four children one
    allocation. Each call is then launched again on copies of its
    inputs, untimed: the child equal to the recorded one, the parent's
    copy unchanged."""
    from nomad_tpu_torch.ops import binpack

    check(calls, f"{label}: no base delta")
    for call in calls:
        want = binpack.apply_base_delta_plain(*call.inputs)
        for x, y in zip(call.out, want):
            check(torch.equal(x, y), f"{label}: K4 differs from the plain "
                  "version")
        check(len({x.untyped_storage().data_ptr() for x in call.out}) == 1,
              f"{label}: K4's children are not one allocation")
        args = cloned(call.inputs)
        again = binpack.apply_base_delta(*args)
        for x, y in zip(again, call.out):
            check(torch.equal(x, y), f"{label}: K4 differs on a copy of "
                  "its inputs")
        for x, y in zip(args[:4], call.inputs[:4]):
            check(torch.equal(x, y), f"{label}: K4 changed its parent")
    print(f"{label}: K4 on its {len(calls)} base deltas (R = "
          f"{sorted({c.inputs[4].shape[0] for c in calls})}): bit-equal to "
          "the plain version, parents unchanged, one allocation each")


def check_placed(label, results, placed, expect):
    """Every ask placed on the card, and every placement made into an
    allocation (exact port offers) on the host."""
    on_card = sum(int((c >= 0).sum()) for c, _s in results)
    check(on_card == expect, f"{label}: {on_card} of {expect} asks placed")
    check(placed == on_card, f"{label}: {on_card} placed on the card, "
          f"{placed} made into allocations")


def device_share(torch, fn, label="storm round (64 evals, pre_resolve on)"):
    """Device busy time of ``fn`` (one storm round by default) under
    torch.profiler: the sum of the card's kernel and copy times over
    the wall time (one stream, so they do not overlap). Prints "not
    measured" when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1000.0
    if busy_ms <= 0.0:
        print(f"profiled {label}: device time not measured (the "
              "profiler recorded no device activity)")
        return dict(profiled_wall_ms=wall_ms)
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiled {label}: device busy "
          f"{busy_ms:.2f} ms of {wall_ms:.1f} ms wall "
          f"({100.0 * busy_ms / wall_ms:.2f}%, idle "
          f"{100.0 - 100.0 * busy_ms / wall_ms:.2f}%); by name: " + ", ".join(
              f"{e.key[:40]} {e.self_device_time_total / 1000.0:.3f} ms "
              f"x{e.count}" for e in top))
    return dict(profiled_wall_ms=wall_ms, profiled_device_ms=busy_ms,
                device_busy_share=busy_ms / wall_ms)


def two_group_job_id(job_id, count):
    job = two_group_job(count)
    job.id = job_id
    return job


# ---------------------------------------------------------------- preemption

PREEMPT_ROOM_NODES = 256   # nodes with room for the high job's ask
PREEMPT_COUNT = 1_024      # the high job's count
PREEMPT_PRIORITY = 70
FILLER_PRIORITIES = (10, 20, 30, 40)


def build_red_cluster(harness, n_nodes, seed):
    """A red cluster: four filler jobs at priorities 10-40 hold five
    allocs on each node, with footprints drawn from ``seed``; only
    PREEMPT_ROOM_NODES nodes keep room for the high job's ask (500 CPU):
    the rest have at most 400 CPU free. Returns the filler jobs."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    rng = random.Random(seed)
    fillers = []
    for prio in FILLER_PRIORITIES:
        job = mock.job()
        job.id = f"filler-p{prio}"
        job.priority = prio
        job.task_groups[0].tasks[0].resources.networks = []
        harness.state.upsert_job(harness.next_index(), job)
        fillers.append(harness.state.job_by_id(job.id))
    room = set(rng.sample(range(n_nodes), PREEMPT_ROOM_NODES))
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = ("dc1", "dc2")[i % 2]
        node.compute_class()
        harness.state.upsert_node(harness.next_index(), node)
        cpus = (300, 350, 400, 450, 500) if i in room else \
            (700, 720, 740, 760, 780)
        allocs = []
        for _ in range(ALLOCS_PER_NODE):
            job = rng.choice(fillers)
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = job.id
            alloc.job = job
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = rng.choice(cpus)
                tr.memory_mb = rng.choice((64, 128))
                tr.networks = []
            alloc.resources = None
            allocs.append(alloc)
        harness.state.upsert_allocs(harness.next_index(), allocs)
    return fillers


def urgent_job():
    """The high-priority job: config 4's task (500 CPU, 256 MB, 50
    Mbit/s, two dynamic ports) under task-group distinct_hosts."""
    job = north_star_job()
    job.id = "urgent"
    job.priority = PREEMPT_PRIORITY
    job.task_groups[0].count = PREEMPT_COUNT
    return job


class Call(NamedTuple):
    """One recorded kernel-wrapper call."""

    inputs: tuple  # the arguments, copied before the call
    after: tuple  # the arguments after it: the final carry
    out: tuple  # the result


def cloned(x):
    """Tensors, alone or in (named) tuples, copied; anything else as
    is."""
    if hasattr(x, "clone"):
        return x.clone()
    if isinstance(x, tuple):
        items = [cloned(i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


class Recorder:
    """Wraps the kernel wrapper ``module.name`` while the block runs and
    keeps each call: its inputs (copied first, as the scans update
    their carry in place), its arguments after the call and its result.
    The smoke holds each kernel against its plain version, and times
    it, on exactly the inputs the scheduler gave it. With ``copy``
    False the inputs are kept by reference (for a wrapper that writes
    none of its arguments, inside a timed window)."""

    def __init__(self, module, name, copy=True):
        self.module, self.name, self.calls = module, name, []
        self.copy = copy

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            inputs = cloned(args) if self.copy else args
            out = self.orig(*args)
            self.calls.append(Call(inputs, args, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_preemption(seed, torch, total):
    """Phase 5 (see the module docstring). Returns K6's recorded call
    and its score error against the plain version, for the timings."""
    from nomad_tpu_torch import migrate
    from nomad_tpu_torch.models.matrix import ClusterMatrix
    from nomad_tpu_torch.ops import preempt
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    t0 = time.perf_counter()
    h = Harness(seed=seed + 5)
    fillers = build_red_cluster(h, N_NODES, seed + 5)
    n_allocs = len(h.state.allocs())
    print(f"red cluster: {N_NODES} nodes, {n_allocs} allocs, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    check(n_allocs == N_NODES * ALLOCS_PER_NODE, "red cluster size")
    job = urgent_job()
    h.state.upsert_job(h.next_index(), job)
    job = h.state.job_by_id(job.id)
    ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)

    # Preemption off: the same eval leaves the surplus unplaced.
    migrate.configure(preemption_enabled=False,
                      pressure_probe=lambda: "red")
    planner = _DryRunPlanner()
    sched = new_scheduler("service-gpu", logging.getLogger("smoke.off"),
                          h.state.snapshot(), planner,
                          rng=random.Random(seed))
    sched.process_eval(ev.copy())
    off = sum(len(a) for p in planner.plans
              for a in p.node_allocation.values())
    unplaced = PREEMPT_COUNT - off
    print(f"preemption off: placed {off}, {unplaced} unplaced")
    check(off == PREEMPT_ROOM_NODES and unplaced == PREEMPT_COUNT - off,
          f"preemption off placed {off}, expected {PREEMPT_ROOM_NODES}")

    # build_victims alone on the same state (a Python loop per node).
    t1 = time.perf_counter()
    _arrays, _lists, n_cands = ClusterMatrix(h.state, job).build_victims(
        PREEMPT_PRIORITY)
    print(f"build_victims host time, {N_NODES} nodes ({n_cands} "
          f"candidates): {(time.perf_counter() - t1) * 1000.0:.1f} ms")

    migrate.configure(preemption_enabled=True,
                      preempt_priority_threshold=50,
                      pressure_probe=lambda: "red")
    snap0 = h.state.snapshot()
    try:
        with Recorder(preempt, "preempt_scan") as rec:
            share = device_share(torch, lambda: counted(
                total, "preemption eval", (
                    "threefry_uniform", "uniform_topk", "preempt_scan"),
                lambda: h.process("service-gpu", ev)),
                "preemption eval (1,024 asks, K6 for the surplus)")
            wall_ms = share.get("profiled_wall_ms", float("nan"))
    finally:
        migrate.configure(preemption_enabled=False,
                          pressure_probe=lambda: "green")
    check(len(rec.calls) == 1, f"{len(rec.calls)} preemption dispatches")
    plan = h.plans[-1]
    placed = [a for allocs in plan.node_allocation.values() for a in allocs]
    victims = {n: list(v) for n, v in plan.node_preemptions.items()}
    n_victims = sum(len(v) for v in victims.values())
    via_k6 = sum(1 for a in placed if a.node_id in victims)
    print(f"preemption eval: placed {len(placed)} of {PREEMPT_COUNT} "
          f"({len(placed) - via_k6} by the main pass, {via_k6} by K6), "
          f"{n_victims} victims on {len(victims)} nodes, {wall_ms:.1f} ms "
          f"(host clock under the profiler, matrix builds and plan "
          f"included)")
    check(len(placed) == PREEMPT_COUNT, "not every ask placed")
    check(len(placed) - via_k6 == PREEMPT_ROOM_NODES,
          f"{len(placed) - via_k6} placed by the main pass")
    check(len({a.node_id for a in placed}) == len(placed),
          "distinct_hosts violated")
    ids = [v.id for vs in victims.values() for v in vs]
    check(len(ids) == len(set(ids)), "a victim staged twice")
    # Each node's victims: below priority 70 and the lowest-priority-
    # first prefix the host oracle picks for that node.
    pre = ClusterMatrix(snap0, job)
    rows = {node.id: i for i, node in enumerate(pre.nodes)}
    ask = [float(x) for x in pre.build_asks([0])[0][0]]
    for node_id, vs in victims.items():
        check(all(migrate.victim_priority(v) < PREEMPT_PRIORITY for v in vs),
              f"node {node_id}: a victim at or above priority 70")
        i = rows[node_id]
        needed = [max(0.0, float(pre.util[i, d]) + ask[d]
                      - float(pre.capacity[i, d])) for d in range(4)]
        live = snap0.allocs_by_node_terminal(node_id, False)
        want = migrate.select_victims_host(live, needed, PREEMPT_PRIORITY)
        check(want is not None and [a.id for a in want] == [v.id for v in vs],
              f"node {node_id}: victims differ from the host oracle")
    for v in ids:
        stored = h.state.alloc_by_id(v)
        check(stored.desired_status == consts.ALLOC_DESIRED_EVICT,
              f"victim {v} not evicted after the commit")
    hit = {v.job_id for vs in victims.values() for v in vs}
    follow = {e.job_id for e in h.create_evals
              if e.triggered_by == consts.EVAL_TRIGGER_PREEMPTION}
    check(hit == follow and hit <= {f.id for f in fillers},
          f"follow-up evals for {sorted(follow)}, victims of {sorted(hit)}")
    print(f"victims match the host oracle on all {len(victims)} nodes; "
          f"follow-up evals for {sorted(follow)}")

    # K6 against its plain version on the scheduler's own call.
    call = rec.calls[0]
    n = call.inputs[0].util.shape[0]
    return call, hold_preempt(
        torch, f"K6 (N={n}, K={call.out[0].shape[0]})", call)


def hold_preempt(torch, label, call):
    """K6's outputs and final carry (five node tensors and the victim
    mask) on a recorded call, against its plain version on the call's
    inputs: choices, victim counts and carry equal, scores within
    SCORE_TOL. Returns the score error."""
    from nomad_tpu_torch.ops import preempt

    st, _vs, vok = call.after[:3]
    want_st, vs, want_vok, asks, noise, prio, penalty = cloned(call.inputs)
    ch_p, sc_p, nv_p = preempt.preempt_scan_plain(
        want_st, vs, want_vok, asks, noise, prio, penalty)
    ch, sc, nv = call.out
    check(torch.equal(ch, ch_p) and torch.equal(nv, nv_p),
          f"{label}: choices or victim counts differ from the plain version")
    err = (sc - sc_p).abs().max().item()
    check(err <= SCORE_TOL, f"{label}: score error {err}")
    for name in CARRY_NAMES:
        check(torch.equal(getattr(st, name), getattr(want_st, name)),
              f"{label}: final {name} differs")
    check(torch.equal(vok, want_vok), f"{label}: consumed slots differ")
    print(f"{label}: {int((ch >= 0).sum())} placed, {int((nv > 0).sum())} "
          f"by eviction; choices, victim counts and the final carry (five "
          f"tensors and the victim mask) equal to the plain version, score "
          f"error {err:.3g}")
    return err


# ---------------------------------------------------------------- gangs

RACK_SIZE = 40  # 250 racks: the rack level pads to g_pad = 256
ICI_SIZE = 16   # 625 groups: the ici level pads to g_pad = 1,024


def topology_meta(node, i):
    node.meta["rack"] = f"rack{i // RACK_SIZE}"
    node.meta["ici"] = f"ici{i // ICI_SIZE}"


def gang_job(job_id, count, dh=False, **gang):
    """Config 4's task (dynamic ports included) as a gang task group."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, Gang, consts

    job = mock.job()
    job.id = job_id
    job.datacenters = ["dc1", "dc2"]
    tg = job.task_groups[0]
    tg.count = count
    tg.gang = Gang(**gang)
    if dh:
        tg.constraints.append(
            Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    return job


GANGS = (  # (label, job id, count, distinct_hosts, gang stanza)
    ("slice rack, K=64", "g-slice", 64, False, dict(slice="rack")),
    ("slice ici, K=64", "g-slice-ici", 64, False, dict(slice="ici")),
    ("spread rack, K=512", "g-spread", 512, False, dict(spread="rack")),
    ("affinity ici, K=128", "g-affinity", 128, False, dict(affinity="ici")),
    ("free + distinct_hosts, K=1024", "g-free", 1024, True, {}),
    ("slice rack + distinct_hosts, K=64 (larger than any rack)",
     "g-reject", 64, True, dict(slice="rack")),
)
# On nodes without topology meta: free, spread and affinity make every
# node its own group (10,000 groups, g_pad 10,240).
BARE_GANGS = (
    ("free, K=512, no meta", "b-free", 512, False, {}),
    ("spread rack, K=512, no meta", "b-spread", 512, False,
     dict(spread="rack")),
    ("affinity rack, K=128, no meta", "b-affinity", 128, False,
     dict(affinity="rack")),
)


def run_gangs(seed, torch, total):
    """Phase 6 (see the module docstring). Returns K7's recorded call
    and its score error against the plain version for each gang, by
    job id, and each gang's recorded ``gang_placement`` call (phase 9
    runs it again over node shards)."""
    from nomad_tpu_torch.ops import gang as ops_gang
    from nomad_tpu_torch.scheduler.testing import Harness

    recorded, placements = {}, {}
    for meta, gangs, what in (
            (topology_meta, GANGS, f"{N_NODES // RACK_SIZE} racks, "
             f"{N_NODES // ICI_SIZE} ici groups"),
            (None, BARE_GANGS, "no topology meta")):
        t0 = time.perf_counter()
        h = Harness(seed=seed + 7)
        build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed + 7, meta=meta)
        print(f"gang cluster: {N_NODES} nodes ({what}), "
              f"{len(h.state.allocs())} allocs, built in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        with Recorder(ops_gang, "gang_scan") as rec, \
                Recorder(ops_gang, "gang_placement") as programs:
            device_share(torch, lambda: counted(
                total, f"gang evals ({what})",
                ("threefry_uniform", "gang_scan"),
                lambda: drive_gangs(h, gangs, rec, recorded)),
                f"gang evals ({len(gangs)}, {what})")
        check(len(programs.calls) == len(gangs),
              f"{len(programs.calls)} gang programs for {len(gangs)} gangs")
        placements.update((g[1], c) for g, c in zip(gangs, programs.calls))
    # K7 against its plain version on each gang's own call.
    return {jid: (recorded[jid], hold_gang(
        torch, f"K7 ({label}, g_pad={recorded[jid].inputs[7].g_pad})",
        recorded[jid])) for label, jid, _k, _dh, _s in GANGS + BARE_GANGS}, \
        placements


def drive_gangs(h, gangs, rec, recorded):
    """Each gang job through ``Harness.process("service-gpu", ...)``,
    checked; its K7 call is kept in ``recorded``."""
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    meta_of = {n.id: n.meta for n in h.state.nodes()}
    for label, jid, k, dh, stanza in gangs:
        job = gang_job(jid, k, dh, **stanza)
        h.state.upsert_job(h.next_index(), job)
        n_plans, n_calls = len(h.plans), len(rec.calls)
        t1 = time.perf_counter()
        h.process("service-gpu", new_eval(h.state.job_by_id(jid),
                                          consts.EVAL_TRIGGER_JOB_REGISTER))
        ms = (time.perf_counter() - t1) * 1000.0
        check(len(rec.calls) == n_calls + 1,
              f"{label}: {len(rec.calls) - n_calls} K7 calls")
        recorded[jid] = rec.calls[-1]
        check_gang(h, label, jid, k, dh, stanza, n_plans, meta_of,
                   recorded[jid], ms)


def check_gang(h, label, jid, k, dh, stanza, n_plans, meta_of, call, ms):
    """A gang is all K or none; a slice lies in the tightest covering
    group; the spread cap holds; distinct_hosts holds; the plan's gang
    leg names every member; a rejected gang records one failure with
    K-1 coalesced. A node without the level's meta is its own group."""
    from nomad_tpu_torch.gang import gang_key
    from nomad_tpu_torch.ops import gang as ops_gang

    live = [a for a in h.state.allocs_by_job(jid) if not a.terminal_status()]
    state, ask, abw, aports = (
        type(x)(*(f.cpu() for f in x)) if isinstance(x, tuple) else x.cpu()
        for x in call.inputs[:4])
    config = call.inputs[7]
    slice_group = int(call.out[2])
    # The program's own group capacities, from the same inputs.
    units = ops_gang.member_units_plain(state, ask, abw, aports, config)
    caps = ops_gang.group_capacity_plain(units, state.topo_ids, config.g_pad)
    if jid == "g-reject":
        check(live == [] and len(h.plans) == n_plans,
              f"{label}: a rejected gang staged allocs")
        failed = h.evals[-1].failed_tg_allocs or {}
        check(len(failed) == 1, f"{label}: {len(failed)} failures recorded")
        (m,) = failed.values()
        check(m.coalesced_failures == k - 1,
              f"{label}: {m.coalesced_failures} coalesced, expected {k - 1}")
        check(float(caps.max()) < k, f"{label}: a rack covers the gang")
        print(f"gang {label}: rejected whole, one failure, {k - 1} "
              f"coalesced, {ms:.1f} ms (host clock under the profiler)")
        return
    check(len(live) == k, f"{label}: {len(live)} of {k} members live")
    plan = h.plans[-1]
    members = plan.gang_groups.get(gang_key(jid, "web"), [])
    check(sorted(members) == sorted(a.id for a in live),
          f"{label}: the plan's gang leg does not list every member")
    level = next(iter(stanza.values()), "rack")
    groups = [meta_of[a.node_id].get(level) or a.node_id for a in live]
    most = max(groups.count(g) for g in set(groups))
    if dh:
        check(len({a.node_id for a in live}) == k,
              f"{label}: distinct_hosts violated")
    if stanza.get("slice"):
        check(len(set(groups)) == 1, f"{label}: members in "
              f"{len(set(groups))} {level} groups")
        tightest = float(caps[caps >= float(k)].min())
        check(slice_group >= 0 and float(caps[slice_group]) == tightest,
              f"{label}: group capacity {float(caps[slice_group])}, the "
              f"tightest covering one has {tightest}")
        detail = f"one {level} group, capacity {tightest:.0f} (the tightest " \
                 "cover)"
    elif stanza.get("spread"):
        eligible = max(int((caps >= 1.0).sum()), 1)
        cap = -(-k // eligible)
        check(most <= cap, f"{label}: {most} members in one group, cap {cap}")
        detail = f"at most {most} a group (cap {cap} over {eligible} groups)"
    else:
        detail = (f"{len(set(groups))} {level} group(s), at most {most} a "
                  f"group, on {len({a.node_id for a in live})} nodes")
    print(f"gang {label}: all {k} placed, {detail}, {ms:.1f} ms (host "
          "clock under the profiler)")


def hold_gang(torch, label, call):
    """K7's outputs and final carry (util, bw_used, ports_free, placed,
    group members) on a recorded call, against its plain version on the
    call's inputs: all equal but the scores, which agree within
    SCORE_TOL. Returns the score error."""
    from nomad_tpu_torch.ops import gang as ops_gang

    inputs = cloned(call.inputs)
    ch_p, sc_p, sg_p = ops_gang.gang_scan_plain(*inputs)
    ch, sc, sg = call.out
    check(torch.equal(ch, ch_p) and int(sg) == int(sg_p),
          f"{label}: choices or slice group differ from the plain version")
    err = (sc - sc_p).abs().max().item()
    check(err <= SCORE_TOL, f"{label}: score error {err}")
    st, st_p = call.after[0], inputs[0]
    for name in ("util", "bw_used", "ports_free"):
        check(torch.equal(getattr(st, name), getattr(st_p, name)),
              f"{label}: final {name} differs")
    check(torch.equal(call.after[8], inputs[8])
          and torch.equal(call.after[9], inputs[9]),
          f"{label}: placed or group members differ")
    print(f"{label}: {int((ch >= 0).sum())} placed; choices, slice group "
          f"and the final carry equal to the plain version, score error "
          f"{err:.3g}")
    return err


def bench_legs(torch, k6, gangs):
    """K6 and K7 timed on the phases' own recorded calls: K6 at K =
    1,024 (the preemption eval) and K = 8 (its first eight asks), K7 on
    the free gang (K = 1,024, g_pad = 256), the ici slice (K = 64,
    g_pad = 1,024) and the spread without meta (K = 512, g_pad =
    10,240)."""
    from nomad_tpu_torch.ops import gang as ops_gang
    from nomad_tpu_torch.ops import preempt

    dev = torch.device("cuda")
    out = {}
    # ---- K6
    st0, vs, vok0, asks0, noise0, prio, penalty = k6[0].inputs
    n, g = st0.feasible.shape
    v = preempt.PREEMPT_MAX_VICTIMS
    for k in (noise0.shape[0], 8):
        if k == noise0.shape[0]:
            call, err = k6
        else:  # the first k asks: a call of its own, held like the path's
            asks = type(asks0)(*(x[:k].contiguous() for x in asks0[:5]),
                               *asks0[5:])
            inputs = (st0, vs, vok0, asks, noise0[:k].contiguous(), prio,
                      penalty)
            args = cloned(inputs)
            call = Call(inputs, args, preempt.preempt_scan(*args))
            err = hold_preempt(torch, f"K6 (N={n}, K={k})", call)
        box = {}
        ms = time_cuda(torch, lambda: preempt.preempt_scan(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(call.inputs)))
        plain_runs = 1 if k > 8 else 3
        plain_ms = time_cuda(
            torch, lambda: preempt.preempt_scan_plain(*box["a"]), plain_runs,
            warmup=1, setup=lambda: box.update(a=cloned(call.inputs)))
        chain = chain_ms(torch, k, dev)
        fig = preempt_figures(torch, f"K6 (N={n}, K={k})", call, ms)
        ch = call.out[0]
        rows = torch.unique(ch[ch >= 0]).numel()
        slots = int((vs.ok & ~call.after[2]).sum())
        # Node rows, the carry and feasible, and every victim slot read
        # once; the asks, the noise and the three outputs; the chosen
        # rows (carry and one tg_count cell) and consumed slots written.
        bytes_ = (n * (NODE_BYTES + CARRY_ROW_BYTES + 5 * g)
                  + n * v * (16 + 4 + 4 + 4 + 1) + k * (ASK_BYTES + 12)
                  + 1 + g + k * n * 4 + rows * (CARRY_ROW_BYTES + 4) + slots)
        flops = k * n * (60 + v * 14)  # score + one walk over the slots
        out.setdefault("preempt_scan", {})[k] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_runs=plain_runs,
            **bound(bytes_, max(flops / FP32_FLOPS, min(
                chain, fig["cluster_chain_ms"]) / 1000.0)),
            library_ms=None, chain_ms=chain, **fig)
        torch.cuda.empty_cache()
    # ---- K7
    for jid in ("g-free", "g-slice-ici", "b-spread"):
        call, err = gangs[jid]
        st, _a, _b, _c, active, _nz, _gnz, cfg = call.inputs[:8]
        n, k = st.util.shape[0], active.shape[0]
        box = {}
        ms = time_cuda(torch, lambda: ops_gang.gang_scan(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(call.inputs)))
        plain_runs = 1 if k > 64 else 3
        plain_ms = time_cuda(
            torch, lambda: ops_gang.gang_scan_plain(*box["a"]), plain_runs,
            warmup=1, setup=lambda: box.update(a=cloned(call.inputs)))
        chain = chain_ms(torch, k, dev)
        fig = gang_figures(torch, f"K7 {jid}", call, ms)
        ch = call.out[0]
        rows = torch.unique(ch[ch >= 0]).numel()
        # The gang state read once (73 B a node), the ask and member
        # mask, both noises, the outputs; the chosen rows (util,
        # bw_used, ports_free, placed) and the group counts written.
        bytes_ = (n * 73 + 24 + k + k * n * 4 + cfg.g_pad * 8 + k * 8 + 4
                  + rows * 28)
        flops = k * n * 60 + n * 20
        print(f"gang_scan timed on {jid} (K={k}, g_pad={cfg.g_pad}, "
              f"{cfg.mode})")
        out.setdefault("gang_scan", {})[(k, cfg.g_pad)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_runs=plain_runs,
            **bound(bytes_, max(flops / FP32_FLOPS, min(
                chain, fig["cluster_chain_ms"]) / 1000.0)),
            library_ms=None, chain_ms=chain, **fig)
        torch.cuda.empty_cache()
    return out


def preempt_figures(torch, label, call, ms):
    """A K6 record's design figures, as K7's (gang_figures): the plan's
    cluster (CTAs, threads, resident or streamed, the noise staged, the
    score cache), the launches of one call (counted around it, held to
    one), the cluster chain term at the plan's shape, the call's host
    span and profiler device time, ``launch_ms`` and ``launch_host_ms``:
    the call less its argument checks and plan lookup
    (``scan.launch_preempt`` alone), and ``uncached_ms``: the same call
    with the score cache off, every step rescoring every node and
    walking the victim slots of every node that does not fit (what
    asks that differ at every step cost), held against the plain
    version."""
    import numpy as np

    from nomad_tpu_torch.ops import preempt, scan

    st, _vs, _vok, asks, _nz, prio, penalty = call.inputs
    dev = st.capacity.device
    (n, g), k = st.feasible.shape, asks.resources.shape[0]
    plan = scan.preempt_plan_for(dev, n, g)
    box = {}
    setup = lambda: box.update(a=cloned(call.inputs))  # noqa: E731
    setup()
    _out, launches = launches_of(
        "preempt_scan", lambda: preempt.preempt_scan(*box["a"]))
    check(launches == 1, f"{label}: {launches} launches a call")
    off = plan._replace(cache=False, smem=scan.preempt_layout(
        plan.ctas, plan.threads // 32, plan.slice, g, plan.resident,
        plan.stage_noise, False)[1])

    def uncached():
        a = box["a"]
        return scan.launch_preempt(off, *a[:5], float(np.float32(prio)),
                                   penalty)

    def launch_only():  # the call less its checks and plan lookup
        a = box["a"]
        return scan.launch_preempt(plan, *a[:5], float(np.float32(prio)),
                                   penalty)

    setup()
    hold_preempt(torch, f"{label}, cache off",
                 Call(call.inputs, box["a"], uncached()))
    fig = dict(ctas=plan.ctas, threads=plan.threads, form=plan.form,
               cache=plan.cache, stage_noise=plan.stage_noise,
               launches_per_call=launches,
               cluster_chain_ms=cluster_chain_ms(torch, k, plan.ctas,
                                                 plan.threads, dev),
               uncached_ms=time_cuda(torch, uncached, RUNS, setup=setup),
               launch_ms=time_cuda(torch, launch_only, RUNS, setup=setup),
               host_ms=host_ms(torch, lambda: preempt.preempt_scan(
                   *box["a"]), RUNS),
               launch_host_ms=host_ms(torch, launch_only, RUNS),
               device_ms=device_ms(torch, lambda: preempt.preempt_scan(
                   *box["a"]), RUNS, setup=setup, match="preempt_cluster"))
    print(f"{label}: {plan.ctas} CTAs x {plan.threads} threads, "
          f"{plan.form}, {launches} launch a call, {ms:.4f} ms, device "
          f"{fig['device_ms']} ms, host span {fig['host_ms']:.4f} ms; the "
          f"launch alone {fig['launch_ms']:.4f} ms (host span "
          f"{fig['launch_host_ms']:.4f}); cache off "
          f"{fig['uncached_ms']:.4f} ms (equal to the plain version); "
          f"cluster chain {fig['cluster_chain_ms']:.4f} ms")
    return fig


def gang_figures(torch, label, call, ms):
    """A K7 record's design figures: the plan's cluster (CTAs, threads,
    resident or streamed, the group counts in shared or global memory,
    the score cache, the noise staged), the launches of one call
    (counted around it, held to one), the cluster chain term at the
    plan's shape, the call's host span and profiler device time, and
    ``uncached_ms``: the same call with the score cache off, every step
    rescoring every node (what asks that differ at every step cost K1
    and K8b; a gang's members are one ask, so the cache serves every
    step but the first), held against the plain version."""
    from nomad_tpu_torch.ops import gang as ops_gang
    from nomad_tpu_torch.ops import scan

    st, active, cfg = call.inputs[0], call.inputs[4], call.inputs[7]
    dev = st.capacity.device
    n, k = st.util.shape[0], active.shape[0]
    mode = ops_gang._MODE_IDS[cfg.mode]
    plan = scan.gang_plan_for(dev, n, cfg.g_pad, mode)
    box = {}
    setup = lambda: box.update(a=cloned(call.inputs))  # noqa: E731
    setup()
    _out, launches = launches_of(
        "gang_scan", lambda: ops_gang.gang_scan(*box["a"]))
    check(launches == 1, f"{label}: {launches} launches a call")
    off = plan._replace(cache=False, smem=scan.gang_layout(
        plan.ctas, plan.threads // 32, plan.slice, cfg.g_pad, plan.resident,
        plan.stage_noise, False, plan.groups, scan.sums_groups(mode))[1])

    def uncached():
        a = box["a"]
        return scan.launch_gang(off, *a[:7], mode, cfg.distinct_hosts,
                                cfg.anti_affinity_penalty, a[8], a[9])

    setup()
    hold_gang(torch, f"{label}, cache off",
              Call(call.inputs, box["a"], uncached()))
    fig = dict(ctas=plan.ctas, threads=plan.threads, form=plan.form,
               groups="shared" if plan.groups else "global",
               cache=plan.cache, stage_noise=plan.stage_noise,
               launches_per_call=launches,
               cluster_chain_ms=cluster_chain_ms(torch, k, plan.ctas,
                                                 plan.threads, dev),
               uncached_ms=time_cuda(torch, uncached, RUNS, setup=setup),
               host_ms=host_ms(torch, lambda: ops_gang.gang_scan(
                   *box["a"]), RUNS),
               device_ms=device_ms(torch, lambda: ops_gang.gang_scan(
                   *box["a"]), RUNS, setup=setup, match="gang_cluster"))
    print(f"{label} (K={k}, g_pad={cfg.g_pad}, {cfg.mode}): {plan.ctas} "
          f"CTAs x {plan.threads} threads, {plan.form}, group counts "
          f"{fig['groups']}, {launches} launch a call, {ms:.4f} ms, device "
          f"{fig['device_ms']} ms, host span {fig['host_ms']:.4f} ms; cache "
          f"off {fig['uncached_ms']:.4f} ms (equal to the plain version); "
          f"cluster chain {fig['cluster_chain_ms']:.4f} ms")
    return fig


# ---------------------------------------------------------------- kernels


def time_cuda(torch, fn, runs, setup=None, warmup=2):
    """Median CUDA-event ms of ``fn`` over ``runs`` runs after warm-up;
    ``setup`` (not timed) runs before each."""
    for _ in range(warmup):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        if setup:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, runs):
    """Median host span of ``fn()`` in ms, the card synchronised before
    each call (no queue of earlier work delays the launch): the host's
    issue of a call, against its device time (device_ms)."""
    for _ in range(3):
        fn()
    spans = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        spans.append((time.perf_counter() - t0) * 1000.0)
    torch.cuda.synchronize()
    return statistics.median(spans)


def device_ms(torch, fn, runs, setup=None, match=None):
    """Device time of ``fn`` a call under torch.profiler: the card's
    kernel time (kernels whose name holds ``match``; every kernel when
    None) summed over ``runs`` calls, over ``runs``. The call's
    CUDA-event time (time_cuda) also holds the host's issue of the
    launch; this is the kernels alone. None when the profiler records
    no device activity."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        if setup:
            setup()
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if setup:
                setup()
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0
                and (match is None or match in e.key))
    return total / 1000.0 / runs if total > 0 else None


def kernel_inputs(torch, np, n, k, g, b, seed, device):
    """A seeded state of the north-star widths, as tensors. Free ports
    (0 to 6 a node, against asks of 2) and distinct_hosts on task group
    0 (and on the whole job in every fourth eval) limit where the asks
    fit, so a wrong update of ports_free, job_count or tg_count changes
    the choices after it."""
    from nomad_tpu_torch.ops import binpack

    rng = np.random.default_rng(seed)
    cap = np.tile(np.array([[4000, 8192, 102400, 150]], np.float32), (n, 1))
    sched = cap - np.array([[100, 256, 4096, 0]], np.float32)
    util = (cap - sched) + np.stack(
        [rng.integers(0, 20, n) * 50, rng.integers(0, 20, n) * 64,
         np.zeros(n), np.zeros(n)], 1).astype(np.float32)
    ok = rng.random(n) < 0.98
    ok[N_NODES:] = False  # the bucket's padding rows
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    base = dict(
        capacity=t(cap), sched_capacity=t(sched), util=t(util),
        bw_avail=t(np.full(n, 1000, np.float32)),
        bw_used=t(rng.integers(0, 10, n).astype(np.float32) * 50),
        ports_free=t(rng.integers(0, 7, n).astype(np.float32)),
        node_ok=t(ok))
    job_count = t(rng.integers(0, 2, (b, n)).astype(np.int32))
    tg_count = t(rng.integers(0, 2, (b, n, g)).astype(np.int32))
    feasible = t(rng.random((b, n, g)) < 0.9)
    res = np.array([500, 256, 300, 0], np.float32)
    asks = binpack.Asks(
        resources=t(np.tile(res, (b, k, 1))),
        bw=t(np.full((b, k), 50, np.float32)),
        ports=t(np.full((b, k), 2, np.float32)),
        tg_index=t(rng.integers(0, g, (b, k)).astype(np.int32)),
        active=t(np.ones((b, k), bool)),
        job_distinct_hosts=t(np.arange(b) % 4 == 3),
        tg_distinct_hosts=t(np.tile(np.arange(g) == 0, (b, 1))))
    uniform = asks._replace(
        tg_index=t(np.zeros((b, k), np.int32)),
        job_distinct_hosts=t(np.zeros(b, bool)),
        tg_distinct_hosts=t(np.ones((b, g), bool)))
    keys = t(rng.integers(0, 2**32, (b, 2), dtype=np.uint64)
             .astype(np.int64))
    return base, job_count, tg_count, feasible, asks, uniform, keys


CARRY_NAMES = ("util", "bw_used", "ports_free", "job_count", "tg_count")


def new_carry(torch, base, jc, tgc):
    """Per-eval copies of the shared base, as the batcher makes them."""
    b, n = jc.shape
    util = base["util"].expand(b, n, 4)
    bw, ports = (base[x].expand(b, n) for x in ("bw_used", "ports_free"))
    return tuple(x.clone(memory_format=torch.contiguous_format)
                 for x in (util, bw, ports, jc, tgc))


def check_scan(torch, label, kernel, plain, bits=False):
    """A scan kernel's (choices, scores, carry) against its plain
    version's: choices and all five carried tensors equal, scores
    within SCORE_TOL, or with ``bits`` bit for bit (a scan that draws
    its own noise, against the plain draw and the plain scan). Returns
    the score error."""
    (ch, sc, c_k), (ch_p, sc_p, c_p) = kernel, plain
    check(torch.equal(ch, ch_p), f"{label}: choices differ")
    err = (sc - sc_p).abs().max().item()
    check(err <= SCORE_TOL, f"{label}: score error {err}")
    check(not bits or torch.equal(sc.view(torch.int32),
                                  sc_p.view(torch.int32)),
          f"{label}: scores not bit-equal to the plain version's")
    for name, x, y in zip(CARRY_NAMES, c_k, c_p):
        check(torch.equal(x, y), f"{label}: final {name} differs")
    return err


def rows_written(torch, choices, tg_index, n, g):
    """Distinct (eval, node) rows and (eval, node, task group) cells
    the placed asks update: what a scan must write back."""
    b, k = choices.shape
    valid = choices >= 0
    ev = torch.arange(b, device=choices.device).unsqueeze(1).expand(b, k)
    row = ev[valid].long() * n + choices[valid].long()
    cells = row * g + tg_index[valid].long()
    return torch.unique(row).numel(), torch.unique(cells).numel()


def chain_ms(torch, k, dev):
    """Median CUDA-event ms of k rounds of the greedy scan's block-wide
    argmax alone (csrc/greedy_scan.cu nt_argmax_chain): the dependent
    chain under K1's k steps, whatever its bytes and operations."""
    from nomad_tpu_torch.ops import cuda

    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = cuda.stream_ptr(dev)
    return time_cuda(torch, lambda: cuda.launch(
        "nt_argmax_chain", k, out.data_ptr(), stream), RUNS)


def cluster_chain_ms(torch, k, ctas, threads, dev):
    """Median CUDA-event ms of k rounds of the cluster scan's exchange
    alone (csrc/greedy_scan.cu nt_argmax_chain_cluster: a warp and a
    block reduction, the CTA's key sent to every CTA and the wait for
    the cluster's keys, a round) on ``ctas`` CTAs of ``threads``: the
    chain under the cluster design's k steps."""
    from nomad_tpu_torch.ops import cuda

    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = cuda.stream_ptr(dev)
    return time_cuda(torch, lambda: cuda.launch(
        "nt_argmax_chain_cluster", k, ctas, threads, out.data_ptr(), stream),
        RUNS)


def alike_steps(torch, asks):
    """(steps, alike, active, active and alike) of a call's asks: a
    step is alike when its ask has the last step's resources, bandwidth
    and ports in the same eval, the steps whose scores before the noise
    the kernel's cache keeps (csrc/greedy_scan.cu)."""
    r, bw, p = asks.resources, asks.bw, asks.ports
    same = torch.zeros_like(asks.active)
    same[:, 1:] = ((r[:, 1:] == r[:, :-1]).all(-1) & (bw[:, 1:] == bw[:, :-1])
                   & (p[:, 1:] == p[:, :-1]))
    act = asks.active
    return (act.numel(), int(same.sum().item()), int(act.sum().item()),
            int((same & act).sum().item()))


class AlikeAsks:
    """Within the block, every greedy scan's ``alike_steps`` summed
    (``binpack.greedy_scan`` wrapped; the batcher calls it by name)."""

    def __init__(self, torch):
        self.torch = torch
        self.counts = [0, 0, 0, 0]

    def __enter__(self):
        from nomad_tpu_torch.ops import binpack

        self.inner = binpack.greedy_scan

        def counted(*args, **kw):
            asks = args[6] if len(args) > 6 else kw["asks"]
            for i, x in enumerate(alike_steps(self.torch, asks)):
                self.counts[i] += x
            return self.inner(*args, **kw)

        binpack.greedy_scan = counted
        return self

    def __exit__(self, *exc):
        from nomad_tpu_torch.ops import binpack

        binpack.greedy_scan = self.inner

    def figures(self):
        steps, alike, active, both = self.counts
        return dict(steps=steps, alike_share=alike / max(steps, 1),
                    active_alike_share=both / max(active, 1))


def varied_asks(torch, asks, seed):
    """``asks`` with each step its own resources, bandwidth and ports
    (CPU 100-1,000 by the step, so no two steps in a row are alike;
    memory, bandwidth and ports drawn as the card tests' scan_inputs
    draws them): a call the score cache never serves."""
    b, k = asks.bw.shape
    gen = torch.Generator().manual_seed(seed)
    step = torch.arange(k)
    res = torch.stack([(100.0 * (1 + step % 10)).expand(b, k),
                       128.0 * torch.randint(1, 5, (b, k), generator=gen),
                       torch.full((b, k), 300.0), torch.zeros(b, k)], 2)
    dev = asks.bw.device
    return asks._replace(
        resources=res.to(dev).contiguous(),
        bw=(50.0 * torch.randint(0, 3, (b, k), generator=gen)).to(dev),
        ports=torch.randint(1, 3, (b, k), generator=gen).float().to(dev))


def greedy_figures(torch, name, seq, static, feas, asks, draw, fresh, box,
                   ms):
    """A greedy scan record's design figures: the plan's cluster,
    threads, form, waves and whether it keeps the score cache, the
    launches of one call (counted around it, held to one), the cluster
    chain term at the plan's shape, the share of the asks' steps that
    are alike (``alike_steps``), and ``varied_ms``: the call on
    ``varied_asks``, held against the plain version."""
    from nomad_tpu_torch.ops import binpack, scan

    dev = feas.device
    b, n, g = feas.shape
    k = asks.resources.shape[1]
    plan = scan.plan_for(dev, b, n, g, seq)
    call = lambda a=asks: binpack.greedy_scan(  # noqa: E731
        *static, box["c"], feas, a, draw, 10.0, seq)
    _out, launches = launches_of(name, lambda: (fresh(), call()))
    check(launches == 1, f"{name} (B={b}): {launches} launches a call")
    steps = (b if seq else 1) * k
    varied = varied_asks(torch, asks, 7 + b)
    fresh()
    got = (*call(varied), box["c"])
    fresh()
    want = (*binpack.greedy_scan_plain(*static, box["c"], feas, varied,
                                       draw.noise((k, n)), 10.0, seq),
            box["c"])
    check_scan(torch, f"{name} (B={b}, varied asks)", got, want, bits=True)
    total, alike, _active, _both = alike_steps(torch, asks)
    fig = dict(ctas=plan.ctas, threads=plan.threads, form=plan.form,
               waves=plan.waves, cache=plan.cache, drawn=plan.drawn,
               stage_noise=plan.stage_noise,
               launches_per_call=launches,
               cluster_chain_ms=cluster_chain_ms(torch, steps, plan.ctas,
                                                 plan.threads, dev),
               alike_share=alike / total,
               varied_ms=time_cuda(torch, lambda: call(varied), RUNS,
                                   setup=fresh),
               varied_alike_share=alike_steps(torch, varied)[1] / total)
    print(f"{name} B={b} K={k}: {plan.ctas} CTAs x {plan.threads} threads "
          f"a cluster, {plan.form}, noise "
          f"{'drawn' if plan.drawn else 'read'}, cache {plan.cache}, "
          f"{plan.waves} "
          f"wave(s), {launches} launch a call, {ms:.4f} ms ({alike} of "
          f"{total} steps alike); varied asks {fig['varied_ms']:.4f} ms "
          f"(0 alike), choices and carry equal the plain version's; chain "
          f"terms: cluster {fig['cluster_chain_ms']:.4f} ms")
    return fig


# SASS opcodes by the pipe that executes them on sm_90 (one SM: four
# schedulers, each issuing one warp instruction a clock, 128 thread
# instructions; the integer ALU pipe 16 lanes a scheduler, 64; IMAD on
# the FMA pipe's 16-lane half, 64; FFMA, FADD and FMUL on both halves,
# 128). Anything else (memory, uniform datapath, control) takes an issue
# slot only.
SASS_FMA_INT = ("IMAD",)
SASS_FMA_FP = ("FFMA", "FADD", "FMUL")
SASS_ALU = ("IADD3", "LOP3", "SHF", "ISETP", "FSETP", "SEL", "FSEL", "LEA",
            "PRMT", "MOV", "IMNMX", "FMNMX", "SHL", "SHR", "IABS", "VIADD",
            "VIMNMX", "I2FP", "F2I", "POPC", "FLO", "BMSK", "PLOP3")
SMS = 132


def sass_clock_hz():
    """The card's highest SM clock (``nvidia-smi clocks.max.sm``), the
    clock its peak rates assume."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=30).stdout.split()
    return float(out[0]) * 1e6


@functools.lru_cache(maxsize=1)
def k0_sass():
    """K0's instructions an element from its compiled SASS
    (``cuobjdump -sass`` of the built library): the basic block of
    nt_threefry_uniform_kernel that ends in its 16-byte store holds four
    elements' hashes; its instructions by pipe over 4. The bound is the
    SM clocks an element at the issue rate (128 thread instructions a
    clock): the least these instructions take whichever pipes they go
    to. Beside it, the clocks that the busiest of issue, ALU pipe and
    FMA pipe takes as compiled (``SASS_*``: the integer adds the
    compiler left on the ALU pipe could issue as IMAD on the FMA pipe's
    half)."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from nomad_tpu_torch.ops import cuda

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    dump = subprocess.run([tool, "-sass", cuda.build_info["path"]],
                          capture_output=True, text=True, timeout=300).stdout
    blocks, cur, inside = [], [], False
    for line in dump.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            if inside:
                break
            inside = "nt_threefry_uniform_kernel" in s
            continue
        if not inside:
            continue
        if s.startswith(".L_"):
            if cur:
                blocks.append(cur)
            cur = []
            continue
        m = re.match(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", s)
        if not m:
            continue
        ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(1))
        cur.append(ins)
        if ins.split()[0].split(".")[0] in ("BRA", "EXIT", "RET", "BRX"):
            blocks.append(cur)
            cur = []
    if cur:
        blocks.append(cur)
    body = [b for b in blocks if any(i.startswith("STG.E.128") for i in b)]
    check(len(body) == 1, f"K0's SASS: {len(body)} blocks hold its 16-byte "
          "store")
    ops = [i.split()[0].split(".")[0] for i in body[0]]
    per = dict(
        total=len(ops) / 4.0,
        alu=sum(o in SASS_ALU for o in ops) / 4.0,
        imad=sum(o in SASS_FMA_INT for o in ops) / 4.0,
        ffma=sum(o in SASS_FMA_FP for o in ops) / 4.0)
    clock = sass_clock_hz()
    issue = per["total"] / 128.0
    pipes = max(issue, per["alu"] / 64.0, per["imad"] / 64.0,
                per["ffma"] / 128.0)
    return dict(instructions_per_element=per, sm_clock_hz=clock,
                sm_cycles_per_element=issue,
                pipe_cycles_per_element=pipes,
                seconds_per_element=issue / (SMS * clock),
                pipe_seconds_per_element=pipes / (SMS * clock))


def k0_record(torch, keys, shape, window, sass):
    """K0 on one draw: bit-equal to the plain version, its time, the
    plain version's, and the bound from its SASS (at the issue rate;
    ``pipe_bound_ms`` at the busiest pipe as compiled)."""
    from nomad_tpu_torch.ops import prng

    got = prng.threefry_uniform(keys, shape, 0.0, 2.0, window=window)
    plain = prng.threefry_uniform_plain(keys, shape, 0.0, 2.0,
                                        window=window)
    check(torch.equal(got.view(torch.int32), plain.view(torch.int32)),
          f"K0 bits differ from the plain version ({keys.shape[0]} x "
          f"{shape}, window {window})")
    elems = got.numel()
    ms = time_cuda(torch, lambda: prng.threefry_uniform(
        keys, shape, 0.0, 2.0, window=window), RUNS)
    plain_ms = time_cuda(torch, lambda: prng.threefry_uniform_plain(
        keys, shape, 0.0, 2.0, window=window), 3, warmup=1)
    del got, plain
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                **bound(elems * 4 + keys.numel() * 8,
                        elems * sass["seconds_per_element"]),
                library_ms=None, elements=elems,
                pipe_bound_ms=elems * sass["pipe_seconds_per_element"]
                * 1000.0)


def peak_dispatch_bytes(torch, fn):
    """Device memory a dispatch ``fn`` allocates at its peak, over what
    was allocated before it (torch.cuda.max_memory_allocated)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del out
    return peak


def bench_kernels(torch, np, seed):
    from nomad_tpu_torch.ops import binpack, prng, scan

    dev = torch.device("cuda")
    n, k, g = BENCH_N, BENCH_K, 2
    chain = chain_ms(torch, k, dev)
    print(f"argmax chain alone, {k} rounds: {chain:.4f} ms")
    sass = k0_sass()
    print(f"K0's SASS: {json.dumps(sass, sort_keys=True)}")
    out = {}
    for b in (1, 64):
        base, jc, tgc, feas, asks, uasks, keys = kernel_inputs(
            torch, np, n, k, g, b, seed + b, dev)
        static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
                  base["node_ok"])
        draw = prng.Draw(keys, 2.0)
        # ---- K0: K1's [K, N] draw (a separate launch where K1 reads it)
        rec = k0_record(torch, keys, (k, n), None, sass)
        print(f"K0 B={b} {(k, n)}: {rec['ms']:.4f} ms against a bound of "
              f"{rec['bound_ms']:.4f} ms at the issue rate "
              f"({rec['ms'] / rec['bound_ms']:.2f}x), "
              f"{rec['pipe_bound_ms']:.4f} ms at the busiest pipe as "
              f"compiled ({rec['ms'] / rec['pipe_bound_ms']:.2f}x)")
        k0_scan_ms = rec["ms"]
        rec["sass"] = sass
        out.setdefault("threefry_uniform", {})[b] = rec
        # ---- K1: its noise drawn in the kernel or read from K0's (the
        # plan's choice), a call either way
        c_k, c_p = (new_carry(torch, base, jc, tgc) for _ in range(2))
        ch, sc = binpack.greedy_scan(*static, c_k, feas, asks, draw, 10.0)
        noise = draw.noise((k, n))
        err = check_scan(torch, f"K1 (B={b})", (ch, sc, c_k), (
            *binpack.greedy_scan_plain(*static, c_p, feas, asks, noise,
                                       10.0), c_p), bits=True)
        full = ((base["ports_free"] >= 2) & (c_k[2] < 2)).sum().item()
        check(full > 0, f"K1 (B={b}): no node filled to its port limit")
        drawn = scan.plan_for(dev, b, n, g, False).drawn
        print(f"greedy_scan B={b} (noise {'drawn' if drawn else 'read'}): "
              f"{(ch >= 0).sum().item()} of {b * k} asks placed, {full} "
              "rows filled to their port limit; choices, all five carried "
              "tensors and the scores' bits match the plain draw and scan")
        rows, cells = rows_written(torch, ch, asks.tg_index, n, g)
        box = {}
        fresh = lambda: box.__setitem__("c", new_carry(torch, base, jc, tgc))
        ms = time_cuda(torch, lambda: binpack.greedy_scan(
            *static, box["c"], feas, asks, draw, 10.0), RUNS, setup=fresh)
        plain_ms = time_cuda(torch, lambda: binpack.greedy_scan_plain(
            *static, box["c"], feas, asks, noise, 10.0), SLOW_PLAIN_RUNS,
            warmup=0, setup=fresh)
        del noise
        fig = greedy_figures(torch, "greedy_scan", False, static, feas, asks,
                             draw, fresh, box, ms)
        fig["plain_runs"] = SLOW_PLAIN_RUNS
        # Node rows, the carry and feasible read once, every ask and its
        # two outputs, the distinct_hosts flags, the keys, and the chosen
        # rows written back once; the draw's instructions (K0's, an
        # element) beside the scoring's: the same function either way.
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * 16
                  + rows * CARRY_ROW_BYTES + cells * 4)
        flops = b * k * n * 60  # mask + BestFit-v3 (2 pow) + argmax
        draw_s = b * k * n * sass["seconds_per_element"]
        extra = {}
        if b == 64:
            # Peak device memory of the greedy dispatch (fresh carry +
            # scan), and of the parent's form of it, which drew the
            # [B, K, N] noise with K0 first and kept it for the scan.
            def dispatch(parent):
                carry = binpack.fresh_carry(
                    base["util"], base["bw_used"], base["ports_free"], jc,
                    tgc, b, False)
                kept = (prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
                        if parent else None)
                return (binpack.greedy_scan(*static, carry, feas, asks, draw,
                                            10.0), kept)

            extra = dict(peak_bytes=peak_dispatch_bytes(
                torch, lambda: dispatch(False)),
                parent_form_peak_bytes=peak_dispatch_bytes(
                    torch, lambda: dispatch(True)))
            print(f"greedy dispatch B={b}: peak device memory "
                  f"{extra['peak_bytes']} bytes; with the parent's "
                  f"[B, K, N] noise tensor {extra['parent_form_peak_bytes']}"
                  f" bytes")
        out.setdefault("greedy_scan", {})[b] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, draw_s, chain / 1000.0)),
            library_ms=None, chain_ms=chain, noise_k0_ms=k0_scan_ms, **fig,
            **extra)
        # ---- K2, its noise drawn in the kernel
        c_k, c_p = (new_carry(torch, base, jc, tgc) for _ in range(2))
        ch, sc = binpack.uniform_topk(*static, c_k, feas, uasks, draw, 10.0)
        unoise = draw.noise((n,))
        err = check_scan(torch, f"K2 (B={b})", (ch, sc, c_k), (
            *binpack.uniform_topk_plain(*static, c_p, feas, uasks, unoise,
                                        10.0), c_p), bits=True)
        rows, cells = rows_written(torch, ch, uasks.tg_index, n, g)
        ms = time_cuda(torch, lambda: binpack.uniform_topk(
            *static, box["c"], feas, uasks, draw, 10.0), RUNS, setup=fresh)
        plain_ms = time_cuda(torch, lambda: binpack.uniform_topk_plain(
            *static, box["c"], feas, uasks, unoise, 10.0), RUNS, setup=fresh)
        dev_ms = device_ms(torch, lambda: binpack.uniform_topk(
            *static, box["c"], feas, uasks, draw, 10.0), RUNS, setup=fresh,
            match="topk")
        k0_row_ms = time_cuda(torch, lambda: prng.threefry_uniform(
            keys, (n,), 0.0, 2.0), RUNS)
        score = torch.randn((b, n), device=dev)
        k_eff = min(k, n)
        lib_ms = time_cuda(torch, lambda: torch.topk(score, k_eff, dim=1),
                           RUNS)
        lib_dev = device_ms(torch, lambda: torch.topk(score, k_eff, dim=1),
                            RUNS)
        print(f"uniform_topk B={b} K={k}: {ms:.4f} ms a call, kernel "
              f"{dev_ms} ms on the device (its draw included; K0 of the "
              f"same [{n}] rows alone {k0_row_ms:.4f} ms); torch.topk "
              f"{lib_ms:.4f} ms a call, {lib_dev} ms on the device")
        # Node rows; the carry with one task group's column of tg_count
        # and that column of feasible read once; ask 0 and its two
        # distinct_hosts flags; the keys; active and the two outputs of
        # every ask; the chosen rows written back once.
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 1 + 4)
                  + b * (ASK_BYTES - 1 + 2) + b * 16 + b * k * (1 + 8)
                  + rows * CARRY_ROW_BYTES + cells * 4)
        ops = b * n * (60 + 10)  # one scoring pass + a k-selection
        out.setdefault("uniform_topk", {})[b] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(ops / FP32_FLOPS,
                                b * n * sass["seconds_per_element"])),
            library_ms=lib_ms, device_ms=dev_ms, library_device_ms=lib_dev,
            noise_k0_ms=k0_row_ms)
        del unoise
        # ---- K3 over node tiles
        ov, class_ids = overlay_inputs(torch, np, n, g, b, seed, dev)
        got = binpack.expand_overlay(class_ids, ov, n)
        want = binpack.expand_overlay_plain(class_ids, ov, n)
        check(all(torch.equal(x, y) for x, y in zip(got, want)),
              f"K3 outputs differ (B={b})")
        err = max((x.long() - y.long()).abs().max().item()
                  for x, y in zip(got, want))
        call = lambda: binpack.expand_overlay(class_ids, ov, n)  # noqa: E731
        ms = time_cuda(torch, call, RUNS)
        dev_ms = device_ms(torch, call, RUNS, match="expand_overlay")
        host = host_ms(torch, call, RUNS)
        plain_ms = time_cuda(torch, lambda: binpack.expand_overlay_plain(
            class_ids, ov, n), RUNS)
        c, p, j = ov.verdicts.shape[1], ov.patch_rows.shape[1], \
            ov.job_rows.shape[1]
        bytes_ = (n * 4 + b * (c * g + p * (4 + g) + j * 8)
                  + b * n * (g + 4 + 4 * g))
        tile, groups = binpack.overlay_tile(g)
        ctas = -(-n // tile) * b * -(-g // groups)
        out.setdefault("expand_overlay", {})[b] = dict(
            max_abs_err=float(err), ms=ms, plain_ms=plain_ms,
            **bound(bytes_, b * (n * g + j) / INT32_OPS), library_ms=None,
            device_ms=dev_ms, host_ms=host, tile=tile, groups=groups,
            ctas=ctas)
        print(f"expand_overlay B={b}: {ctas} CTAs of {tile} rows x {groups} "
              f"task groups; {ms:.4f} ms a call, kernel {dev_ms} ms on the "
              f"device, host span {host:.4f} ms; equal to the plain version")
        torch.cuda.empty_cache()
    # K0 at the consumers' widths: the gang program's member and group
    # draws, a K10c shard's window, and counters past 2^32.
    for label, bb, shape, window in (
            ("gang members", 1, (1024, n), None),
            ("gang groups", 1, (1024,), None),
            ("K10c window", 1, (k, n // 4), (n // 4, n)),
            ("past 2^32", 1, (70_000, 16), (69_984, 70_000))):
        keys = torch.arange(2 * bb, device=dev).view(bb, 2) + 11
        rec = k0_record(torch, keys, shape, window, sass)
        out["threefry_uniform"][label] = rec
        print(f"K0 {label} {shape}: bit-equal to the plain version, "
              f"{rec['ms']:.4f} ms (bound {rec['bound_ms']:.4f} at the "
              f"issue rate, {rec['pipe_bound_ms']:.4f} at the busiest "
              "pipe as compiled)")
    # K2 at the node bucket of a 20k-node cluster (K = 64: the radix
    # select over 2,560-node slices).
    n2 = 20_480
    base, jc, tgc, feas, _asks, uasks, keys = kernel_inputs(
        torch, np, n2, 64, g, 2, seed, dev)
    static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
              base["node_ok"])
    draw = prng.Draw(keys, 2.0)
    runs = []
    for fn, noise in ((binpack.uniform_topk, draw),
                      (binpack.uniform_topk_plain, draw.noise((n2,)))):
        c = new_carry(torch, base, jc, tgc)
        runs.append((*fn(*static, c, feas, uasks, noise, 10.0), c))
    check_scan(torch, f"K2 at N={n2} (radix select)", *runs, bits=True)
    print(f"uniform_topk at N={n2} (radix select, K = 64): matches")
    return out


def bound(bytes_, ops_s):
    bytes_s = bytes_ / HBM_BYTES_S
    return dict(bound_ms=max(bytes_s, ops_s) * 1000.0,
                bound_by="bytes" if bytes_s >= ops_s else "operations")


def overlay_inputs(torch, np, n, g, b, seed, device):
    """Compact overlays of the widths the main path uses: 128 classes,
    256 patch rows (padded with N), 1,024 job positions with duplicate
    rows (padded with N)."""
    from nomad_tpu_torch.ops import binpack

    rng = np.random.default_rng(seed)
    c, p, j = 128, 256, 1024
    class_ids = rng.integers(-1, 100, n).astype(np.int32)
    patch_rows = np.full((b, p), n, np.int32)
    patch_rows[:, :200] = np.stack([rng.choice(n, 200, replace=False)
                                    for _ in range(b)])
    job_rows = np.full((b, j), n, np.int32)
    job_rows[:, :900] = rng.integers(0, n, (b, 900))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    ov = binpack.CompactOverlay(
        verdicts=t(rng.random((b, c, g)) < 0.7),
        patch_rows=t(patch_rows),
        patch_vals=t(rng.random((b, p, g)) < 0.5),
        job_rows=t(job_rows),
        job_tgs=t(rng.integers(0, g, (b, j)).astype(np.int32)))
    return ov, t(class_ids)


def seq_carry(base, jc, tgc):
    """One shared copy of the claimed capacity (the pre_resolve
    layout) and per-eval counts."""
    return tuple(x.clone() for x in (base["util"], base["bw_used"],
                                      base["ports_free"], jc, tgc))


def stacked_static(torch, np, base, b, seed, device):
    """Static node rows per eval (the stacked-state layout): capacity
    scaled by 1 or 2 per node and eval, node_ok thinned per eval."""
    rng = np.random.default_rng(seed)
    n = base["capacity"].shape[0]
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    cap = (base["capacity"] * t(rng.integers(1, 3, (b, n, 1))
                                .astype(np.float32))).contiguous()
    sched = (cap - (base["capacity"] - base["sched_capacity"])).contiguous()
    ok = (base["node_ok"] & t(rng.random((b, n)) < 0.95)).contiguous()
    return cap, sched, base["bw_avail"].expand(b, n).contiguous(), ok


def bench_new_kernels(torch, np, seed):
    """The kernels of the storm path: K4 and the sequential and stacked
    layouts of K1 and K2, each against its plain version."""
    from nomad_tpu_torch.ops import binpack, prng

    sass = k0_sass()
    dev = torch.device("cuda")
    n, g = BENCH_N, 2
    out = {}
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # ---- K4 at R = 256 and 4,096 changed rows (padding repeats row 0)
    for r in (256, 4096):
        rng = np.random.default_rng(seed + r)
        parent = (t(rng.integers(0, 40, (n, 4)).astype(np.float32) * 50),
                  t(rng.integers(0, 10, n).astype(np.float32) * 50),
                  t(rng.integers(0, 7, n).astype(np.float32)),
                  t(rng.random(n) < 0.98))
        real = r - r // 8
        rows = np.empty(r, np.int32)
        rows[:real] = rng.choice(n, real, replace=False)
        rows[real:] = rows[0]
        vals = [rng.integers(0, 40, (r, 4)).astype(np.float32) * 50,
                rng.integers(0, 10, r).astype(np.float32) * 50,
                rng.integers(0, 7, r).astype(np.float32),
                rng.random(r) < 0.5]
        for v in vals:
            v[real:] = v[0]
        payload = (t(rows), *(t(v) for v in vals))
        before = [x.clone() for x in parent]
        got = binpack.apply_base_delta(*parent, *payload)
        want = binpack.apply_base_delta_plain(*parent, *payload)
        for x, y, z, p0 in zip(got, want, parent, before):
            check(torch.equal(x, y), f"K4 (R={r}): differs from the plain "
                  "version")
            check(torch.equal(z, p0), f"K4 (R={r}): the parent changed")
        err = max((x.double() - y.double()).abs().max().item()
                  for x, y in zip(got, want))
        call = lambda: binpack.apply_base_delta(  # noqa: E731
            *parent, *payload)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        _out, launches = launches_of("base_delta", call)
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - \
            allocs
        del _out
        check(launches == 1 and allocs == 1, f"K4 (R={r}): {launches} "
              f"launches and {allocs} allocations a call")
        fig = dict(launches_per_call=launches, allocations_per_call=allocs,
                   host_ms=host_ms(torch, call, RUNS),
                   device_ms=device_ms(torch, call, RUNS))
        ms = time_cuda(torch, call, RUNS)
        plain_ms = time_cuda(torch, lambda: binpack.apply_base_delta_plain(
            *parent, *payload), RUNS)
        idx = (payload[0].long(),)
        lib_ms = time_cuda(torch, lambda: [
            torch.index_put(x, idx, v)
            for x, v in zip(parent, payload[1:])], RUNS)
        # The parent read and the child written once (util, bw_used,
        # ports_free, node_ok: 25 B a node), and the R rows of payload.
        bytes_ = 2 * n * 25 + r * (4 + 16 + 4 + 4 + 1)
        out.setdefault("base_delta", {})[r] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, 0.0), library_ms=lib_ms, **fig)
        print(f"base_delta R={r}: bit-equal to the plain version, parent "
              f"unchanged; {launches} launch and {allocs} allocation a call, "
              f"{ms:.4f} ms, device {fig['device_ms']} ms, host span "
              f"{fig['host_ms']:.4f} ms")
    # ---- K1 sequential at B x K = 4 x 1,024 and 64 x 64
    for b, k in ((4, 1024), (64, 64)):
        base, jc, tgc, feas, asks, _u, keys = kernel_inputs(
            torch, np, n, k, g, b, seed + 3 * b, dev)
        static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
                  base["node_ok"])
        draw = prng.Draw(keys, 2.0)
        noise = draw.noise((k, n))
        c_k, c_p = seq_carry(base, jc, tgc), seq_carry(base, jc, tgc)
        ch, sc = binpack.greedy_scan(*static, c_k, feas, asks, draw, 10.0,
                                     True)
        err = check_scan(torch, f"K1-seq (B={b}, K={k})", (ch, sc, c_k), (
            *binpack.greedy_scan_plain(*static, c_p, feas, asks, noise, 10.0,
                                       True), c_p), bits=True)
        full = ((base["ports_free"] >= 2) & (c_k[2] < 2)).sum().item()
        check(full > 0, f"K1-seq (B={b}): no node filled to its port limit")
        print(f"greedy_scan_seq B={b} K={k}: {(ch >= 0).sum().item()} of "
              f"{b * k} asks placed over one shared carry, {full} rows "
              "filled to their port limit; choices, scores and all five "
              "carried tensors match")
        box = {}
        fresh = lambda: box.__setitem__("c", seq_carry(base, jc, tgc))
        ms = time_cuda(torch, lambda: binpack.greedy_scan(
            *static, box["c"], feas, asks, draw, 10.0, True), RUNS,
            setup=fresh)
        plain_ms = time_cuda(torch, lambda: binpack.greedy_scan_plain(
            *static, box["c"], feas, asks, noise, 10.0, True),
            SLOW_PLAIN_RUNS, warmup=0, setup=fresh)
        del noise
        k0_ms = time_cuda(torch, lambda: prng.threefry_uniform(
            keys, (k, n), 0.0, 2.0), RUNS)
        fig = greedy_figures(torch, "greedy_scan_seq", True, static, feas,
                             asks, draw, fresh, box, ms)
        fig["plain_runs"] = SLOW_PLAIN_RUNS
        rows, cells = rows_written(torch, ch, asks.tg_index, n, g)
        nodes = torch.unique(ch[ch >= 0]).numel()
        chain = chain_ms(torch, b * k, dev)
        # Node rows and the shared carry read once; per eval its counts
        # and feasible; every ask and its two outputs; the flags; the
        # keys; the chosen shared rows and per-eval counts written once;
        # the draw's instructions (K0's, an element).
        bytes_ = (n * (NODE_BYTES + 24) + b * n * (4 + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * 16
                  + nodes * 24 + rows * 4 + cells * 4)
        flops = b * k * n * 60
        draw_s = b * k * n * sass["seconds_per_element"]
        out.setdefault("greedy_scan_seq", {})[(b, k)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, draw_s, chain / 1000.0)),
            library_ms=None, chain_ms=chain, noise_k0_ms=k0_ms, **fig)
    # ---- K2 sequential at B x K = 64 x 8 (config 4's storm)
    b, k = 64, 8
    base, jc, tgc, feas, _a, uasks, keys = kernel_inputs(
        torch, np, n, k, g, b, seed + 11, dev)
    static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
              base["node_ok"])
    draw = prng.Draw(keys, 2.0)
    unoise = draw.noise((n,))
    c_k, c_p = seq_carry(base, jc, tgc), seq_carry(base, jc, tgc)
    ch, sc = binpack.uniform_topk(*static, c_k, feas, uasks, draw, 10.0,
                                  True)
    err = check_scan(torch, f"K2-seq (B={b}, K={k})", (ch, sc, c_k), (
        *binpack.uniform_topk_plain(*static, c_p, feas, uasks, unoise, 10.0,
                                    True), c_p), bits=True)
    full = ((base["ports_free"] >= 2) & (c_k[2] < 2)).sum().item()
    print(f"uniform_topk_seq B={b} K={k}: {(ch >= 0).sum().item()} of "
          f"{b * k} asks placed, {full} shared rows filled to their port "
          "limit; choices, scores and all five carried tensors match")
    box = {}
    fresh = lambda: box.__setitem__("c", seq_carry(base, jc, tgc))
    _out, launches = launches_of("uniform_topk_seq", lambda: (
        fresh(), binpack.uniform_topk(*static, box["c"], feas, uasks, draw,
                                      10.0, True)))
    ms = time_cuda(torch, lambda: binpack.uniform_topk(
        *static, box["c"], feas, uasks, draw, 10.0, True), RUNS,
        setup=fresh)
    dev_ms = device_ms(torch, lambda: binpack.uniform_topk(
        *static, box["c"], feas, uasks, draw, 10.0, True), RUNS,
        setup=fresh, match="topk")
    k0_ms = time_cuda(torch, lambda: prng.threefry_uniform(
        keys, (n,), 0.0, 2.0), RUNS)
    plain_ms = time_cuda(torch, lambda: binpack.uniform_topk_plain(
        *static, box["c"], feas, uasks, unoise, 10.0, True), RUNS,
        setup=fresh)
    score = torch.randn((b, n), device=dev)
    lib_ms = time_cuda(torch, lambda: torch.topk(score, k, dim=1), RUNS)
    lib_dev = device_ms(torch, lambda: torch.topk(score, k, dim=1), RUNS)
    rows, cells = rows_written(torch, ch, uasks.tg_index, n, g)
    nodes = torch.unique(ch[ch >= 0]).numel()
    chain = chain_ms(torch, b, dev)
    bytes_ = (n * (NODE_BYTES + 24) + b * n * (4 + 1 + 4)
              + b * (ASK_BYTES - 1 + 2) + b * 16 + b * k * (1 + 8)
              + nodes * 24 + rows * 4 + cells * 4)
    print(f"uniform_topk_seq B={b} K={k}: {ms:.4f} ms a call, kernel "
          f"{dev_ms} ms on the device (its draw included; K0 of the same "
          f"rows alone {k0_ms:.4f} ms), {launches} launch(es) a call; chain "
          f"of {b} block reductions {chain:.4f} ms; torch.topk "
          f"{lib_ms:.4f} ms a call, {lib_dev} ms on the device")
    out["uniform_topk_seq"] = {b: dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(bytes_, max(b * n * 70 / FP32_FLOPS,
                            b * n * sass["seconds_per_element"],
                            chain / 1000.0)),
        library_ms=lib_ms, chain_ms=chain, launches_per_call=launches,
        device_ms=dev_ms, library_device_ms=lib_dev, noise_k0_ms=k0_ms)}
    # ---- K5b: the stacked layouts at B = 4 (K1 at K = 1,024, K2 at 8)
    b = 4
    for name, k in (("greedy_scan_stacked", BENCH_K),
                    ("uniform_topk_stacked", 8)):
        base, jc, tgc, feas, asks, uasks, keys = kernel_inputs(
            torch, np, n, k, g, b, seed + 13 + k, dev)
        static = stacked_static(torch, np, base, b, seed + k, dev)
        greedy = name.startswith("greedy")
        fn, plain = ((binpack.greedy_scan, binpack.greedy_scan_plain)
                     if greedy else
                     (binpack.uniform_topk, binpack.uniform_topk_plain))
        a = asks if greedy else uasks
        draw = prng.Draw(keys, 2.0)
        noise = draw.noise((k, n) if greedy else (n,))
        c_k, c_p = (new_carry(torch, base, jc, tgc) for _ in range(2))
        ch, sc = fn(*static, c_k, feas, a, draw, 10.0)
        err = check_scan(torch, f"{name} (B={b})", (ch, sc, c_k), (
            *plain(*static, c_p, feas, a, noise, 10.0), c_p), bits=True)
        print(f"{name} B={b} K={k}: {(ch >= 0).sum().item()} of {b * k} "
              "asks placed over a base per eval; choices, scores and all "
              "five carried tensors match")
        box = {}
        fresh = lambda: box.__setitem__("c", new_carry(torch, base, jc, tgc))
        ms = time_cuda(torch, lambda: fn(*static, box["c"], feas, a, draw,
                                         10.0), RUNS, setup=fresh)
        plain_ms = time_cuda(torch, lambda: plain(
            *static, box["c"], feas, a, noise, 10.0),
            SLOW_PLAIN_RUNS if greedy else RUNS, warmup=0 if greedy else 1,
            setup=fresh)
        rows, cells = rows_written(torch, ch, a.tg_index, n, g)
        lib_ms = None
        k0_ms = time_cuda(torch, lambda: prng.threefry_uniform(
            keys, (k, n) if greedy else (n,), 0.0, 2.0), RUNS)
        draw_s = noise.numel() * sass["seconds_per_element"]
        del noise
        if greedy:
            extra = dict(chain_ms=chain_ms(torch, k, dev),
                         plain_runs=SLOW_PLAIN_RUNS, **greedy_figures(
                             torch, name, False, static, feas, a, draw,
                             fresh, box, ms))
            chain = extra["chain_ms"]
            bytes_ = (b * n * (NODE_BYTES + CARRY_ROW_BYTES + 5 * g)
                      + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * 16
                      + rows * CARRY_ROW_BYTES + cells * 4)
            ops_s = max(b * k * n * 60 / FP32_FLOPS, draw_s, chain / 1000.0)
        else:
            score = torch.randn((b, n), device=dev)
            lib_ms = time_cuda(torch, lambda: torch.topk(score, k, dim=1),
                               RUNS)
            extra = dict(
                device_ms=device_ms(torch, lambda: fn(
                    *static, box["c"], feas, a, draw, 10.0), RUNS,
                    setup=fresh, match="topk"),
                library_device_ms=device_ms(
                    torch, lambda: torch.topk(score, k, dim=1), RUNS))
            print(f"{name} B={b} K={k}: {ms:.4f} ms a call, kernel "
                  f"{extra['device_ms']} ms on the device; torch.topk "
                  f"{lib_ms:.4f} ms a call, {extra['library_device_ms']} ms "
                  "on the device")
            bytes_ = (b * n * (NODE_BYTES + CARRY_ROW_BYTES + 1 + 4)
                      + b * (ASK_BYTES - 1 + 2) + b * 16 + b * k * (1 + 8)
                      + rows * CARRY_ROW_BYTES + cells * 4)
            ops_s = max(b * n * 70 / FP32_FLOPS, draw_s)
        out[name] = {b: dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             **bound(bytes_, ops_s), library_ms=lib_ms,
                             noise_k0_ms=k0_ms, **extra)}
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- mesh

MESH_SHARDS = 4
MESH_ROUNDS = 2
RACK_GROUP_PAD = 256


def mesh_devices(torch):
    """The mesh phase's four shards: over the cards round-robin where
    there are two or more (the distinct-card path), else four slices of
    the one card."""
    n = torch.cuda.device_count()
    return [f"cuda:{s % n if n >= 2 else 0}" for s in range(MESH_SHARDS)]


class ShapeCalls:
    """Counts the calls of the relaxation's wrappers by shape while the
    block runs (the main paths, not the holds): K8a (``relaxed_pref``,
    ``relaxed_assignment``: B, K, N), K9 (``defrag_solve``: K, N,
    iterations) and K10f / K10g-a (``sharded_relax``: K, N, W,
    iterations / B, K, N, W). ``by_kernel[name]`` maps a shape to its
    calls, so a ranking can weigh each shape's gap by its calls."""

    def __init__(self):
        from nomad_tpu_torch.kernels import convex
        from nomad_tpu_torch.parallel import shard

        self.by_kernel = {}
        self.sites = [(convex, "relaxed_pref", self._relax),
                      (convex, "relaxed_assignment", self._relax),
                      (convex, "defrag_solve", self._defrag),
                      (shard, "sharded_relax", self._sharded)]

    def _count(self, name, shape):
        calls = self.by_kernel.setdefault(name, {})
        calls[shape] = calls.get(shape, 0) + 1

    def _relax(self, args):
        feasible, asks = args[5], args[6]
        self._count("convex_relax", (feasible.shape[0],
                                     asks.resources.shape[1],
                                     feasible.shape[1]))

    def _defrag(self, args):
        k, w = args[0].shape
        self._count("defrag_solve", (k, w, int(args[-1])))

    def _sharded(self, args):
        shards, iters = args[0], int(args[1])
        if hasattr(shards[0], "logits0"):
            k = shards[0].logits0.shape[0]
            n = sum(sh.logits0.shape[1] for sh in shards)
            self._count("sharded_defrag_solve", (k, n, len(shards), iters))
        else:
            b, n = shards[0].feasible.shape[0], sum(
                sh.feasible.shape[1] for sh in shards)
            self._count("sharded_convex_relax", (
                b, shards[0].asks.resources.shape[1], n, len(shards)))

    def __enter__(self):
        self.orig = []
        for module, name, count in self.sites:
            fn = getattr(module, name)
            self.orig.append((module, name, fn))

            def wrapped(*args, _fn=fn, _count=count, **kwargs):
                _count(args)
                return _fn(*args, **kwargs)

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.orig:
            setattr(module, name, fn)

    def of(self, name):
        """{str(shape): calls} of kernel ``name``, the most called
        first."""
        calls = self.by_kernel.get(name, {})
        return {str(k): v for k, v in sorted(calls.items(),
                                              key=lambda kv: -kv[1])}


class ShardRecorder:
    """Wraps ``parallel.shard.<name>`` (a wrapper over node shards) while
    the block runs and keeps each call's shards and other arguments,
    copied before it, and its result, copied: (shards, args, out)."""

    def __init__(self, name):
        from nomad_tpu_torch.parallel import shard

        self.module, self.name, self.calls = shard, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(shards, *args):
            inputs = [cloned(sh) for sh in shards]
            kept = cloned(args)
            out = self.orig(shards, *args)
            self.calls.append((inputs, kept, cloned(
                tuple(out) if isinstance(out, list) else out)))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class FactoryCalls:
    """Counts, while the block runs, the calls of the functions that
    ``parallel.shard.<name>(...)`` returns (the K10a and K10b wrappers
    are factories over a mesh)."""

    def __init__(self, name):
        from nomad_tpu_torch.parallel import shard

        self.module, self.name, self.calls = shard, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def factory(*args, **kwargs):
            fn = self.orig(*args, **kwargs)

            def call(*a, **k):
                self.calls += 1
                return fn(*a, **k)

            return call

        setattr(self.module, self.name, factory)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def card_launches(devices, combine=False):
    """Launches a call of K10a (``combine`` False) or K10b over shards
    on ``devices``: one a card, and K10b's combine where the shards
    span cards."""
    cards = len({str(d) for d in devices})
    return cards + (1 if combine and cards > 1 else 0)


def require_per_call(label, launches, calls, per_call):
    check(calls > 0 and launches == calls * per_call,
          f"{label}: {launches} launches in {calls} calls, expected "
          f"{per_call} a call")
    print(f"{label}: {calls} calls, {per_call} launch(es) a call")


def run_mesh(seed, torch, total, storm_h):
    """Phase 9: the node-sharded mesh path on a 4-shard mesh. Returns
    the recorded calls for the holds (bench_mesh)."""
    import numpy as np

    from nomad_tpu_torch import trace
    from nomad_tpu_torch.ops import cuda
    from nomad_tpu_torch.parallel.mesh import make_mesh
    from nomad_tpu_torch.scheduler.batcher import (
        PlacementBatcher,
        _delta_payload,
    )

    devices = mesh_devices(torch)
    mesh = make_mesh(devices=devices)
    print(f"mesh: {mesh}")
    if torch.cuda.device_count() < 2:
        print("mesh: distinct-card path not run (one card): the four "
              "shards are slices of cuda:0")
    else:
        print(f"mesh: distinct-card path over {torch.cuda.device_count()} "
              "cards")
    mb = PlacementBatcher(mesh=mesh)
    ref = PlacementBatcher()
    storm = Storm(storm_h, mb)
    on = lambda job, m: placement_config(job, m, True)  # noqa: E731
    rec = {}
    figures = {}
    try:
        s0 = mb.stats()
        # Warm-up round on the first snapshot, not committed (phase 4's
        # warm-up): its host base build and sharded upload stay out of
        # the timed rounds, and round 1 finds the base cached.
        storm.round(storm.jobs("mesh-warm", STORM_BATCH, storm_job),
                    105_000, on)
        rounds = [storm.jobs(f"mesh{r}", STORM_BATCH, storm_job)
                  for r in range(MESH_ROUNDS)]
        spans = []

        def mesh_storm():
            out = []
            with ShardRecorder("sharded_uniform_topk") as topk, \
                    FactoryCalls("sharded_base_delta") as deltas:
                for r, jobs in enumerate(rounds):
                    before = mb.stats()
                    out.append(storm.round(jobs, 110_000 + r * STORM_BATCH,
                                           on))
                    spans.append(dispatch_us(stats_delta(
                        before, mb.stats())) / 1000.0)
                    storm.commit(out[-1][2])
            rec["topk"] = topk.calls
            rec["delta_calls"] = deltas.calls
            return out

        # K10d on one card draws its noise in the kernel; over distinct
        # cards each shard's window is drawn first (K0).
        one_card = len({str(d) for d in devices}) == 1
        with GcPauses() as gc_pauses:
            done = counted(total, "mesh storm", (
                "expand_overlay", "sharded_uniform_topk", "sharded_base_delta",
                *(() if one_card else ("threefry_uniform",))), mesh_storm,
                DRAWN_IN_SCANS if one_card else ())
        require_per_call("mesh storm K10a", cuda.launch_counts().get(
            "sharded_base_delta", 0), rec.pop("delta_calls"),
            card_launches(devices))
        st = stats_delta(s0, mb.stats())
        lat = [t for r in done for t in r[3]]
        wall = sum(r[4] for r in done)
        n_evals = MESH_ROUNDS * STORM_BATCH
        placed = sum(len(a) for r in done for p in r[2]
                     for a in p.node_allocation.values())
        figures.update(
            evals=n_evals, evals_per_s=n_evals / wall,
            p50_ms=float(np.percentile(lat, 50)) * 1000.0,
            p99_ms=float(np.percentile(lat, 99)) * 1000.0,
            placed=placed, sync_ms=st["sync_us"] / 1000.0,
            issue_ms=st["issue_us"] / 1000.0,
            conflicted=sum(conflicted_evals(r[0], r[1]) for r in done))
        print(f"mesh storm ({MESH_SHARDS} shards): {n_evals} evals in "
              f"{wall:.3f} s = {figures['evals_per_s']:.2f} evals/s; "
              f"per-eval p50 {figures['p50_ms']:.2f} ms, p99 "
              f"{figures['p99_ms']:.2f} ms; issue {figures['issue_ms']:.1f}"
              f" ms, sync {figures['sync_ms']:.1f} ms; batcher, warm-up "
              f"round included: {json.dumps(st, sort_keys=True)}")
        check_placed("mesh storm", [x for r in done for x in r[1]], placed,
                     n_evals * 8)
        check(figures["conflicted"] == 0, "mesh storm: conflicted evals")
        check(st["sharded_bases"] == MESH_ROUNDS and st["base_uploads"] == 1
              and st["base_delta_updates"] == MESH_ROUNDS - 1
              and st["fused_delta_updates"] == 0,
              f"mesh storm: rounds after the first did not derive a "
              f"sharded base through K10a: {st}")
        occ = mb.shard_occupancy()
        print(f"mesh storm: per-shard occupancy {json.dumps(occ)}")
        print(f"  garbage collection in those rounds: "
              f"{json.dumps(gc_pauses.summary(), sort_keys=True)}")
        # The same rows through the unsharded batcher (K2-seq, K3, K4):
        # plans identical, choices and scores bit for bit; its dispatch
        # timed beside the mesh one.
        ref_ms = []
        for r, (rows, results, plans, _l, _w) in enumerate(done):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ref.place_cohort([(m, a, k, on(job, m), None)
                                     for job, _s, m, a, k in rows])
            ref_ms.append((time.perf_counter() - t0) * 1000.0)
            print(f"  round {r}: {done[r][4] * 1000:.1f} ms, of it the mesh "
                  f"dispatch {spans[r]:.1f} ms (batcher upload, stack, "
                  f"issue, sync); the unsharded dispatch of the same rows "
                  f"{ref_ms[r]:.1f} ms")
            for i, ((c, sc), (wc, ws)) in enumerate(zip(results, want)):
                check(np.array_equal(c, wc) and np.array_equal(
                    sc.view(np.int32), ws.view(np.int32)),
                    f"mesh storm round {r} eval {i}: differs from the "
                    "unsharded storm")
            for row, plan, (wc, ws) in zip(rows, plans, want):
                again = storm.materialize(row, wc, ws)
                check(plan_nodes(plan) == plan_nodes(again),
                      f"mesh storm round {r}: a plan differs")
        figures.update(dispatch_ms=spans, unsharded_dispatch_ms=ref_ms,
                       **gc_pauses.summary())
        print(f"mesh storm: {MESH_ROUNDS} rounds' plans identical to the "
              "unsharded storm's on the same state and keys")
        # The base delta of round 2, for K10a's hold.
        m2 = done[1][0][0][2]
        parent = mb._device_bases[m2.base_delta[0]]
        rec["delta"] = (mesh, parent, _delta_payload(
            (m2.capacity, m2.sched_capacity, m2.util, m2.bw_avail,
             m2.bw_used, m2.ports_free, m2.node_ok, m2.class_ids),
            m2.base_delta[1]))

        # ---- the 512 + 512 greedy eval through K10c, against K1
        job = storm.jobs("mesh-greedy", 1,
                         lambda i: two_group_job_id(i, 512))[0]
        row = storm.build_row(storm_h.state.snapshot(), job, 120_000)
        trace.complete(storm_eval_id(job, 120_000))

        def greedy():
            with ShardRecorder("sharded_greedy_scan") as scan:
                got = mb.place_cohort([(row[2], row[3], row[4],
                                        on(job, row[2]), None)])
            rec["greedy"] = scan.calls
            return got

        t0 = time.perf_counter()
        got = counted(total, "mesh greedy eval", (
            "threefry_uniform", "expand_overlay", "sharded_greedy_scan"),
            greedy)
        wall = time.perf_counter() - t0
        want = ref.place_cohort([(row[2], row[3], row[4], on(job, row[2]),
                                  None)])
        (c, sc), (wc, ws) = got[0], want[0]
        check(np.array_equal(c, wc) and np.array_equal(
            sc.view(np.int32), ws.view(np.int32)),
            "mesh greedy eval: differs from K1's")
        figures["greedy_eval_ms"] = wall * 1000.0
        print(f"mesh greedy eval (512 + 512 asks, pre_resolve, live rows "
              f"only): {int((c >= 0).sum())} of 1024 placed in "
              f"{wall * 1000:.1f} ms, choices and scores equal to K1's")

        # ---- K10b on the mesh: member units of config 4's ask per node
        # over meta-less singletons (g_pad 10,240) and racks of 40
        m = row[2]
        ask = np.asarray(row[3].resources[0], np.float64)
        free = np.asarray(m.capacity, np.float64) - m.util
        per = np.where(ask[None, :] > 0,
                       np.floor(free / np.maximum(ask, 1e-9)[None, :]), 1e9)
        units = (np.clip(per.min(1), 0, None) * m.node_ok).astype(np.float32)
        n = units.shape[0]
        real = np.arange(n) < m.n_real
        groups = {
            n: np.where(real, np.arange(n), -1).astype(np.int32),
            RACK_GROUP_PAD: np.where(real, np.arange(n) // RACK_SIZE,
                                     -1).astype(np.int32)}

        def capacities():
            from nomad_tpu_torch.parallel import shard

            return {g_pad: shard.sharded_group_capacity(mesh, g_pad)(
                units, ids) for g_pad, ids in groups.items()}

        with FactoryCalls("sharded_group_capacity") as group_calls:
            caps = counted(total, "mesh group capacity", ("group_capacity",),
                           capacities)
        require_per_call(
            "mesh group capacity K10b",
            cuda.launch_counts().get("group_capacity", 0), group_calls.calls,
            card_launches(devices, combine=True))
        for g_pad, ids in groups.items():
            want = np.zeros(g_pad, np.float32)
            np.add.at(want, ids[ids >= 0], units[ids >= 0])
            check(np.array_equal(caps[g_pad].cpu().numpy(), want),
                  f"K10b (g_pad {g_pad}): differs from the one-device sum")
        rec["groups"] = (mesh, units, groups)
        print(f"mesh group capacity: g_pad {n} (singletons) and "
              f"{RACK_GROUP_PAD} (racks of {RACK_SIZE}) equal the one-device "
              f"node-order sums (units under 2^24: max "
              f"{float(units.max()):.0f})")
    finally:
        storm.close()
    return figures, rec


def plan_nodes(plan):
    """{alloc name: node id} of a plan."""
    return {a.name: a.node_id for allocs in plan.node_allocation.values()
            for a in allocs}


def hold_shards(torch, label, call, force_shards=False, want=None):
    """One recorded sharded-scan call (K10c, K10d or K10g-b) re-run
    through the kernel and the plain version on copies of its inputs:
    choices, scores and every shard's carry equal (scores within
    SCORE_TOL), and the kernel's re-run equal to the recorded result.
    Then the whole node axis through the unsharded K1 / K2 / K8b (fed
    the same pref): equal bit for bit. ``force_shards``: K10c's and
    K10g-b's per-shard route on the same shards; ``want``: the plain
    run of an earlier hold of the same call, taken instead of running
    the plain version again. Returns the score error, the kernel
    re-run's launches and the plain run."""
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.ops import binpack
    from nomad_tpu_torch.ops.prng import Draw
    from nomad_tpu_torch.parallel import shard

    inputs, (penalty, *rest), out = call
    seq = bool(rest and rest[0])
    uniform = inputs[0].noise is None or inputs[0].noise.dim() == 2
    biased = inputs[0].pref is not None
    kern, plain, one = ((shard.sharded_uniform_topk,
                         shard.sharded_uniform_topk_plain,
                         binpack.uniform_topk) if uniform else
                        (shard.sharded_convex_round,
                         shard.sharded_convex_round_plain,
                         convex.convex_round) if biased else
                        (shard.sharded_greedy_scan,
                         shard.sharded_greedy_scan_plain,
                         binpack.greedy_scan))
    extra = {"force_shards": True} if force_shards else {}
    runs = []
    for fn in (kern, plain):
        if fn is plain and want is not None:
            runs.append(want)
            continue
        shards = [cloned(sh) for sh in inputs]
        if fn is plain:
            shards = plain_windows(shards)
        (ch, sc), n = launches_of(kern.__name__, lambda: fn(
            shards, penalty, seq, **(extra if fn is kern else {})))
        if fn is kern:
            launches = n
        runs.append((ch, sc, joined_carry(torch, shards, seq)))
    err = check_scan(torch, label, *runs)
    check(torch.equal(runs[0][0], out[0]) and torch.equal(runs[0][1], out[1]),
          f"{label}: the re-run differs from the recorded call")
    whole = [cloned(sh) for sh in inputs]
    cat = lambda xs, d: torch.cat(list(xs), dim=d)  # noqa: E731
    static = [cat((getattr(sh, f) for sh in whole), 0)
              for f in ("capacity", "sched_capacity", "bw_avail", "node_ok")]
    carry = list(joined_carry(torch, whole, seq))
    feas = cat((sh.feasible for sh in whole), 1)
    pref = (cat((sh.pref for sh in whole), -1),) if biased else ()
    if biased:  # K8b reads a noise tensor: the shards' windows joined
        noise = cat((sh.noise for sh in whole), -1)
    else:  # K1 and K2 draw the whole row from the shards' keys
        noise = Draw(whole[0].draw.keys, whole[0].draw.scale)
    ch, sc = one(*static, carry, feas, whole[0].asks, noise, penalty, *pref,
                 seq)
    check(torch.equal(ch, out[0]) and torch.equal(sc, out[1]),
          f"{label}: differs from the unsharded kernel")
    return err, launches, runs[1]


def scan_route(torch, inputs, seq, biased):
    """The one-card route's plan of a recorded K10c / K10g-b call
    (``parallel.shard.scan_ctas`` CTAs a shard over the shards'
    segments; ops/scan.py caches it): its cluster and form."""
    from nomad_tpu_torch.ops import scan
    from nomad_tpu_torch.parallel.shard import scan_ctas

    devices = [sh.feasible.device for sh in inputs]
    cps = scan_ctas(devices)
    if not cps:
        return dict(route="shards")
    b, _n, g = inputs[0].feasible.shape
    rows = [sh.feasible.shape[1] for sh in inputs]
    plan = scan.plan_for(devices[0], b, sum(rows), g, seq,
                         ctas=cps * len(rows), bias=biased, segments=rows)
    return dict(route="cluster", ctas=plan.ctas, cps=plan.cps,
                threads=plan.threads, slice=plan.slice, form=plan.form)


def shard_launches(b, k, w, seq):
    """Launches of one K10c / K10g-b call on the per-shard route: K x (W
    + 1) a step's shards and winner, B x that under ``seq``, and W to
    apply the last winners."""
    return (b if seq else 1) * k * (w + 1) + w


def route_launches(route, per_shard):
    """Launches a call on a record's route: one on one card's cluster,
    ``per_shard`` on the per-shard route (distinct cards)."""
    return 1 if route["route"] == "cluster" else per_shard


def plain_windows(shards):
    """Uniform shards whose noise K10d's one-card route draws in its
    kernel, with the window drawn by the plain version instead: the
    plain versions' inputs."""
    return [sh if sh.noise is not None else sh._replace(
        noise=sh.draw.noise((sh.feasible.shape[1],))) for sh in shards]


def launches_of(name, fn):
    """``fn()`` with the launch counts set to 0 just before it: its
    result and the launches of kernel ``name`` it made."""
    from nomad_tpu_torch.ops import cuda

    cuda.reset_launch_counts()
    out = fn()
    return out, cuda.launch_counts().get(name, 0)


def joined_carry(torch, shards, seq):
    own = 0 if seq else 1
    return tuple(torch.cat([sh.carry[i] for sh in shards],
                           dim=own if i < 3 else 1) for i in range(5))


def resharded(torch, shards, seq, w):
    """A recorded scan call's node shards joined on the first shard's
    device and split again into ``w`` equal shards there: the same
    rows, carry, noise and asks over another layout."""
    from nomad_tpu_torch.ops.prng import Draw
    from nomad_tpu_torch.parallel.mesh import shard_bounds
    from nomad_tpu_torch.parallel.shard import NodeShard

    dev = shards[0].feasible.device
    d = 1 if shards[0].capacity.dim() == 3 else 0
    static = [torch.cat([getattr(sh, f).to(dev) for sh in shards], dim=d)
              for f in ("capacity", "sched_capacity", "bw_avail", "node_ok")]
    carry = [c.to(dev) for c in joined_carry(torch, shards, seq)]
    feas = torch.cat([sh.feasible.to(dev) for sh in shards], dim=1)
    n = feas.shape[1]
    noise = None
    if shards[0].noise is not None:
        noise = torch.cat([sh.noise.to(dev) for sh in shards], dim=1)
    keys, scale = shards[0].draw.keys.to(dev), shards[0].draw.scale
    own = 0 if seq else 1
    out = []
    for lo, hi in shard_bounds(n, w):
        part = lambda x, dim: x.narrow(dim, lo, hi - lo).contiguous()  # noqa: E731
        out.append(NodeShard(
            lo, *(part(x, d) for x in static),
            tuple(part(c, own if i < 3 else 1) for i, c in enumerate(carry)),
            part(feas, 1), shards[0].asks,
            None if noise is None else part(noise, 1),
            draw=Draw(keys, scale, lo, n)))
    return out


def library_delta(torch, np, targets, payload):
    """K10a's function by library calls from the call's own inputs (the
    sharded parent and the host payload): the payload's rows split by
    shard on the host, uploaded in one copy a card
    (``binpack.device_resident``), then ``torch.index_put`` of each
    array on each shard (a new tensor, as the call's children are).
    Returns [shard][array]."""
    from nomad_tpu_torch.ops.binpack import device_resident

    rows = np.asarray(payload[0])
    vals = [np.asarray(v) for v in payload[1:]]
    parts = [t.parts[0] for t in targets]
    by_dev = {}
    for s, x in enumerate(parts[0]):
        lo = targets[0].lo[s]
        keep = (rows >= lo) & (rows < lo + x.shape[0])
        by_dev.setdefault(x.device, []).append(
            (s, [(rows[keep] - lo).astype(np.int64),
                 *(v[keep] for v in vals)]))
    out = [None] * len(parts[0])
    for dev, items in by_dev.items():
        flat = device_resident([a for _s, arrs in items for a in arrs], dev)
        for k, (s, _a) in enumerate(items):
            idx, *vs = flat[5 * k:5 * k + 5]
            out[s] = [torch.index_put(parts[j][s], (idx,), vs[j])
                      for j in range(4)]
    return out


def bench_mesh(torch, np, rec):
    """Holds and times of K10a-K10d on the mesh phase's own inputs: the
    round-2 base delta, both group capacities, the 512 + 512 eval's
    K10c call (B = 1 under seq: the batcher pads no batch over a
    sharded base), and the storm's 64-eval K10d calls (K = 8 under seq:
    all held, the first timed)."""
    from nomad_tpu_torch.ops.binpack import apply_base_delta_plain
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import gather, place

    out = {}
    # ---- K10a
    mesh, parent, payload = rec["delta"]
    targets = [parent[i] for i in (2, 4, 5, 6)]
    per_call = card_launches(t.device for t in targets[0].parts[0])
    got, delta_launches = launches_of("sharded_base_delta", lambda: (
        shard.sharded_base_delta(mesh)(*targets, *payload)))
    check(delta_launches == per_call, f"K10a: {delta_launches} launches a "
          f"call, expected {per_call} (one a card)")
    pay = place(mesh, payload, ((), (None, None), (), (), ()))
    w = len(targets[0].parts[0])

    def plain_delta(pay=pay):
        return [apply_base_delta_plain(
            *(t.parts[0][s] for t in targets),
            *(p.parts[0][s] for p in pay), targets[0].lo[s])
            for s in range(w)]

    want = plain_delta()
    delta_err = 0.0
    for j, g in enumerate(got):
        for s in range(w):
            check(torch.equal(g.parts[0][s], want[s][j]),
                  f"K10a: shard {s} differs from the plain version")
            delta_err = max(delta_err, (g.parts[0][s].float() - want[s][j]
                                        .float()).abs().max().item())
    whole = [gather(t) for t in targets]
    rows = torch.from_numpy(payload[0]).long()
    for g, t, v in zip(got, whole, payload[1:]):
        t[rows] = torch.from_numpy(np.asarray(v))
        check(torch.equal(gather(g), t), "K10a: differs from the "
              "one-device scatter")
    n = sum(p.shape[0] for p in targets[0].parts[0])
    r = len(payload[0])
    call = lambda: shard.sharded_base_delta(mesh)(  # noqa: E731
        *targets, *payload)
    ms = time_cuda(torch, call, RUNS)
    dev_ms = device_ms(torch, call, RUNS)
    kern_ms = device_ms(torch, call, RUNS, match="delta")
    host = host_ms(torch, call, RUNS)
    plain_ms = time_cuda(torch, plain_delta, RUNS)
    flat = [gather(t).cuda() for t in targets]
    idx = (rows.cuda(),)
    vals = [torch.from_numpy(np.asarray(v)).cuda() for v in payload[1:]]
    library = lambda: [  # noqa: E731
        torch.index_put(x, idx, v) for x, v in zip(flat, vals)]
    lib_ms = time_cuda(torch, library, RUNS)
    lib_dev = device_ms(torch, library, RUNS)
    # The library on the call's footing: the same host payload split by
    # shard on the host and uploaded, then torch.index_put a shard.
    lib = library_delta(torch, np, targets, payload)
    check(all(torch.equal(g.parts[0][s], lib[s][j]) for j, g in
              enumerate(got) for s in range(w)),
          "K10a: differs from the library calls")
    lib_place_ms = time_cuda(torch, lambda: library_delta(
        torch, np, targets, payload), RUNS)
    out["sharded_base_delta"] = {r: dict(
        max_abs_err=delta_err, ms=ms, plain_ms=plain_ms,
        **bound(2 * n * 25 + r * 29, 0.0), library_ms=lib_ms,
        library_place_ms=lib_place_ms, device_ms=dev_ms,
        kernel_device_ms=kern_ms, library_device_ms=lib_dev,
        launches_per_call=delta_launches, shards=w, host_ms=host)}
    print(f"K10a: {r} payload rows over {w} shards of {n // w} equal the "
          f"plain version and the one-device scatter; {delta_launches} "
          f"launch(es) a call, {ms:.4f} ms a call, device {dev_ms} ms "
          f"(kernels {kern_ms}); index_put {lib_ms:.4f} ms (device "
          f"{lib_dev}), upload + "
          f"index_put a shard {lib_place_ms:.4f} ms; host span "
          f"{host:.4f} ms")
    # ---- K10b
    mesh, units, groups = rec["groups"]
    for g_pad, ids in groups.items():
        run = shard.sharded_group_capacity(mesh, g_pad)
        u_sh, i_sh = place(mesh, (units, ids), (("nodes",), ("nodes",)))
        got, n_launch = launches_of("group_capacity",
                                    lambda: run(u_sh, i_sh))
        per_call = card_launches([p.device for p in u_sh.parts[0]],
                                 combine=True)
        check(n_launch == per_call, f"K10b (g_pad {g_pad}): {n_launch} "
              f"launches a call, expected {per_call}")

        def plain_groups():
            from nomad_tpu_torch.ops.gang import group_capacity_plain

            return shard.group_capacity_combine_plain(torch.stack([
                group_capacity_plain(u, i, g_pad)
                for u, i in zip(u_sh.parts[0], i_sh.parts[0])]))

        want = plain_groups()
        check(torch.equal(got, want), f"K10b (g_pad {g_pad}): differs "
              "from the plain version")
        call = lambda: run(u_sh, i_sh)  # noqa: E731
        ms = time_cuda(torch, call, RUNS)
        dev_ms = device_ms(torch, call, RUNS)
        kern_ms = device_ms(torch, call, RUNS, match="group")
        host = host_ms(torch, call, RUNS)
        plain_ms = time_cuda(torch, plain_groups, RUNS)
        tu = torch.from_numpy(units).cuda()
        ti = torch.from_numpy(ids).cuda()
        keep = ti >= 0
        tu, ti = tu[keep].contiguous(), ti[keep].long().contiguous()
        library = lambda: torch.zeros(  # noqa: E731
            g_pad, device=tu.device).index_add_(0, ti, tu)
        lib_ms = time_cuda(torch, library, RUNS)
        lib_dev = device_ms(torch, library, RUNS)
        nn = units.shape[0]
        out.setdefault("group_capacity", {})[g_pad] = dict(
            max_abs_err=(got - want).abs().max().item(), ms=ms,
            plain_ms=plain_ms,
            **bound(nn * 8 + g_pad * 4, nn / INT32_OPS), library_ms=lib_ms,
            device_ms=dev_ms, kernel_device_ms=kern_ms,
            library_device_ms=lib_dev, launches_per_call=n_launch,
            shards=len(u_sh.parts[0]), host_ms=host)
        print(f"K10b (g_pad {g_pad}): equal to the plain version; "
              f"{n_launch} launch(es) a call, {ms:.4f} ms a call, device "
              f"{dev_ms} ms (kernels {kern_ms}); index_add_ {lib_ms:.4f} "
              f"ms (device {lib_dev}); host span {host:.4f} ms")
    # ---- K10c on the 512 + 512 eval's call: the one-card route (one
    # launch of K1's cluster kernel over the shards), then the per-shard
    # route on the same shards
    call = rec["greedy"][0]
    inputs, (penalty, seq), res = call
    b, k = res[0].shape
    route = scan_route(torch, inputs, seq, False)
    err, launches, want = hold_shards(torch, "K10c (512 + 512 eval)", call)
    check(launches == route_launches(route, shard_launches(b, k, w, seq)),
          f"K10c: {launches} launches a call on the {route} route")
    n = sum(sh.feasible.shape[1] for sh in inputs)
    g = inputs[0].feasible.shape[2]
    box = {}
    fresh = lambda: box.__setitem__(  # noqa: E731
        "s", [cloned(sh) for sh in inputs])
    ms = time_cuda(torch, lambda: shard.sharded_greedy_scan(
        box["s"], penalty, seq), RUNS, setup=fresh)
    dev_ms = device_ms(torch, lambda: shard.sharded_greedy_scan(
        box["s"], penalty, seq), RUNS, setup=fresh, match="cluster")
    again = [cloned(sh) for sh in inputs]  # its carry fills up: a span
    host = host_ms(torch, lambda: shard.sharded_greedy_scan(
        again, penalty, seq), 5)
    plain_ms = time_cuda(torch, lambda: shard.sharded_greedy_scan_plain(
        box["s"], penalty, seq), 1, setup=fresh, warmup=0)
    err_s, launches_s, _w = hold_shards(
        torch, "K10c per-shard route (512 + 512 eval)", call,
        force_shards=True, want=want)
    check(launches_s == shard_launches(b, k, w, seq),
          f"K10c per-shard route: {launches_s} launches a call")
    shards_ms = time_cuda(torch, lambda: shard.sharded_greedy_scan(
        box["s"], penalty, seq, force_shards=True), 5, setup=fresh,
        warmup=1)
    chain = chain_ms(torch, b * k if seq else k, torch.device("cuda"))
    tg = inputs[0].asks.tg_index
    rows, cells = rows_written(torch, res[0], tg, n, g)
    bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
              + b * k * (ASK_BYTES + 8) + b * (1 + g) + b * k * n * 4
              + rows * CARRY_ROW_BYTES + cells * 4)
    limit = bound(bytes_, max(b * k * n * 60 / FP32_FLOPS, chain / 1000.0))
    out["sharded_greedy_scan"] = {(b, k): dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, **limit,
        library_ms=None, chain_ms=chain, launches_per_call=launches,
        shards=w, device_ms=dev_ms, host_ms=host, **route)}
    out["sharded_greedy_scan_shards"] = {(b, k): dict(
        max_abs_err=err_s, ms=shards_ms, plain_ms=plain_ms, **limit,
        library_ms=None, chain_ms=chain, launches=launches_s,
        launches_per_call=launches_s, shards=w, route="shards")}
    print(f"K10c (B x K = {b} x {k}, seq {seq}, {w} shards): held against "
          f"the plain version and K1 on both routes; one card's cluster "
          f"{route}: {launches} launch a call, {ms:.4f} ms (device "
          f"{dev_ms}, host span {host:.4f}); per-shard route {launches_s} "
          f"launches a call, {shards_ms:.4f} ms")
    # ---- K10d on the storm's calls
    held = [hold_shards(torch, f"K10d storm call {i}", c)[:2]
            for i, c in enumerate(rec["topk"])]
    errs = [e for e, _n in held]
    inputs, (penalty, seq), res = rec["topk"][0]
    b, k = res[0].shape
    n = sum(sh.feasible.shape[1] for sh in inputs)
    ms = time_cuda(torch, lambda: shard.sharded_uniform_topk(
        box["s"], penalty, seq), RUNS,
        setup=lambda: box.__setitem__("s", [cloned(sh) for sh in inputs]))
    plain_ms = time_cuda(torch, lambda: shard.sharded_uniform_topk_plain(
        box["s"], penalty, seq), 3, warmup=1,
        setup=lambda: box.__setitem__("s", plain_windows(
            [cloned(sh) for sh in inputs])))
    dev_ms = device_ms(torch, lambda: shard.sharded_uniform_topk(
        box["s"], penalty, seq), RUNS,
        setup=lambda: box.__setitem__("s", [cloned(sh) for sh in inputs]),
        match="topk")
    score = torch.randn((b, n), device="cuda")
    lib_ms = time_cuda(torch, lambda: torch.topk(score, k, dim=1), RUNS)
    lib_dev = device_ms(torch, lambda: torch.topk(score, k, dim=1), RUNS)
    tg = inputs[0].asks.tg_index
    rows, cells = rows_written(torch, res[0], tg, n, g)
    nodes = torch.unique(res[0][res[0] >= 0]).numel()
    chain = chain_ms(torch, b if seq else 1, torch.device("cuda"))
    # As K2-seq's: the noise drawn in the kernel on one card (the keys
    # read, the draw's instructions); the per-shard path below reads K0's
    # windows instead.
    bytes_ = (n * (NODE_BYTES + 24) + b * n * (4 + 1 + 4)
              + b * (ASK_BYTES - 1 + 2) + b * 16 + b * k * (1 + 8)
              + nodes * 24 + rows * 4 + cells * 4)
    draw_s = b * n * k0_sass()["seconds_per_element"]
    out["sharded_uniform_topk"] = {b: dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        **bound(bytes_, max(b * n * 70 / FP32_FLOPS, draw_s,
                            chain / 1000.0)),
        library_ms=lib_ms, chain_ms=chain, launches_per_call=held[0][1],
        device_ms=dev_ms, library_device_ms=lib_dev, shards=w,
        calls_held=len(errs))}
    print(f"K10d: {len(errs)} storm calls (B x K = {b} x {k}, seq {seq}) "
          f"held against the plain version and K2; {held[0][1]} launch(es) "
          f"a call, {ms:.4f} ms a call, kernel {dev_ms} ms on the device; "
          f"torch.topk {lib_ms:.4f} ms a call, {lib_dev} ms on the device")
    # ---- K10d's per-shard path (csrc/sharded_topk.cu): the first storm
    # call's rows over 16 shards of one card, more than a cluster's 8
    wide = 16
    call = (resharded(torch, inputs, seq, wide), (penalty, seq), res)
    err, launches, _want = hold_shards(
        torch, f"K10d per-shard path ({wide} shards) storm call 0", call)
    want = b * (wide + 1) + wide if seq else 2 * wide + 1
    check(launches == want, f"K10d per-shard path: {launches} launches a "
          f"call, expected {want}")
    fresh = lambda: box.__setitem__(  # noqa: E731
        "s", [cloned(sh) for sh in call[0]])
    ms = time_cuda(torch, lambda: shard.sharded_uniform_topk(
        box["s"], penalty, seq), RUNS, setup=fresh)
    plain_ms = time_cuda(torch, lambda: shard.sharded_uniform_topk_plain(
        box["s"], penalty, seq), 3, warmup=1, setup=lambda: box.__setitem__(
            "s", plain_windows([cloned(sh) for sh in call[0]])))
    out["sharded_uniform_topk_shards"] = {b: dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        **bound(bytes_, max(b * n * 70 / FP32_FLOPS, chain / 1000.0)),
        library_ms=lib_ms, chain_ms=chain, launches=launches,
        launches_per_call=launches, shards=wide)}
    print(f"K10d per-shard path: the storm call on {wide} shards of one card "
          f"held against the plain version and K2; {launches} launches a "
          f"call, {ms:.4f} ms a call")
    return out


# ------------------------------------------- mesh: gang, defrag, convex


@contextlib.contextmanager
def batcher_for_schedulers(batcher):
    """``batcher`` as the process batcher of the port's default device
    while the block runs, so the dense schedulers (``service-convex-gpu``)
    dispatch through it: the port shards a base only on a batcher given
    a mesh, and has no automatic mesh yet."""
    from nomad_tpu_torch.device import default_device
    from nomad_tpu_torch.scheduler import batcher as batcher_mod

    dev = default_device()
    with batcher_mod._batchers_lock:
        before = batcher_mod._batchers.get(dev)
        batcher_mod._batchers[dev] = batcher
    try:
        yield
    finally:
        with batcher_mod._batchers_lock:
            if before is None:
                batcher_mod._batchers.pop(dev, None)
            else:
                batcher_mod._batchers[dev] = before


def joined(torch, outs, i):
    """Output ``i`` of a per-shard output list, joined in node order."""
    return torch.cat([o[i] for o in outs], dim=-1)


def dry_plan(h, kind, ev, seed):
    """One eval through ``kind`` on ``h``'s state, nothing committed:
    its plan (the rng from ``seed``, so two arms draw the same keys)."""
    from nomad_tpu_torch.scheduler import new_scheduler

    planner = _DryRunPlanner()
    new_scheduler(kind, logging.getLogger("smoke.mesh"), h.state.snapshot(),
                  planner, rng=random.Random(seed)).process_eval(ev.copy())
    check(len(planner.plans) == 1, f"{kind}: {len(planner.plans)} plans")
    return planner.plans[0]


def run_mesh_programs(seed, torch, total, main_h, storm_h, frag_h,
                      gang_programs):
    """Phase 9, the last three node-sharded programs on the 4-shard
    mesh: (a) the convex kernel (K10g) through ``service-convex-gpu`` on
    a mesh batcher, then a convex storm through its ``place_cohort``;
    (b) ``compute_defrag_plan(..., mesh=)`` (K10f); (c) phase 6's gang
    programs on a node-sharded GangState (K10e). Returns figures and the
    recorded calls for phase 7's holds (bench_mesh_programs)."""
    import numpy as np

    from nomad_tpu_torch.defrag import (
        WarmState,
        build_wave_evals,
        compute_defrag_plan,
    )
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.kernels.differential import judge_migration_plan
    from nomad_tpu_torch.ops.gang import GANG_MODE_FREE, \
        GANG_MODE_AFFINITY, gang_placement
    from nomad_tpu_torch.parallel.mesh import make_mesh, shard_gang_inputs
    from nomad_tpu_torch.scheduler.batcher import PlacementBatcher
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    mesh = make_mesh(devices=mesh_devices(torch))
    mb = PlacementBatcher(mesh=mesh)
    rec, figures = {}, {}
    relax_names = ("threefry_uniform", "expand_overlay",
                   "sharded_convex_relax", "sharded_convex_round")
    # ---- a. service-convex-gpu through the mesh batcher on phase 3's
    # cluster, beside the unsharded convex eval on the same state and key
    h = main_h
    steps = [("config 4 job (K = 8, ports + distinct_hosts)",
              storm_job("mesh-convex-star"), 8),
             ("512 + 512 two-group job (K = 1,024)",
              two_group_job_id("mesh-convex-two", 512), 1024)]
    for label, job, expect in steps:
        h.state.upsert_job(h.next_index(), job)
        job = h.state.job_by_id(job.id)
        ev = new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER)
        existing = {a.id for a in h.state.allocs_by_job(job.id)}
        host_n = host_oracle_count(h.state, ev, seed, existing)
        with Recorder(convex, "relaxed_pref") as one_rel:
            one_plan = dry_plan(h, "service-convex-gpu", ev, seed)
        with batcher_for_schedulers(mb), \
                ShardRecorder("sharded_relax") as rel, \
                ShardRecorder("sharded_convex_round") as rnd:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plan = counted(total, f"mesh convex eval, {label}", relax_names,
                           lambda: dry_plan(h, "service-convex-gpu", ev,
                                            seed))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        check(mb.stats()["sharded_bases"] >= 1,
              "mesh convex eval: the base was not sharded")
        fresh = new_allocs(plan, existing)
        check(len(fresh) == host_n == expect,
              f"mesh convex {label}: placed {len(fresh)}, host {host_n}")
        if expect == 8:
            check(len({a.node_id for a in fresh}) == 8,
                  f"mesh convex {label}: distinct_hosts violated")
        check(len(one_rel.calls) == len(rel.calls) == len(rnd.calls) == 1,
              f"mesh convex {label}: {len(rel.calls)} relaxations")
        pref = joined(torch, rel.calls[0][2], 2)
        one = one_rel.calls[0].out
        err = (pref - one).abs().max().item()
        if err > X_TOL:  # float32 drift: held by the float64 run
            args = _double(one_rel.calls[0].inputs)
            p64 = convex.relaxed_assignment_plain(*args)[2]
            far = (pref.double() - p64).abs().max().item()
            bound = 10 * (one.double() - p64).abs().max().item() + 1e-5
            check(bound < CHAOS_CAP and far <= bound,
                  f"mesh convex {label}: pref error {err}, float64 "
                  f"distance {far}, bound {bound}")
        mine, theirs = plan_nodes(plan), plan_nodes(one_plan)
        differ = sum(mine[k] != theirs.get(k) for k in mine)
        # Commit the mesh plan, then hold it as phase 8 holds its evals.
        allocs = [a for per in plan.node_allocation.values() for a in per]
        for a in allocs:
            a.job = job
        h.state.upsert_allocs(h.next_index(), allocs)
        check_placements(h.state, job, plan)
        figures[f"mesh_convex_eval_ms_{expect}"] = wall * 1000.0
        print(f"mesh convex eval, {label}: placed {len(fresh)} (host oracle "
              f"{host_n}) in {wall * 1000:.1f} ms; pref within {err:.3g} of "
              f"the unsharded eval's; {differ} of {len(mine)} placements "
              "differ from the unsharded eval's on the same state and key")
        rec[("eval", expect)] = (rel.calls[0], rnd.calls[0])
    # ---- a'. a convex storm through the mesh batcher, pre_resolve on
    storm = Storm(storm_h, mb)
    conv = lambda job, m: placement_config(job, m, True, "convex")  # noqa
    try:
        jobs = storm.jobs("mesh-convex", CONVEX_STORM_BATCH, storm_job)
        with ShardRecorder("sharded_relax") as rel, \
                ShardRecorder("sharded_convex_round") as rnd:
            rows, results, plans, lat, wall = counted(
                total, "mesh convex storm", relax_names,
                lambda: storm.round(jobs, 150_000, conv))
    finally:
        storm.close()
    placed = sum(len(a) for p in plans for a in p.node_allocation.values())
    conflicted = conflicted_evals(rows, results)
    figures.update(mesh_convex_storm_evals_per_s=CONVEX_STORM_BATCH / wall,
                   mesh_convex_storm_p99_ms=float(
                       np.percentile(lat, 99)) * 1000.0)
    print(f"mesh convex storm: {CONVEX_STORM_BATCH} evals of config 4's job "
          f"(pre_resolve, {MESH_SHARDS} shards) in {wall:.3f} s = "
          f"{CONVEX_STORM_BATCH / wall:.2f} evals/s; per-eval p50 "
          f"{np.percentile(lat, 50) * 1000:.2f} ms, p99 "
          f"{np.percentile(lat, 99) * 1000:.2f} ms; {placed} placed; "
          f"conflicted evals: {conflicted}")
    check_placed("mesh convex storm", results, placed,
                 CONVEX_STORM_BATCH * 8)
    check(conflicted == 0, f"mesh convex storm: {conflicted} conflicted")
    check(len(rel.calls) == len(rnd.calls) == CONVEX_STORM_BATCH,
          f"mesh convex storm: {len(rel.calls)} relaxations")
    rec["storm"] = list(zip(rel.calls, rnd.calls))
    # ---- b. the defrag solve over the mesh on phase 8's fragmented layout
    warm = WarmState()
    plans = {}
    with ShardRecorder("sharded_relax") as sol:
        for label in ("cold", "warm"):
            plan = counted(
                total, f"mesh defrag solve, {label}",
                ("sharded_defrag_solve",),
                lambda: compute_defrag_plan(
                    frag_h.state.snapshot(), ["dc1", "dc2"],
                    max_moves=DEFRAG_MOVES, min_gain=0.0, warm=warm,
                    class_compress=False, mesh=mesh))
            plans[label] = plan
            print(f"mesh defrag {label}: K = {plan.k} over {plan.n} nodes "
                  f"({MESH_SHARDS} shards), {plan.movable} movable, warm "
                  f"{plan.warm} ({plan.carried} carried), {plan.candidates} "
                  f"candidates, {len(plan.moves)} moves, fragmentation "
                  f"{plan.frag_before:.6f} -> {plan.frag_after:.6f}, round "
                  f"{plan.solve_ms:.1f} ms (host)")
            check(plan.frag_after <= plan.frag_before,
                  f"mesh defrag {label}: fragmentation rose")
            check(plan.warm == (label == "warm") and not plan.compressed,
                  f"mesh defrag {label}: warm {plan.warm}")
            check(plan.k == 512 and plan.n == BENCH_N,
                  f"mesh defrag {label}: K = {plan.k}, N = {plan.n}")
    check(len(sol.calls) == 2, f"{len(sol.calls)} sharded defrag solves")
    rec["defrag"] = dict(zip(plans, sol.calls))
    moves = plans["warm"].moves
    check(moves, "mesh defrag found no move")
    judged = 0
    for ev in build_wave_evals(frag_h.state.snapshot(), moves):
        ev_snap = frag_h.state.snapshot()
        seen = len(frag_h.plans)
        frag_h.process("service-gpu", ev)
        for wave_plan in frag_h.plans[seen:]:
            bad = judge_migration_plan(ev_snap, wave_plan)
            check(not bad, f"mesh defrag wave plan: {bad[:3]}")
            judged += 1
    print(f"mesh defrag wave: {len(moves)} moves, {judged} plans judged by "
          "judge_migration_plan (clean)")
    # ---- c. phase 6's gang programs on a node-sharded GangState
    for jid in ("g-free", "g-slice-ici", "b-spread"):
        call = gang_programs[jid]
        state, ask_res, ask_bw, ask_ports, active, key, config, _d = \
            call.inputs
        names = ("threefry_uniform", "sharded_gang_scan")
        # K10b sums the groups on the per-shard route only (distinct
        # cards); one card's cluster sums them in its launch.
        if config.mode not in (GANG_MODE_FREE, GANG_MODE_AFFINITY) \
                and len(set(mesh_devices(torch))) > 1:
            names += ("group_capacity",)
        with ShardRecorder("sharded_gang_scan") as gs:
            got = counted(total, f"mesh gang {jid}", names, lambda: (
                gang_placement(shard_gang_inputs(mesh, state), ask_res,
                               ask_bw, ask_ports, active, key, config)))
        want = call.out
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
              and int(got[2]) == int(want[2]),
              f"mesh gang {jid}: differs from K7 on the same call")
        rec[("gang", jid)] = gs.calls[0]
        print(f"mesh gang {jid} ({config.mode}, K = {active.shape[0]}, "
              f"g_pad {config.g_pad}): {int((got[0] >= 0).sum())} placed; "
              "choices, scores and slice group equal to K7's")
    return figures, rec


def gang_route(torch, shards, cfg):
    """The one-card route's plan of a recorded K10e call (as
    ``scan_route``'s)."""
    from nomad_tpu_torch.ops import scan
    from nomad_tpu_torch.ops.gang import _MODE_IDS
    from nomad_tpu_torch.parallel.shard import scan_ctas

    devices = [sh.state.capacity.device for sh in shards]
    cps = scan_ctas(devices)
    if not cps:
        return dict(route="shards")
    rows = [sh.state.capacity.shape[0] for sh in shards]
    plan = scan.gang_plan_for(devices[0], sum(rows), cfg.g_pad,
                              _MODE_IDS[cfg.mode], ctas=cps * len(rows),
                              segments=rows)
    return dict(route="cluster", ctas=plan.ctas, cps=plan.cps,
                threads=plan.threads, slice=plan.slice, form=plan.form,
                groups=plan.groups)


def bench_mesh_programs(torch, np, rec):
    """Holds and times of K10e, K10f, K10g-a and K10g-b on phase 9's own
    calls: the gang programs, the defrag solves (cold, warm), the 512 +
    512 convex eval's relaxation and rounding (B = 1 x K = 1,024) and
    the mesh convex storm's 64 (K = 8, each eval alone: all held, the
    first timed)."""
    from nomad_tpu_torch.parallel import shard

    dev = torch.device("cuda")
    out = {}
    w = MESH_SHARDS

    def rerun(fn, call):
        shards, args, res = call
        return fn([cloned(sh) for sh in shards], *cloned(args))

    # ---- K10e: the one-card route (one launch of K7's cluster kernel
    # over the shards), then the per-shard route on the same shards
    for jid in ("g-free", "g-slice-ici", "b-spread"):
        call = rec[("gang", jid)]
        shards, (active, gnoise, cfg), res = call
        label = f"K10e ({jid}, g_pad={cfg.g_pad})"
        got, launches = launches_of("sharded_gang_scan", lambda: rerun(
            shard.sharded_gang_scan, call))
        check(all(torch.equal(a, b) for a, b in zip(got, res)),
              f"{label}: the re-run differs from the recorded call")
        route = gang_route(torch, shards, cfg)
        k = active.shape[0]
        own = w + 1 if cfg.mode in ("slice", "spread") else 1
        per_shard = own + k * (w + 1) + w + 1
        check(launches == route_launches(route, per_shard),
              f"{label}: {launches} launches a call on the {route} route")
        plain = [cloned(sh) for sh in shards]
        ch_p, sc_p, sg_p = shard.sharded_gang_scan_plain(plain, active,
                                                         gnoise, cfg)
        errs = []
        for way, force in (("cluster", False), ("shards", True)):
            kern = [cloned(sh) for sh in shards]
            (ch, sc, sg), n_launch = launches_of(
                "sharded_gang_scan", lambda: shard.sharded_gang_scan(
                    kern, active, gnoise, cfg, force_shards=force))
            err = (sc - sc_p).abs().max().item()
            check(torch.equal(ch, ch_p) and int(sg) == int(sg_p)
                  and err <= SCORE_TOL,
                  f"{label} {way}: differs from the plain version (score "
                  f"error {err})")
            for a, b in zip(kern, plain):
                for name in ("util", "bw_used", "ports_free"):
                    check(torch.equal(getattr(a.state, name),
                                      getattr(b.state, name)),
                          f"{label} {way}: final {name} differs")
                check(torch.equal(a.placed, b.placed) and torch.equal(
                    a.group_members, b.group_members),
                    f"{label} {way}: placed or group members differ")
            errs.append((err, n_launch))
        (err, _one), (err_s, launches_s) = errs
        check(launches_s == per_shard, f"{label} per-shard route: "
              f"{launches_s} launches a call, expected {per_shard}")
        n = sum(sh.state.capacity.shape[0] for sh in shards)
        box = {}
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_gang_scan(
            box["s"], active, gnoise, cfg), RUNS, setup=setup)
        dev_ms = device_ms(torch, lambda: shard.sharded_gang_scan(
            box["s"], active, gnoise, cfg), RUNS, setup=setup,
            match="gang_cluster")
        again = [cloned(sh) for sh in shards]
        host = host_ms(torch, lambda: shard.sharded_gang_scan(
            again, active, gnoise, cfg), 5)
        shards_ms = time_cuda(torch, lambda: shard.sharded_gang_scan(
            box["s"], active, gnoise, cfg, force_shards=True),
            5 if k > 64 else RUNS, setup=setup, warmup=1)
        plain_ms = time_cuda(torch, lambda: shard.sharded_gang_scan_plain(
            box["s"], active, gnoise, cfg), 1, setup=setup, warmup=0)
        chain = chain_ms(torch, k, dev)
        rows = torch.unique(ch[ch >= 0]).numel()
        bytes_ = (n * 73 + 24 + k + k * n * 4 + cfg.g_pad * (4 + 4 * w)
                  + k * 8 + 4 + rows * 28)
        flops = k * n * 60 + n * 20
        limit = bound(bytes_, max(flops / FP32_FLOPS, chain / 1000.0))
        print(f"{label}: {int((ch_p >= 0).sum())} placed; both routes held "
              f"against the plain version (score error {err:.3g} / "
              f"{err_s:.3g}); one card's cluster {route}: {launches} launch "
              f"a call, {ms:.4f} ms (device {dev_ms}, host span "
              f"{host:.4f}); per-shard route {launches_s} launches a call, "
              f"{shards_ms:.4f} ms")
        out.setdefault("sharded_gang_scan", {})[(k, cfg.g_pad)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, **limit,
            library_ms=None, chain_ms=chain, launches_per_call=launches,
            shards=w, device_ms=dev_ms, host_ms=host, **route)
        out.setdefault("sharded_gang_scan_shards", {})[(k, cfg.g_pad)] = dict(
            max_abs_err=err_s, ms=shards_ms, plain_ms=plain_ms, **limit,
            library_ms=None, chain_ms=chain, launches=launches_s,
            launches_per_call=launches_s, shards=w, route="shards")
        torch.cuda.empty_cache()
    # ---- K10f on the defrag rounds' own calls
    for label, call in rec["defrag"].items():
        shards, (iters,), res = call
        got, launches = launches_of("sharded_defrag_solve", lambda: rerun(
            shard.sharded_relax, call))
        check(all(torch.equal(a, b) for o, r in zip(got, res)
                  for a, b in zip(o, r)),
              f"K10f {label}: the re-run differs from the recorded call")
        plain = shard.sharded_relax_plain([cloned(sh) for sh in shards],
                                          iters)
        kinds = ("logits", "x")
        kind_errs, far = hold_outputs(
            f"K10f {label}", [joined(torch, res, i) for i in (0, 1)],
            [joined(torch, plain, i) for i in (0, 1)],
            lambda: [joined(torch, shard.sharded_relax_plain(
                [_double(sh) for sh in shards], iters), i) for i in (0, 1)],
            kinds)
        err = (joined(torch, res, 1) - joined(torch, plain, 1)).abs().max() \
            .item()
        k, n = res[0][0].shape[0], sum(r[0].shape[1] for r in res)
        print(f"K10f {label} (K={k}, N={n}, {iters} iterations, {w} shards): "
              f"x absolute error {err:.3g}; in RELAX_TOLS' terms {kind_errs};"
              f" held by the float64 run {far}; {launches} launches a call")
        box = {}
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_relax(box["s"], iters),
                       RUNS, setup=setup)
        plain_ms = time_cuda(torch, lambda: shard.sharded_relax_plain(
            box["s"], iters), 3, warmup=1, setup=setup)
        bytes_ = k * n * 4 + n * (16 * 3 + 4 * 3 + 1) + k * 29 + 2 * k * n * 4
        figures = relax_call_figures(
            torch, f"K10f {label}", "sharded_defrag_solve",
            lambda a: shard.sharded_relax(a, iters), shards)
        out.setdefault("sharded_defrag_solve", {})[(label, k, n)] = dict(
            max_abs_err=err, errs=kind_errs, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(bytes_, k * n * (40 + 55 * iters) / FP32_FLOPS),
            library_ms=None, pass_bound_ms=design_bytes_ms(1, k, n, iters),
            shards=w, **figures)
        torch.cuda.empty_cache()
    # ---- K10g-a and K10g-b on the 512 + 512 eval and the storm
    for key, calls in (("eval", [rec[("eval", 1024)]]),
                       ("storm", rec["storm"])):
        errs, kinds, far, rerrs = [], {}, {}, []
        for ci, (rel_call, rnd_call) in enumerate(calls):
            shards, (iters, penalty), res = rel_call
            got, rel_launches = launches_of(
                "sharded_convex_relax",
                lambda: rerun(shard.sharded_relax, rel_call))
            check(all(torch.equal(a, b) for o, r in zip(got, res)
                      for a, b in zip(o, r)),
                  f"K10g-a {key}: the re-run differs from the recorded call")
            plain = shard.sharded_relax_plain(
                [cloned(sh) for sh in shards], iters, penalty)
            kind_errs, kind_far = hold_outputs(
                f"K10g-a {key}", [joined(torch, res, i) for i in range(3)],
                [joined(torch, plain, i) for i in range(3)],
                lambda: [joined(torch, shard.sharded_relax_plain(
                    [_double(sh) for sh in shards], iters, penalty), i)
                    for i in range(3)], ("logits", "x", "pref"))
            errs.append(max((joined(torch, res, i) - joined(torch, plain, i))
                            .abs().max().item() for i in (1, 2)))
            for kind, e in kind_errs.items():
                kinds[kind] = max(kinds.get(kind, 0.0), e)
            for kind, pair in kind_far.items():
                far[kind] = max(far.get(kind, pair), pair)
            rerr, rnd_launches, rnd_want = hold_shards(
                torch, f"K10g-b {key}", rnd_call)
            rb, rk = rnd_call[2][0].shape
            check(rnd_launches == route_launches(
                scan_route(torch, rnd_call[0], False, True),
                shard_launches(rb, rk, w, False)),
                f"K10g-b {key}: {rnd_launches} launches a call")
            rerrs.append(rerr)
            if ci == 0:
                shards_hold = hold_shards(
                    torch, f"K10g-b {key} per-shard route", rnd_call,
                    force_shards=True, want=rnd_want)
        rel_call, rnd_call = calls[0]
        shards, (iters, penalty), res = rel_call
        b, k, _n = res[0][2].shape
        n = sum(r[2].shape[-1] for r in res)
        g = shards[0].feasible.shape[2]
        print(f"K10g-a ({key}, B={b}, K={k}, N={n}, {w} shards): "
              f"{len(calls)} call(s) held, max x / pref absolute error "
              f"{max(errs):.3g}, in RELAX_TOLS' terms {kinds}; held by the "
              f"float64 run {far}; {rel_launches} launches a call; K10g-b: "
              f"choices and carry equal the plain version's and K8b's, max "
              f"score error {max(rerrs):.3g}; {rnd_launches} launches a call")
        box = {}
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_relax(
            box["s"], iters, penalty), RUNS, setup=setup)
        plain_ms = time_cuda(torch, lambda: shard.sharded_relax_plain(
            box["s"], iters, penalty), 3, warmup=1, setup=setup)
        figures = relax_call_figures(
            torch, f"K10g-a {key}", "sharded_convex_relax",
            lambda a: shard.sharded_relax(a, iters, penalty), shards)
        out.setdefault("sharded_convex_relax", {})[(key, k)] = dict(
            max_abs_err=max(errs), errs=kinds, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(relax_bytes(b, n, g, k, 1),
                    relax_flops(b, n, k, iters) / FP32_FLOPS),
            library_ms=None, pass_bound_ms=design_bytes_ms(b, k, n, iters),
            shards=w, calls_held=len(calls), **figures)
        shards, (penalty, *_s), res = rnd_call
        setup = lambda: box.update(s=[cloned(sh) for sh in shards])  # noqa
        ms = time_cuda(torch, lambda: shard.sharded_convex_round(
            box["s"], penalty), RUNS, setup=setup)
        dev_ms = device_ms(torch, lambda: shard.sharded_convex_round(
            box["s"], penalty), RUNS, setup=setup, match="cluster")
        again = [cloned(sh) for sh in shards]
        host = host_ms(torch, lambda: shard.sharded_convex_round(
            again, penalty), 5)
        shards_ms = time_cuda(torch, lambda: shard.sharded_convex_round(
            box["s"], penalty, force_shards=True), 5 if k > 64 else RUNS,
            setup=setup, warmup=1)
        plain_ms = time_cuda(torch, lambda: shard.sharded_convex_round_plain(
            box["s"], penalty), 1 if k > 64 else 3, warmup=0, setup=setup)
        chain = chain_ms(torch, k, dev)
        rows, cells = rows_written(torch, res[0], shards[0].asks.tg_index, n,
                                   g)
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g)
                  + 2 * b * k * n * 4 + rows * CARRY_ROW_BYTES + cells * 4)
        limit = bound(bytes_, max(b * k * n * 85 / FP32_FLOPS,
                                  chain / 1000.0))
        route = scan_route(torch, shards, False, True)
        err_s, launches_s, _w = shards_hold
        check(launches_s == shard_launches(b, k, w, False),
              f"K10g-b {key} per-shard route: {launches_s} launches a call")
        print(f"K10g-b ({key}, B={b}, K={k}): one card's cluster {route}: "
              f"{ms:.4f} ms a call (device {dev_ms}, host span {host:.4f}); "
              f"per-shard route held, {launches_s} launches a call, "
              f"{shards_ms:.4f} ms")
        out.setdefault("sharded_convex_round", {})[(key, k)] = dict(
            max_abs_err=max(rerrs), ms=ms, plain_ms=plain_ms, **limit,
            library_ms=None, chain_ms=chain,
            launches_per_call=rnd_launches, shards=w, calls_held=len(calls),
            device_ms=dev_ms, host_ms=host, **route)
        out.setdefault("sharded_convex_round_shards", {})[(key, k)] = dict(
            max_abs_err=err_s, ms=shards_ms, plain_ms=plain_ms, **limit,
            library_ms=None, chain_ms=chain, launches=launches_s,
            launches_per_call=launches_s, shards=w, route="shards")
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- convex

CONVEX_STORM_BATCH = 64
DEFRAG_MOVES = 8
# K8a / K9 against their plain versions (tests/test_torch_cuda.py
# assert_relax_agrees): logits relative to max(1, |logit|), x relative
# to its row's largest entry (a row sums to 1 over N nodes, so at N =
# 10,240 an absolute tolerance would pass a zero), pref absolute (its
# terms are already over their maxima). Past CHAOS_CAP from float64 a
# comparison holds nothing.
RELAX_TOLS = {"logits": 1e-4, "x": 1e-3, "pref": 1e-3}
CHAOS_CAP = 0.1
# The mesh convex eval's pref against the unsharded eval's, both on the
# card (tests/test_torch_convex.py X_TOL): the cross-shard softmax sums
# in another order.
X_TOL = 5e-3


def harness_sink(harness):
    """build_fragmented_cluster's writes into a Harness's store."""

    def put_job(job):
        harness.state.upsert_job(harness.next_index(), job)
        return harness.state.job_by_id(job.id)

    def put_node(node):
        harness.state.upsert_node(harness.next_index(), node)

    def put_allocs(allocs):
        harness.state.upsert_allocs(harness.next_index(), allocs)

    return put_job, put_node, put_allocs


def build_fragmented_cluster(n_nodes, put_job, put_node, put_allocs):
    """The defrag phases' cluster, tests/test_defrag.py's fragmented
    layout at full width: nodes of 1000 CPU / 1000 MB over dc1/dc2;
    two in five hold one 600/600 alloc of job "dfbig", two in five two
    300/300 allocs (jobs "dfs0", "dfs1"), one in five is empty. Every
    occupied node keeps 400 free, which fits a 300 but strands against
    a 600: consolidating the 300s is a strict fragmentation win. Job
    counts, alloc names and job references are the scheduler's, so a
    wave eval reconciles to the marked moves only. Written through
    ``put_job`` (returns the stored job), ``put_node`` and, after every
    node, ``put_allocs`` (``harness_sink``, ``server_sink``)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Resources, consts

    shapes = {"dfbig": 600, "dfs0": 300, "dfs1": 300}
    jobs = {}
    for jid, size in shapes.items():
        job = mock.job()
        job.id = job.name = jid
        job.datacenters = ["dc1", "dc2"]
        job.task_groups[0].count = 2 * n_nodes // 5
        task = job.task_groups[0].tasks[0]
        task.resources.cpu = task.resources.memory_mb = size
        task.resources.networks = []
        jobs[jid] = put_job(job)
    slot = Counter()
    allocs = []
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = ("dc1", "dc2")[i % 2]
        node.resources.cpu = node.resources.memory_mb = 1000
        node.reserved = None
        node.compute_class()
        put_node(node)
        for jid in {0: ("dfbig",), 1: ("dfbig",), 2: ("dfs0", "dfs1"),
                    3: ("dfs0", "dfs1")}.get(i % 5, ()):
            job = jobs[jid]
            a = mock.alloc()
            a.job, a.job_id, a.node_id = job, jid, node.id
            a.name = f"{jid}.{job.task_groups[0].name}[{slot[jid]}]"
            a.task_group = job.task_groups[0].name
            slot[jid] += 1
            a.resources = None
            a.shared_resources = None
            a.task_resources = {job.task_groups[0].tasks[0].name: Resources(
                cpu=shapes[jid], memory_mb=shapes[jid])}
            a.desired_status = consts.ALLOC_DESIRED_RUN
            a.client_status = consts.ALLOC_CLIENT_RUNNING
            allocs.append(a)
    put_allocs(allocs)


def run_convex(seed, torch, total, main_h, storm_h):
    """Phase 8 (see the module docstring). Returns the recorded K8a,
    K8b and K9 calls for phase 7's holds."""
    import numpy as np

    from nomad_tpu_torch.defrag import (
        WarmState,
        build_wave_evals,
        compute_defrag_plan,
    )
    from nomad_tpu_torch.kernels import convex, quality
    from nomad_tpu_torch.kernels.differential import (
        DEFAULT_SEEDS,
        judge_migration_plan,
        run_defrag_differential,
        run_differential,
        run_gang_differential,
    )
    from nomad_tpu_torch.scheduler import new_scheduler
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    rec = {}
    # ---- a. service-convex-gpu on the main path's cluster, beside a
    # greedy arm on the same state (dry run) for the quality board.
    h = main_h
    board = quality.get_board()
    board.reset()
    steps = [("config 4 job (K = 8, ports + distinct_hosts)",
              storm_job("convex-star"), 8),
             ("512 + 512 two-group job (K = 1,024)",
              two_group_job_id("convex-two", 512), 1024)]
    for label, job, expect in steps:
        h.state.upsert_job(h.next_index(), job)
        ev = new_eval(h.state.job_by_id(job.id),
                      consts.EVAL_TRIGGER_JOB_REGISTER)
        existing = {a.id for a in h.state.allocs_by_job(job.id)}
        host_n = host_oracle_count(h.state, ev, seed, existing)
        arms = {"greedy": [], "convex": []}
        # Dry runs on the same state, in turns (the first pays the base
        # build): greedy, convex, convex, greedy.
        for kernel in ("greedy", "convex", "convex", "greedy"):
            planner = _DryRunPlanner()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_scheduler(f"service-{kernel}-gpu",
                          logging.getLogger("smoke.ab"), h.state.snapshot(),
                          planner, rng=random.Random(seed)).process_eval(
                              ev.copy())
            torch.cuda.synchronize()
            placed = sum(len(new_allocs(p, existing)) for p in planner.plans)
            check(placed == host_n, f"{label}: {kernel} arm placed {placed}")
            arms[kernel].append(round((time.perf_counter() - t0) * 1000.0, 1))
        print(f"eval {label}, dry runs on the same state (ms, in turns): "
              f"greedy {arms['greedy']}, convex {arms['convex']}")
        n_plans = len(h.plans)
        with Recorder(convex, "relaxed_pref") as rel, \
                Recorder(convex, "convex_round") as rnd:
            share = device_share(torch, lambda: counted(
                total, f"convex eval, {label}",
                ("threefry_uniform", "convex_relax", "convex_round"),
                lambda: h.process("service-convex-gpu", ev)),
                f"convex eval, {label}")
        check(len(h.plans) == n_plans + 1, f"{label}: no plan submitted")
        plan = h.plans[-1]
        fresh = new_allocs(plan, existing)
        print(f"convex eval, {label}: placed {len(fresh)} (host oracle "
              f"{host_n}), {share['profiled_wall_ms']:.1f} ms under the "
              "profiler")
        check(len(fresh) == host_n == expect,
              f"{label}: convex placed {len(fresh)}, host {host_n}")
        check(h.evals[-1].status == consts.EVAL_STATUS_COMPLETE,
              f"{label}: eval status {h.evals[-1].status}")
        check_placements(h.state, h.state.job_by_id(job.id), plan)
        if expect == 8:
            check(len({a.node_id for a in fresh}) == 8,
                  f"{label}: distinct_hosts violated")
        check(len(rel.calls) == len(rnd.calls) == 1,
              f"{label}: {len(rel.calls)} relaxations")
        rec[("eval", expect)] = (rel.calls[0], rnd.calls[0])
    # ---- e. the quality board's medians, greedy and convex arms
    medians = board.snapshot()["kernels"]
    for kernel in ("greedy", "convex"):
        q = medians.get(kernel)
        check(q is not None and q["samples"] >= 4,
              f"quality board: {kernel} arm {q}")
        print(f"quality board, {kernel}: fragmentation median "
              f"{q['fragmentation']}, binpack_score median "
              f"{q['binpack_score']} ({q['samples']} evals)")
    # ---- b. a convex storm under pre_resolve on the storm's cluster
    storm = Storm(storm_h, get_batcher())
    conv = lambda job, m: placement_config(job, m, True, "convex")  # noqa
    try:
        jobs = storm.jobs("convex", CONVEX_STORM_BATCH, storm_job)
        with Recorder(convex, "relaxed_pref") as rel, \
                Recorder(convex, "convex_round") as rnd:
            rows, results, plans, lat, wall = counted(
                total, "convex storm", (
                    "threefry_uniform", "expand_overlay", "convex_relax",
                    "convex_round_seq"),
                lambda: storm.round(jobs, 130_000, conv))
    finally:
        storm.close()
    placed = sum(len(a) for p in plans for a in p.node_allocation.values())
    conflicted = conflicted_evals(rows, results)
    print(f"convex storm: {CONVEX_STORM_BATCH} evals of config 4's job "
          f"(pre_resolve) in {wall:.3f} s = "
          f"{CONVEX_STORM_BATCH / wall:.2f} evals/s; per-eval p50 "
          f"{np.percentile(lat, 50) * 1000:.2f} ms, p99 "
          f"{np.percentile(lat, 99) * 1000:.2f} ms; {placed} placed; "
          f"conflicted evals: {conflicted}")
    check_placed("convex storm", results, placed, CONVEX_STORM_BATCH * 8)
    check(conflicted == 0, f"convex storm: {conflicted} conflicted evals")
    check(len(rel.calls) == len(rnd.calls) == CONVEX_STORM_BATCH,
          f"convex storm: {len(rel.calls)} relaxations")
    rec["storm"] = list(zip(rel.calls, rnd.calls))
    storm = Storm(storm_h, get_batcher())
    try:
        more = storm.jobs("convex-p", CONVEX_STORM_BATCH, storm_job)
        device_share(torch, lambda: storm.round(more, 140_000, conv),
                     "convex storm round (64 evals, pre_resolve on)")
    finally:
        storm.close()
    # ---- c. the oracle differential rig on the card
    for label, fn, names in (
            ("convex", lambda: run_differential("convex"),
             ("convex_relax", "convex_round")),
            ("greedy", lambda: run_differential(
                "greedy", list(DEFAULT_SEEDS)[:3]), ("greedy_scan",)),
            ("gangs", run_gang_differential, ("gang_scan",)),
            ("defrag waves", run_defrag_differential, ("defrag_solve",))):
        t0 = time.perf_counter()
        report = counted(total, f"rig: {label}", names, fn)
        print(f"rig, {label}: {report['cases']} cases, green "
              f"{report['green']} ({time.perf_counter() - t0:.1f} s)")
        check(report["green"], f"rig {label}: {report['violations'][:3]}")
    # ---- d. defrag at full width. The main path's cluster has nothing
    # to defragment (every node's free space fits every ask there), so
    # this phase builds its own fragmented layout at the same width.
    from nomad_tpu_torch.scheduler.testing import Harness

    t0 = time.perf_counter()
    frag_h = Harness(seed=seed + 8)
    build_fragmented_cluster(N_NODES, *harness_sink(frag_h))
    print(f"defrag cluster: {N_NODES} nodes, {len(frag_h.state.allocs())} "
          f"allocs, built in {time.perf_counter() - t0:.1f} s (host)")
    warm = WarmState()
    dcs = ["dc1", "dc2"]
    plans = {}
    with Recorder(convex, "defrag_solve") as sol:
        for label, compress in (("cold", False), ("warm", False),
                                ("compressed cold", None),
                                ("compressed warm", None)):
            plan = counted(
                total, f"defrag solve, {label}", ("defrag_solve",),
                lambda: compute_defrag_plan(
                    frag_h.state.snapshot(), dcs, max_moves=DEFRAG_MOVES,
                    min_gain=0.0, warm=warm, class_compress=compress))
            plans[label] = plan
            width = (f"{plan.classes} classes" if plan.compressed
                     else f"{plan.n} nodes")
            print(f"defrag {label}: K = {plan.k} over {width}, "
                  f"{plan.movable} movable, warm {plan.warm} "
                  f"({plan.carried} carried), {plan.candidates} candidates, "
                  f"{len(plan.moves)} moves, fragmentation "
                  f"{plan.frag_before:.6f} -> {plan.frag_after:.6f}, "
                  f"round {plan.solve_ms:.1f} ms (host)")
            check(plan.frag_after <= plan.frag_before,
                  f"defrag {label}: fragmentation rose")
            check(plan.warm == label.endswith("warm"),
                  f"defrag {label}: warm {plan.warm}")
    check(plans["cold"].k == 512 and plans["cold"].n == BENCH_N,
          f"defrag cold: K = {plans['cold'].k}, N = {plans['cold'].n}")
    check(plans["compressed cold"].compressed, "no compressed solve")
    check(len(sol.calls) == 4, f"{len(sol.calls)} defrag solves")
    rec["defrag"] = dict(zip(plans, sol.calls))
    moves = plans["warm"].moves
    snap = frag_h.state.snapshot()
    evals = build_wave_evals(snap, moves)
    judged = 0

    def waves():
        nonlocal judged
        for ev in evals:
            ev_snap = frag_h.state.snapshot()
            seen = len(frag_h.plans)
            frag_h.process("service-gpu", ev)
            for wave_plan in frag_h.plans[seen:]:
                bad = judge_migration_plan(ev_snap, wave_plan)
                check(not bad, f"defrag wave plan: {bad[:3]}")
                judged += 1

    check(moves, "defrag found no move")
    t0 = time.perf_counter()
    # The wave evals' placements may take the host iterators (3 or fewer
    # a job): no kernel is required here.
    counted(total, "defrag waves", (), waves)
    for mv in moves:
        stored = frag_h.state.alloc_by_id(mv.alloc_id)
        check(stored.desired_status in (consts.ALLOC_DESIRED_STOP,
                                        consts.ALLOC_DESIRED_EVICT),
              f"moved alloc {mv.alloc_id} not stopped")
    print(f"defrag wave: {len(moves)} moves in {len(evals)} evals through "
          f"service-gpu, {judged} plans judged by judge_migration_plan "
          f"(clean) in {time.perf_counter() - t0:.1f} s")
    rec["frag_h"] = frag_h
    return rec


def relax_bytes(b, n, g, k, outputs):
    """Node rows, the carry, the counts and feasibility, every ask, read
    once; ``outputs`` [B,K,N] f32 arrays written once."""
    return (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
            + b * k * ASK_BYTES + b * (1 + g) + outputs * b * k * n * 4)


def relax_flops(b, n, k, iters):
    """A prologue of ~40 flops a pair (two pow), then per iteration ~55
    a pair (two exp, the six contractions and the gradient)."""
    return b * k * n * (40 + 55 * iters)


def relax_err(got, want, kind):
    """The largest error of a K8a / K9 output in RELAX_TOLS' terms."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    if kind == "logits":
        err = err / want.abs().clamp(min=1.0)
    elif kind == "x":
        err = err / want.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return err.max().item()


def hold_outputs(label, got, plain, plain64, kinds):
    """Each output within RELAX_TOLS of the plain version, or, where
    float32 rounding moves the sums (a chaotic instance), no farther
    from the float64 run (``plain64()``) than 10x the plain version's
    own distance, a bound under CHAOS_CAP. Returns ({kind: error},
    {kind: (the kernel's, the plain version's distance from float64)}
    for the outputs held so)."""
    errs, far, p64 = {}, {}, None
    for g, p, kind in zip(got, plain, kinds):
        errs[kind] = err = relax_err(g, p, kind)
        if err <= RELAX_TOLS[kind]:
            continue
        p64 = p64 or plain64()
        q = p64[kinds.index(kind)]
        far[kind] = (relax_err(g, q, kind), relax_err(p, q, kind))
        bound = 10 * far[kind][1] + 1e-5
        check(bound < CHAOS_CAP and far[kind][0] <= bound,
              f"{label}: {kind} error {err}, float64 distance "
              f"{far[kind][0]}, bound {bound}")
    return errs, far


def _double(x):
    """Float tensors, alone or in (named) tuples, as float64."""
    if isinstance(x, tuple):
        items = [_double(i) for i in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if hasattr(x, "dtype") and x.dtype.is_floating_point:
        return x.double()
    return x


def hold_relax(torch, label, call):
    """K8a on a recorded ``relaxed_pref`` call: the full launch on the
    call's inputs (logits, x and pref) gives the call's pref bit for
    bit and agrees with the plain version (hold_outputs). Returns
    (hold_outputs' two dicts, the largest absolute error of x and
    pref, the plain version's pref)."""
    from nomad_tpu_torch.kernels import convex

    args = cloned(call.inputs)
    got = convex.relaxed_assignment(*cloned(call.inputs))
    check(torch.equal(got[2], call.out),
          f"{label}: the full launch's pref differs from the path's")
    plain = convex.relaxed_assignment_plain(*args)
    errs, far = hold_outputs(
        label, got, plain,
        lambda: convex.relaxed_assignment_plain(*_double(args)),
        ("logits", "x", "pref"))
    abs_err = max((g - p).abs().max().item()
                  for g, p in zip(got[1:], plain[1:]))
    return (errs, far), abs_err, plain[2]


def hold_round(torch, label, call, pref):
    """K8b on a recorded call, fed the plain relaxation's pref, against
    its plain version fed the same: choices and carry equal, scores
    within SCORE_TOL. Returns (score error, the call's inputs with that
    pref)."""
    from nomad_tpu_torch.kernels import convex

    args = list(cloned(call.inputs))
    args[9] = pref
    k_args, p_args = cloned(tuple(args)), cloned(tuple(args))
    out_k = convex.convex_round(*k_args)
    out_p = convex.convex_round_plain(*p_args)
    err = check_scan(torch, label, (*out_k, k_args[4]), (*out_p, p_args[4]))
    return err, tuple(args)


def bench_convex(torch, np, rec):
    """Phase 7's holds and times for K8a, K8b and K9 on phase 8's own
    calls: the 512 + 512 eval (K = 1,024, N = 10,240), the convex storm
    (64 evals of K = 8 under seq, all held, the first timed), and the
    defrag solves (cold and warm at K = 512 x N = 10,240, and at the
    compressed width)."""
    from nomad_tpu_torch.kernels import convex

    dev = torch.device("cuda")
    out = {}

    # ---- K8a and K8b on the K = 1,024 eval and the storm
    for key, calls, name_round in (
            ("eval", [rec[("eval", 1024)]], "convex_round"),
            ("storm", rec["storm"], "convex_round_seq")):
        errs, kinds, far, rerrs = [], {}, {}, []
        held = []
        for rel_call, rnd_call in calls:
            (kind_errs, kind_far), err, pref = hold_relax(
                torch, f"K8a {key}", rel_call)
            rerr, args = hold_round(torch, f"K8b {key}", rnd_call, pref)
            errs.append(err)
            for kind, e in kind_errs.items():
                kinds[kind] = max(kinds.get(kind, 0.0), e)
            for kind, pair in kind_far.items():
                far[kind] = max(far.get(kind, pair), pair)
            rerrs.append(rerr)
            held.append(args)
        rel_call, rnd_call = calls[0]
        static = rel_call.inputs[:4]
        feas = rel_call.inputs[5]
        b, n, g = feas.shape
        k = rel_call.inputs[6].resources.shape[1]
        print(f"K8a ({key}, B={b}, K={k}, N={n}): {len(calls)} call(s) held, "
              f"max x / pref absolute error {max(errs):.3g}, in "
              f"RELAX_TOLS' terms {kinds}; held by the float64 run "
              f"(kernel's, plain's distance) {far}; K8b: choices and "
              f"carry equal, max score error {max(rerrs):.3g}")
        box = {}
        ms = time_cuda(torch, lambda: convex.relaxed_pref(*box["a"]),
                       RUNS, setup=lambda: box.update(
                           a=cloned(rel_call.inputs)))
        plain_ms = time_cuda(
            torch, lambda: convex.relaxed_assignment_plain(*box["a"]), 3,
            warmup=1, setup=lambda: box.update(a=cloned(rel_call.inputs)))
        it = convex.SOLVE_ITERS
        bytes_ = relax_bytes(b, n, g, k, 1)
        out.setdefault("convex_relax", {})[(key, k)] = dict(
            max_abs_err=max(errs), errs=kinds, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(bytes_, relax_flops(b, n, k, it) / FP32_FLOPS),
            library_ms=None, pass_bound_ms=design_bytes_ms(b, k, n, it),
            calls_held=len(calls),
            **relax_call_figures(torch, "K8a " + key, "convex_relax",
                                 lambda a: convex.relaxed_pref(*a),
                                 cloned(rel_call.inputs)))
        args = held[0]
        ms = time_cuda(torch, lambda: convex.convex_round(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(args)))
        plain_ms = time_cuda(
            torch, lambda: convex.convex_round_plain(*box["a"]),
            1 if k > 64 else 3, warmup=1,
            setup=lambda: box.update(a=cloned(args)))
        chain = chain_ms(torch, k, dev)
        ch = rnd_call.out[0]
        rows, cells = rows_written(torch, ch, args[6].tg_index, n, g)
        bytes_ = (n * NODE_BYTES + b * n * (CARRY_ROW_BYTES + 5 * g)
                  + b * k * (ASK_BYTES + 8) + b * (1 + g)
                  + 2 * b * k * n * 4 + rows * CARRY_ROW_BYTES + cells * 4)
        flops = b * k * n * (60 + 25)  # K1's step + bias and strand term
        fig = round_figures(torch, f"K8b {key}", name_round, args, ms)
        out.setdefault(name_round, {})[(key, k)] = dict(
            max_abs_err=max(rerrs), ms=ms, plain_ms=plain_ms,
            **bound(bytes_, max(flops / FP32_FLOPS, min(
                chain, fig["cluster_chain_ms"]) / 1000.0)),
            library_ms=None, chain_ms=chain, calls_held=len(calls), **fig)
        torch.cuda.empty_cache()
    # ---- K9 on the defrag rounds' own calls
    for label, call in rec["defrag"].items():
        args = cloned(call.inputs)
        plain = convex.defrag_solve_plain(*args)
        kind_errs, far = hold_outputs(
            f"K9 {label}", call.out, plain,
            lambda: convex.defrag_solve_plain(*_double(args)),
            ("logits", "x"))
        err = (call.out[1] - plain[1]).abs().max().item()
        k, w = args[0].shape
        iters = args[-1]
        print(f"K9 {label} (K={k}, W={w}, {iters} iterations): x absolute "
              f"error {err:.3g}; logits relative error "
              f"{kind_errs['logits']:.3g}, x over its row maximum "
              f"{kind_errs['x']:.3g}; held by the float64 run {far}")
        box = {}
        ms = time_cuda(torch, lambda: convex.defrag_solve(*box["a"]), RUNS,
                       setup=lambda: box.update(a=cloned(call.inputs)))
        plain_ms = time_cuda(
            torch, lambda: convex.defrag_solve_plain(*box["a"]), 3, warmup=1,
            setup=lambda: box.update(a=cloned(call.inputs)))
        # logits0 and the W rows and asks read once; logits and x out.
        bytes_ = k * w * 4 + w * (16 * 3 + 4 * 3 + 1) + k * 29 + 2 * k * w * 4
        out.setdefault("defrag_solve", {})[(label, k, w)] = dict(
            max_abs_err=err, errs=kind_errs, float64=far, ms=ms,
            plain_ms=plain_ms,
            **bound(bytes_, k * w * (40 + 55 * iters) / FP32_FLOPS),
            library_ms=None, pass_bound_ms=design_bytes_ms(1, k, w, iters),
            **relax_call_figures(torch, f"K9 {label}", "defrag_solve",
                                 lambda a: convex.defrag_solve(*a),
                                 cloned(call.inputs)))
        torch.cuda.empty_cache()
    barrier = barrier_us(torch)
    print(f"grid barrier: {barrier['barrier_us']:.3f} us a barrier and a "
          f"light phase over {barrier['barrier_grid']} blocks (loop-only "
          "solve, K = 1, 200 iterations against 0)")
    out["convex_relax"][("eval", 1024)].update(barrier)
    return out


def round_figures(torch, label, name, args, ms):
    """A K8b record's design figures on a call's arguments (``args``,
    convex_round's, read and not changed): the plan's cluster (CTAs,
    threads, resident or streamed, the noise and pref staged, the score
    cache), the launches of one call (counted around it, held to one),
    the cluster chain term at the plan's shape, the call's host span and
    profiler device time, the share of steps whose ask has the last
    one's resources, bandwidth and ports, and ``varied_ms``: the call on
    ``varied_asks`` (none alike: the cache serves no step), held against
    the plain version."""
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.ops import scan

    feas, asks = args[5], args[6]
    seq = len(args) > 10 and bool(args[10])
    dev = feas.device
    b, n, g = feas.shape
    k = asks.resources.shape[1]
    plan = scan.plan_for(dev, b, n, g, seq, bias=True)
    box = {}
    setup = lambda: box.update(a=cloned(args))  # noqa: E731
    setup()
    _out, launches = launches_of(
        name, lambda: convex.convex_round(*box["a"]))
    check(launches == 1, f"{label}: {launches} launches a call")
    varied = list(args)
    varied[6] = varied_asks(torch, asks, 7 + b)
    varied = tuple(varied)
    k_args, p_args = cloned(varied), cloned(varied)
    check_scan(torch, f"{label} (varied asks)",
               (*convex.convex_round(*k_args), k_args[4]),
               (*convex.convex_round_plain(*p_args), p_args[4]))
    vbox = {}
    total, alike, _active, _both = alike_steps(torch, asks)
    steps = (b if seq else 1) * k
    fig = dict(ctas=plan.ctas, threads=plan.threads, form=plan.form,
               stage_noise=plan.stage_noise, cache=plan.cache,
               waves=plan.waves, launches_per_call=launches,
               cluster_chain_ms=cluster_chain_ms(torch, steps, plan.ctas,
                                                 plan.threads, dev),
               alike_share=alike / total,
               varied_ms=time_cuda(
                   torch, lambda: convex.convex_round(*vbox["a"]), RUNS,
                   setup=lambda: vbox.update(a=cloned(varied))),
               host_ms=host_ms(torch, lambda: convex.convex_round(
                   *box["a"]), RUNS),
               device_ms=device_ms(torch, lambda: convex.convex_round(
                   *box["a"]), RUNS, setup=setup, match="greedy_cluster"))
    print(f"{label} (B={b}, K={k}, N={n}{', seq' if seq else ''}): "
          f"{plan.ctas} CTAs x {plan.threads} threads, {plan.form}, "
          f"{launches} launch a call, {ms:.4f} ms, device "
          f"{fig['device_ms']} ms, host span {fig['host_ms']:.4f} ms "
          f"({alike} of {total} steps alike); varied asks "
          f"{fig['varied_ms']:.4f} ms (equal to the plain version); cluster "
          f"chain {fig['cluster_chain_ms']:.4f} ms")
    return fig


def design_bytes_ms(b, k, n, iters):
    """The relaxation's per-iteration bytes at the HBM rate: ~18 B a
    pair an iteration (csrc/relax.cuh: phase A reads the logits and the
    mask, phase B the logits, lin and the mask and writes the logits),
    for ``iters`` iterations."""
    return iters * 18 * b * k * n / HBM_BYTES_S * 1000.0


def queued_ms(torch, fn, runs, host):
    """Device time a call of ``fn``: ``runs`` calls queued behind a sleep
    kernel that outlasts their host issue (``host`` ms a call), timed by
    CUDA events from the sleep's end to the last call's end. A
    cooperative launch's time under torch.profiler came out well below
    its CUDA-event time on this card, so the relaxation's records use
    this."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2.0e9 * 2.0 * runs * (host + 0.05) / 1000.0))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def relax_call_figures(torch, label, name, call, args):
    """One relaxation call's launches (counted around it, one a card),
    host span and device time (``queued_ms``), on ``args`` (read, not
    changed, by ``call``)."""
    _out, per_call = launches_of(name, lambda: call(args))
    check(per_call == 1, f"{label}: {per_call} launches a call, not 1")
    host = host_ms(torch, lambda: call(args), RUNS)
    dev = queued_ms(torch, lambda: call(args), RUNS, host)
    print(f"{label}: {per_call} launch a call; host span {host:.4f} ms, "
          f"device {dev:.4f} ms")
    return dict(launches_per_call=per_call, host_ms=host, device_ms=dev)


def barrier_us(torch):
    """One grid barrier (with a light phase beside it) on a grid as large
    as the card holds at once: the loop-only solve (kernels/convex.py
    mirror_descent) at K = 1 over 128 nodes a block, 200 iterations
    (two barriers each) against 0, in us a barrier."""
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.ops import relax

    blocks, sms = relax.occupancy(torch.device("cuda"), True)
    n = relax.COL_TILE * blocks * sms
    gen = torch.Generator(device="cuda").manual_seed(9)
    f = lambda *shape: torch.rand(*shape, device="cuda",  # noqa: E731
                                  generator=gen)
    args = [f(1, n), f(1, n), torch.zeros(1, n, device="cuda"), f(1, 4),
            f(1), f(1), f(n, 4), f(n), f(n, 4) + 1.0, f(n) + 1.0,
            f(n) + 1.0, torch.ones(1, device="cuda")]
    zero = time_cuda(torch, lambda: convex.mirror_descent(*args, 0), RUNS)
    many = time_cuda(torch, lambda: convex.mirror_descent(*args, 200), RUNS)
    grid = relax.grid_size(relax.relax_plan((n,), 1, 1), blocks, sms)
    return dict(barrier_us=(many - zero) / 400.0 * 1000.0,
                barrier_grid=grid)


REPLACES = {
    "threefry_uniform": ("nomad_tpu_torch/csrc/threefry.cu",
                         "nomad_tpu/ops/binpack.py:384"),
    "greedy_scan": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                    "nomad_tpu/ops/binpack.py:360"),
    "uniform_topk": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                     "nomad_tpu/ops/binpack.py:302"),
    "expand_overlay": ("nomad_tpu_torch/csrc/expand_overlay.cu",
                       "nomad_tpu/ops/binpack.py:533"),
    "base_delta": ("nomad_tpu_torch/csrc/base_delta.cu",
                   "nomad_tpu/ops/binpack.py:192"),
    "greedy_scan_seq": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                        "nomad_tpu/ops/binpack.py:461"),
    "uniform_topk_seq": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                         "nomad_tpu/ops/binpack.py:548"),
    "greedy_scan_stacked": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                            "nomad_tpu/ops/binpack.py:424"),
    "uniform_topk_stacked": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                             "nomad_tpu/ops/binpack.py:424"),
    "preempt_scan": ("nomad_tpu_torch/csrc/preempt_scan.cu",
                     "nomad_tpu/ops/preempt.py:85"),
    "gang_scan": ("nomad_tpu_torch/csrc/gang_scan.cu",
                  "nomad_tpu/ops/gang.py:150"),
    "convex_relax": ("nomad_tpu_torch/csrc/relax.cuh",
                     "nomad_tpu/kernels/convex.py:136"),
    "convex_round": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                     "nomad_tpu/kernels/convex.py:224"),
    "convex_round_seq": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                         "nomad_tpu/ops/binpack.py:461"),
    "defrag_solve": ("nomad_tpu_torch/csrc/relax.cuh",
                     "nomad_tpu/defrag/solver.py:213"),
    "sharded_base_delta": ("nomad_tpu_torch/csrc/base_delta.cu",
                           "nomad_tpu/parallel/shard.py:72"),
    "group_capacity": ("nomad_tpu_torch/csrc/group_capacity.cu",
                       "nomad_tpu/parallel/shard.py:109"),
    "sharded_greedy_scan": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                            "nomad_tpu/parallel/mesh.py:212"),
    "sharded_greedy_scan_shards": ("nomad_tpu_torch/csrc/sharded_scan.cu",
                                   "nomad_tpu/parallel/mesh.py:212"),
    "sharded_uniform_topk": ("nomad_tpu_torch/csrc/uniform_topk.cu",
                             "nomad_tpu/ops/binpack.py:302"),
    "sharded_uniform_topk_shards": ("nomad_tpu_torch/csrc/sharded_topk.cu",
                                    "nomad_tpu/ops/binpack.py:302"),
    "sharded_gang_scan": ("nomad_tpu_torch/csrc/gang_scan.cu",
                          "nomad_tpu/parallel/mesh.py:175"),
    "sharded_gang_scan_shards": ("nomad_tpu_torch/csrc/sharded_gang.cu",
                                 "nomad_tpu/parallel/mesh.py:175"),
    "sharded_defrag_solve": ("nomad_tpu_torch/csrc/relax.cuh",
                             "nomad_tpu/parallel/mesh.py:201"),
    "sharded_convex_relax": ("nomad_tpu_torch/csrc/relax.cuh",
                             "nomad_tpu/kernels/convex.py:136"),
    "sharded_convex_round": ("nomad_tpu_torch/csrc/greedy_scan.cu",
                             "nomad_tpu/kernels/convex.py:224"),
    "sharded_convex_round_shards": ("nomad_tpu_torch/csrc/sharded_scan.cu",
                                    "nomad_tpu/kernels/convex.py:224"),
}
# The shape each kernel's JSON record leads with (the others ride
# along under "shapes"). A record off the main paths (the per-shard
# routes of K10c, K10d, K10e and K10g-b) carries the launches of its own
# held call.
PRIMARY = {"threefry_uniform": 1, "greedy_scan": 1, "uniform_topk": 1,
           "expand_overlay": 1, "base_delta": 256,
           "greedy_scan_seq": (4, 1024), "uniform_topk_seq": 64,
           "greedy_scan_stacked": 4, "uniform_topk_stacked": 4,
           "preempt_scan": 1024, "gang_scan": (1024, 256),
           "convex_relax": ("eval", 1024), "convex_round": ("eval", 1024),
           "convex_round_seq": ("storm", 8),
           "defrag_solve": ("cold", 512, BENCH_N),
           "sharded_base_delta": 256, "group_capacity": BENCH_N,
           "sharded_greedy_scan": (1, BENCH_K),
           "sharded_greedy_scan_shards": (1, BENCH_K),
           "sharded_uniform_topk": 64, "sharded_uniform_topk_shards": 64,
           "sharded_gang_scan": (1024, 256),
           "sharded_gang_scan_shards": (1024, 256),
           "sharded_defrag_solve": ("cold", 512, BENCH_N),
           "sharded_convex_relax": ("eval", 1024),
           "sharded_convex_round": ("eval", 1024),
           "sharded_convex_round_shards": ("eval", 1024)}


# ------------------------------------------- system drain storm (config 5)

# The JAX package's bench config 5 (bench.py:940 ``config_5``):
# ``_system_drain_storm(10_000, 200, rack_partition=True)`` (bench.py:735)
# and ``_drain_migration_arm(1000, 20, 24)`` (bench.py:813).
SYSTEM_NODES = 10_000
SYSTEM_JOBS = 200
MIGRATION_NODES = 1_000
MIGRATION_JOBS = 20
MIGRATION_ALLOCS = 24
MIGRATION_BUDGET = 8
MIGRATION_DRAIN_FRAC = 0.1


def system_storm_cluster(n_nodes, n_jobs):
    """bench.py ``_system_drain_storm``'s cluster with the port's mock:
    node i in rack ``r{i % n_jobs}``, and system job ``sys-j`` held to
    rack ``rj`` by a constraint (cpu 5, 8 MB, no networks). Built once
    and upserted into each harness (the store copies), so node ids
    match across harnesses."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint

    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.meta["rack"] = f"r{i % n_jobs}"
        node.compute_class()
        nodes.append(node)
    jobs = []
    for j in range(n_jobs):
        job = mock.system_job()
        job.id = f"sys-{j}"
        job.constraints.append(Constraint(
            ltarget="${meta.rack}", operand="=", rtarget=f"r{j}"))
        res = job.task_groups[0].tasks[0].resources
        res.networks = []
        res.cpu = 5
        res.memory_mb = 8
        jobs.append(job)
    return nodes, jobs


def system_storm_harness(nodes, jobs, drained, seed):
    from nomad_tpu_torch.scheduler.testing import Harness

    h = Harness(seed=seed)
    for node in nodes:
        h.state.upsert_node(h.next_index(), node)
    for job in jobs:
        h.state.upsert_job(h.next_index(), job)
    for node_id in drained:
        h.state.update_node_drain(h.next_index(), node_id, True)
    return h


def timed_evals(h, factory, evals):
    """Each eval through ``h.process(factory, ...)`` in turn: (evals/s,
    p99 ms per eval), host clock."""
    import numpy as np

    lat = []
    start = time.perf_counter()
    for ev in evals:
        t0 = time.perf_counter()
        h.process(factory, ev)
        lat.append(time.perf_counter() - t0)
    elapsed = time.perf_counter() - start
    return len(evals) / elapsed, float(np.percentile(lat, 99)) * 1000.0


def storm_outcome(h, jobs):
    """Per job: its allocs as (node, task group, name), and its eval's
    status and queued counts (one eval update a processed eval)."""
    out = {}
    for job, ev in zip(jobs, h.evals):
        allocs = sorted((a.node_id, a.task_group, a.name)
                        for a in h.state.allocs_by_job(job.id))
        out[job.id] = (allocs, ev.status, ev.queued_allocations)
    return out


def run_system_drain(seed, total):
    """Config 5 through the port, both arms (bench.py ``config_5``).

    (a) The system drain storm: 10,000 nodes in 200 racks, 200
    rack-scoped system jobs, the first 10% of the nodes drained, one
    node-update eval a job through ``"system"`` on one harness and
    ``"system-gpu"`` on another holding the same nodes. Both are host
    passes (the JAX package's system-tpu does no device work either):
    no kernel may launch. Each is timed over its evals (evals/s, p99),
    then the two are held job by job: the same allocs (node, task group,
    name), eval status and queued counts, none on a drained node. The
    GC's pauses in each timed window are counted beside its p99.

    (b) The migration arm (bench.py ``_drain_migration_arm``): 1,000
    nodes, 20 service jobs x 24 allocs registered through
    ``service-gpu``, the 10% most occupied nodes drained, the node-update
    evals and the migration evals they create run through
    ``service-gpu`` under a migration budget of 8
    (``migrate.configure``, restored after), timed from the drain
    (migrations/s; p99 of each displaced alloc's drain-to-replacement
    time); bench.py's checks after the window; main-path kernels
    launched over the arm."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.ops import cuda
    from nomad_tpu_torch.structs import consts

    figures = {}
    nodes, jobs = system_storm_cluster(SYSTEM_NODES, SYSTEM_JOBS)
    drained = {n.id for n in nodes[:SYSTEM_NODES // 10]}
    outcomes = {}
    cuda.reset_launch_counts()
    for factory in ("system", "system-gpu"):
        t0 = time.perf_counter()
        h = system_storm_harness(nodes, jobs, sorted(drained), seed)
        build_s = time.perf_counter() - t0
        evals = []
        for job in jobs:
            ev = mock.eval()
            ev.job_id = job.id
            ev.type = consts.JOB_TYPE_SYSTEM
            ev.triggered_by = consts.EVAL_TRIGGER_NODE_UPDATE
            evals.append(ev)
        with GcPauses() as gc_pauses:
            rate, p99 = timed_evals(h, factory, evals)
        key = factory.replace("-", "_")
        figures[f"{key}_evals"] = len(evals)
        figures[f"{key}_evals_per_s"] = rate
        figures[f"{key}_p99_ms"] = p99
        figures[f"{key}_build_s"] = build_s
        gc_fig = gc_pauses.summary()
        figures[f"{key}_gc_gen2"] = gc_fig["gc_gen2_collections"]
        figures[f"{key}_gc_max_pause_ms"] = gc_fig["gc_max_pause_ms"]
        outcomes[factory] = storm_outcome(h, jobs)
        del h
    counts = cuda.launch_counts()
    require_no_launches(counts, "system drain storm", sorted(counts))
    host, dense = outcomes["system"], outcomes["system-gpu"]
    placed = 0
    for job_id, (allocs, status, queued) in dense.items():
        check((allocs, status, queued) == host[job_id],
              f"system drain storm: {job_id} differs between system "
              f"and system-gpu")
        check(status == consts.EVAL_STATUS_COMPLETE,
              f"system drain storm: {job_id} {status}")
        check(allocs, f"system drain storm: {job_id} placed nothing")
        check(not {a[0] for a in allocs} & drained,
              f"system drain storm: {job_id} placed on a drained node")
        placed += len(allocs)
    figures["system_placed"] = placed
    figures["system_drained"] = len(drained)
    print(f"system drain storm: {len(dense)} evals through each of system "
          f"and system-gpu, {placed} allocs placed, no launch")

    figures.update(run_migration_arm(seed, total))
    return figures


def run_migration_arm(seed, total):
    import numpy as np

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.migrate import (
        DEFAULT_MAX_PARALLEL,
        configure,
        get_governor,
    )
    from nomad_tpu_torch.ops import cuda
    from nomad_tpu_torch.scheduler.testing import Harness
    from nomad_tpu_torch.structs import consts
    from nomad_tpu_torch.structs.eval import new_eval

    h = Harness(seed=seed)
    nodes = []
    for _ in range(MIGRATION_NODES):
        node = mock.node()
        node.compute_class()
        h.state.upsert_node(h.next_index(), node)
        nodes.append(node)
    jobs = []
    for j in range(MIGRATION_JOBS):
        job = mock.job()
        job.id = f"mig-{j}"
        job.task_groups[0].count = MIGRATION_ALLOCS
        task = job.task_groups[0].tasks[0]
        task.resources.cpu = 20
        task.resources.memory_mb = 16
        task.resources.networks = []
        h.state.upsert_job(h.next_index(), job)
        jobs.append(h.state.job_by_id(job.id))
    cuda.reset_launch_counts()
    for job in jobs:
        h.process("service-gpu",
                  new_eval(job, consts.EVAL_TRIGGER_JOB_REGISTER))

    configure(migrate_max_parallel=MIGRATION_BUDGET)
    try:
        get_governor().reset_stats()
        # The most occupied nodes, as bench.py drains them: BestFit
        # packs the fleet onto few nodes, and draining where the allocs
        # live makes each eval's migrate set larger than the budget.
        occupancy = Counter(a.node_id for a in h.state.allocs()
                            if not a.terminal_status())
        by_load = sorted(occupancy, key=occupancy.get, reverse=True)
        n_drain = max(1, int(MIGRATION_NODES * MIGRATION_DRAIN_FRAC))
        drained = set(by_load[:n_drain])
        drained |= {n.id for n in nodes[: n_drain - len(drained)]}
        displaced = {a.id for a in h.state.allocs()
                     if a.node_id in drained and not a.terminal_status()}
        check(displaced, "migration arm: the drain displaced nothing")
        for node_id in drained:
            h.state.update_node_drain(h.next_index(), node_id, True)
        affected = [j for j in jobs
                    if any(a.node_id in drained
                           for a in h.state.allocs_by_job(j.id))]
        pending = [new_eval(j, consts.EVAL_TRIGGER_NODE_UPDATE)
                   for j in affected]
        seen = len(h.create_evals)
        done = []
        n_evals = 0
        t_drain = time.perf_counter()
        while pending:
            for ev in pending:
                h.process("service-gpu", ev)
                done.append((ev.id, time.perf_counter()))
            n_evals += len(pending)
            created = h.create_evals[seen:]
            seen = len(h.create_evals)
            pending = [e for e in created
                       if e.triggered_by == consts.EVAL_TRIGGER_MIGRATION]
        elapsed = time.perf_counter() - t_drain
        counts = cuda.launch_counts()
        total.update(counts)
        gov = get_governor().stats()
    finally:
        configure(migrate_max_parallel=DEFAULT_MAX_PARALLEL)

    disruption = {}
    for ev_id, t_done in done:
        for a in h.state.allocs_by_eval(ev_id):
            prev = a.previous_allocation
            if prev in displaced and prev not in disruption:
                disruption[prev] = t_done - t_drain
    migrated = [a for a in h.state.allocs() if a.id in displaced
                and a.desired_status == consts.ALLOC_DESIRED_STOP]
    check(migrated, "migration arm: nothing migrated")
    check(gov["high_water"] <= MIGRATION_BUDGET,
          f"migration arm: high water {gov['high_water']} over the budget")
    check(gov["deferred_total"] > 0,
          "migration arm: the budget deferred nothing")
    for job in jobs:
        live = [a for a in h.state.allocs_by_job(job.id)
                if not a.terminal_status()]
        check(len(live) == MIGRATION_ALLOCS,
              f"migration arm: {job.id} runs {len(live)} allocs")
        check(not any(a.node_id in drained for a in live),
              f"migration arm: {job.id} runs on a drained node")
    check(any(counts.get(k, 0) > 0 for k in MAIN_PATH_KERNELS),
          f"migration arm: no main-path kernel launched ({dict(counts)})")
    print(f"migration arm launches: {json.dumps(counts, sort_keys=True)}")
    p99 = (float(np.percentile(list(disruption.values()), 99))
           if disruption else 0.0)
    return {
        "migration_evals": n_evals,
        "migrations": len(migrated),
        "migrations_per_s": len(migrated) / elapsed,
        "disruption_p99_ms": p99 * 1000.0,
        "migration_budget": MIGRATION_BUDGET,
        "migration_high_water": gov["high_water"],
        "migration_deferred": gov["deferred_total"],
    }


# Phase 11 (c): config 4's storm shape with the runtime on and off, in
# pairs of arms, each arm on its own rounds of the same cluster. The
# pairs alternate their order (on-off, off-on, ...) so that a drift of
# the host over the phase cancels in the median of the pairs' ratios.
RUNTIME_ARMS = ("on", "off", "off", "on", "on", "off", "off", "on")
RUNTIME_ROUNDS = 3


def run_runtime_cost(seed, torch, total):
    """Phase 11 (c): the cost of the always-on runtime. A fresh cluster
    of the north-star shape; after a warm-up round, arms of
    RUNTIME_ROUNDS config 4 rounds (64 evals, pre_resolve on, each
    round's plans committed so the next base is a delta) with the flight
    recorder and the profiler both on or both off, in the order of
    RUNTIME_ARMS. Each arm's evals/s, per-eval p50/p99 and garbage
    collection, and each pair's on/off throughput and p99 ratios.
    Reports the ratios and fails on none: 64-eval rounds are too noisy
    for a gate. Both switches are on again when it returns."""
    import numpy as np

    from nomad_tpu_torch import profile, trace
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.scheduler.testing import Harness

    t0 = time.perf_counter()
    h = Harness(seed=seed + 11)
    build_cluster(h, N_NODES, ALLOCS_PER_NODE, seed + 11)
    print(f"runtime cluster: {N_NODES} nodes, built in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    rec, prof = trace.get_recorder(), profile.get_profiler()
    storm = Storm(h, get_batcher())
    on = lambda job, m: placement_config(job, m, True)  # noqa: E731
    arms = []
    try:
        storm.round(storm.jobs("rt-warm", STORM_BATCH, storm_job), 200_000,
                    on)

        def drive():
            for i, arm in enumerate(RUNTIME_ARMS):
                rec.set_enabled(arm == "on")
                prof.set_enabled(arm == "on")
                with GcPauses() as gc_pauses:
                    done = []
                    for r in range(RUNTIME_ROUNDS):
                        jobs = storm.jobs(f"rt{i}-{r}", STORM_BATCH,
                                          storm_job)
                        done.append(storm.round(
                            jobs, 210_000 + (i * RUNTIME_ROUNDS + r)
                            * STORM_BATCH, on))
                        storm.commit(done[-1][2])
                lat = [t for d in done for t in d[3]]
                wall = sum(d[4] for d in done)
                arms.append(dict(
                    arm=arm, evals=len(lat), evals_per_s=len(lat) / wall,
                    p50_ms=float(np.percentile(lat, 50)) * 1000.0,
                    p99_ms=float(np.percentile(lat, 99)) * 1000.0,
                    **gc_pauses.summary()))
                placed = sum(len(a) for d in done for p in d[2]
                             for a in p.node_allocation.values())
                check(placed == len(lat) * 8,
                      f"runtime arm {i} ({arm}): placed {placed}")

        counted(total, "runtime on/off storm", (
            "uniform_topk_seq", "expand_overlay", "base_delta"), drive,
            DRAWN_IN_SCANS)
    finally:
        rec.set_enabled(True)
        prof.set_enabled(True)
        storm.close()
    pairs = [(a, b) if a["arm"] == "on" else (b, a)
             for a, b in zip(arms[::2], arms[1::2])]
    ratios = [a["evals_per_s"] / b["evals_per_s"] for a, b in pairs]
    p99_ratios = [a["p99_ms"] / b["p99_ms"] for a, b in pairs]
    for arm in arms:
        print(f"runtime {arm['arm']}: {arm['evals']} evals, "
              f"{arm['evals_per_s']:.2f} evals/s, p50 {arm['p50_ms']:.2f} "
              f"ms, p99 {arm['p99_ms']:.2f} ms, gen-2 collections "
              f"{arm['gc_gen2_collections']}, longest pause "
              f"{arm['gc_max_pause_ms']:.1f} ms")
    print(f"runtime on/off throughput ratio by pair: "
          f"{[round(x, 4) for x in ratios]} (median "
          f"{statistics.median(ratios):.4f}); p99 ratio "
          f"{[round(x, 4) for x in p99_ratios]}")
    return {"cost_arms": arms, "cost_on_off_evals_per_s": ratios,
            "cost_on_off_median": statistics.median(ratios),
            "cost_on_off_p99": p99_ratios}


# ------------------------------------ config 8 through the Server (phase 12)

# The JAX package's bench config 8 (bench.py:1210 ``config_8``, the
# dense arm of ``_live_pipeline``, bench.py:985-1140) through the port's
# dev-mode Server on the ServerConfig default path (dispatch pipeline,
# no executive): 10,000 nodes, 5 filler allocs each, 60 jobs x 8 allocs
# with dynamic ports and distinct_hosts, 2 warm waves, 6 lone evals.
SERVER_NODES = 10_000
SERVER_ALLOCS_PER_NODE = 5
SERVER_JOBS = 60
SERVER_COUNT = 8
SERVER_WARM_WAVES = 2
SERVER_LONE = 6
SERVER_GREEDY_JOBS = 8
SERVER_GREEDY_COUNT = 512
# The pre_resolve-off wave: config 8's job and a two-group job of small
# asks without networks, whose rejections come back through the
# pipeline's conflict requeue; every eval must end complete. Then the
# same with phase 4's networked two-group asks: that wave collides so
# often that an eval can end failed on the scheduler's attempt limit
# (five plans in a row rejected whole: the reference's rule, to which
# tests/test_torch_server_e2e_parity.py holds the port, with the
# networked wave at a small size). It is held to what that rule fixes:
# every eval terminal, a failed one only on the attempt limit, every
# rejection of a dense plan explained by a commit its matrix could not
# see.
SERVER_OFF_JOBS = 4
SERVER_OFF_COUNT = 32
SERVER_NET_JOBS = 8
SERVER_NET_COUNT = 64
SERVER_WAIT_S = 300.0
# The kernels each window must launch. The storm's base is the warm
# waves' (their allocs were stopped again: the base is re-keyed, no
# delta); the greedy wave's is a delta of it after the storm's commits
# (K4), and with pre_resolve off the batched evals run K2's and K1's
# independent forms.
SERVER_KERNELS = {
    "storm": ("uniform_topk_seq", "expand_overlay"),
    "greedy": ("threefry_uniform", "greedy_scan_seq", "expand_overlay",
               "base_delta"),
    "pre_resolve off": ("uniform_topk", "greedy_scan", "expand_overlay"),
}


class ErrorRecords(logging.Handler):
    """Every ERROR (or worse) record of the port's loggers while the
    block runs: the server, workers, pipeline and applier log a failed
    eval or launch there."""

    def __init__(self, logger="nomad_tpu_torch"):
        super().__init__(level=logging.ERROR)
        self.records = []
        self._logger = logging.getLogger(logger)

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()}")

    def __enter__(self):
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)


class EvalClock:
    """When each eval reached a terminal status: wraps the FSM's
    eval_update handler (the commit every status change passes)."""

    def __init__(self, server):
        from nomad_tpu_torch.server import fsm as fsm_msgs
        from nomad_tpu_torch.structs import consts

        self.done = {}
        self.status = {}
        terminal = (consts.EVAL_STATUS_COMPLETE, consts.EVAL_STATUS_FAILED,
                    consts.EVAL_STATUS_CANCELLED)
        handlers = server.fsm._handlers
        inner = handlers[fsm_msgs.EVAL_UPDATE]

        def timed(index, payload):
            out = inner(index, payload)
            now = time.perf_counter()
            for ev in payload["evals"]:
                if ev.status in terminal and ev.id not in self.done:
                    self.done[ev.id] = now
                    self.status[ev.id] = ev.status
            return out

        handlers[fsm_msgs.EVAL_UPDATE] = timed

    def wait(self, label, eval_ids, timeout=SERVER_WAIT_S,
             allowed=("complete",)):
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            if all(e in self.done for e in eval_ids):
                break
            time.sleep(0.002)
        missing = [e for e in eval_ids if e not in self.done]
        check(not missing, f"{label}: {len(missing)} of {len(eval_ids)} "
              f"evals not terminal after {timeout:.0f} s")
        bad = {self.status[e] for e in eval_ids} - set(allowed)
        check(not bad, f"{label}: evals ended {sorted(bad)}")


class Batches:
    """The sizes of the pipeline's batches launched inside the block,
    each with its evals' conflict requeues: a batch smaller than
    ``dense_min_batch`` runs on the host factory."""

    def __init__(self, server):
        self.pipeline = server.dispatch
        self.seen = []

    def __enter__(self):
        launch = self.pipeline._launch

        def logged(batch):
            self.seen.append([entry.requeues for entry in batch])
            return launch(batch)

        self.pipeline._launch = logged
        return self

    def __exit__(self, *exc):
        del self.pipeline._launch

    def routed(self, min_batch):
        """The requeue counts of the evals in host-routed batches."""
        return [r for batch in self.seen if len(batch) < min_batch
                for r in batch]


class Rejections:
    """The applier's node rejections inside the block, by the dimension
    ``allocs_fit`` names and by kind: "ordinary" (an optimistic-
    concurrency loss: a commit after the plan's matrix), "host plan" (a
    plan of the host factory, which has no matrix: the applier cannot
    tell, and notes stale state to be safe) or "suspect" (a dense plan
    whose matrix's own snapshot refutes it: the device state was
    wrong), with the first suspects' details and the stale-state
    notes."""

    def __enter__(self):
        from nomad_tpu_torch.models import resident
        from nomad_tpu_torch.scheduler.util import proposed_allocs_for_node
        from nomad_tpu_torch.server import plan_apply
        from nomad_tpu_torch.structs import allocs_fit

        self.tally, self.stale, self.suspects = Counter(), 0, []
        self.plan_apply, self.resident = plan_apply, resident
        self.evaluate = plan_apply.evaluate_node_plan
        self.note = resident.note_rejection

        def evaluate(snapshot, plan, node_id):
            ok = self.evaluate(snapshot, plan, node_id)
            if not ok:
                node = snapshot.node_by_id(node_id)
                dim = "node"
                if node is not None and plan.node_allocation.get(node_id):
                    _, dim, _ = allocs_fit(node, proposed_allocs_for_node(
                        snapshot, plan, node_id))
                if plan.matrix_index < 0:
                    kind = "host plan"
                elif plan_apply.PlanApplier._ordinary_conflict(
                        snapshot, plan, node_id):
                    kind = "ordinary"
                else:
                    kind = "suspect"
                    base = getattr(snapshot, "base", snapshot)
                    self.suspects.append(dict(
                        eval=plan.eval_id, node=node_id,
                        matrix_index=plan.matrix_index,
                        node_index=getattr(node, "modify_index", None),
                        alloc_index=max((a.modify_index for a in
                                         base.allocs_by_node(node_id)),
                                        default=None)))
                self.tally[f"{dim}, {kind}"] += 1
            return ok

        def note():
            self.stale += 1
            return self.note()

        plan_apply.evaluate_node_plan = evaluate
        resident.note_rejection = note
        return self

    def __exit__(self, *exc):
        self.plan_apply.evaluate_node_plan = self.evaluate
        self.resident.note_rejection = self.note


def paused(server):
    """Pause every worker and the executive's drain, and wait until each
    is parked (outside any broker dequeue), so the evals registered next
    stay ready. A disabled executive counts as parked."""
    for w in server.workers:
        w.set_pause(True)
    server.executive.set_pause(True)
    deadline = time.perf_counter() + 10.0
    while not (all(w.parked() for w in server.workers)
               and server.executive.parked()):
        check(time.perf_counter() < deadline, "workers did not park")
        time.sleep(0.002)


def release(server):
    for w in server.workers:
        w.set_pause(False)
    server.executive.set_pause(False)


def server_job(job_id, count=SERVER_COUNT):
    """bench.py ``_live_pipeline``'s make_job for config 8: one group,
    dynamic ports, distinct_hosts, cpu 20, 16 MB."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Constraint, consts

    job = mock.job()
    job.id = job_id
    job.type = consts.JOB_TYPE_SERVICE
    tg = job.task_groups[0]
    tg.count = count
    tg.constraints.append(Constraint(operand=consts.CONSTRAINT_DISTINCT_HOSTS))
    tg.tasks[0].resources.cpu = 20
    tg.tasks[0].resources.memory_mb = 16
    return job


SERVER_ALLOC_CHUNK = 1_000  # nodes' filler allocs a log entry


def server_greedy_job(job_id, count, small=False):
    """Phase 4's two-group job in the server cluster's datacenter (the
    mock nodes are all in dc1), so its base is in the storm's family;
    ``small``: cpu 20, 16 MB and no networks in both groups."""
    job = two_group_job_id(job_id, count)
    job.datacenters = ["dc1"]
    if small:
        for tg in job.task_groups:
            res = tg.tasks[0].resources
            res.cpu, res.memory_mb, res.networks = 20, 16, []
    return job


def build_server_cluster(server, n_nodes, allocs_per_node, seed):
    """bench.py:1047-1069 through the log: each node by
    ``node_register``, then the filler allocs (cpu 50/100, memory
    64/128, no networks, from ``seed``) by ``alloc_update``, those of
    SERVER_ALLOC_CHUNK nodes an entry. (bench.py writes each node's
    allocs right after the node: the FSM's node_register reads a
    snapshot, so every later write copies the alloc table, quadratic in
    the cluster; the allocs and their values are the same.)"""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    rng = random.Random(seed)
    filler = mock.job()
    filler.id = "filler"
    filler.type = consts.JOB_TYPE_SERVICE
    filler.task_groups[0].tasks[0].resources.networks = []
    fills = []
    for i in range(n_nodes):
        node = mock.node()
        node.compute_class()
        server.log.apply("node_register", {"node": node})
        for _ in range(allocs_per_node):
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = filler.id
            alloc.job = filler
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = rng.choice([50, 100])
                tr.memory_mb = rng.choice([64, 128])
                tr.networks = []
            alloc.resources = None
            fills.append(alloc)
        if fills and ((i + 1) % SERVER_ALLOC_CHUNK == 0
                      or i + 1 == n_nodes):
            server.log.apply("alloc_update", {"allocs": fills})
            fills = []


def server_wave(server, clock, label, jobs):
    """Register ``jobs`` with every worker parked, release, and wait
    until each eval is complete. Returns (eval ids, released-at)."""
    paused(server)
    evs = [server.job_register(job)[0] for job in jobs]
    start = time.perf_counter()
    release(server)
    clock.wait(label, evs)
    return evs, start


def server_deregister(server, clock, label, jobs):
    """Deregister ``jobs`` the same way (their stop evals as one
    storm), so the next wave starts on an idle broker."""
    paused(server)
    evs = [server.job_deregister(job.id) for job in jobs]
    release(server)
    clock.wait(label, evs)


def check_server_state(server, jobs, count, label, distinct=True,
                       state=None):
    """Each job holds ``count`` live allocs (on ``count`` distinct
    nodes where the job asks for distinct hosts) in ``state`` (the
    server's store by default)."""
    state = state or server.fsm.state
    for job in jobs:
        live = [a for a in state.allocs_by_job(job.id)
                if not a.terminal_status()]
        check(len(live) == count,
              f"{label}: job {job.id} holds {len(live)} of {count} allocs")
        nodes = {a.node_id for a in live}
        check(not distinct or len(nodes) == count,
              f"{label}: job {job.id} on {len(nodes)} distinct nodes")


def check_server_nodes(server, state=None):
    """On every node of the final state (``state``, the server's store by
    default): no port held twice, and the live allocs fit
    (``allocs_fit``)."""
    from nomad_tpu_torch.structs import allocs_fit

    state = state or server.fsm.state
    checked = 0
    for node in state.nodes():
        live = state.allocs_by_node_terminal(node.id, False)
        seen = set()
        for a in live:
            for tr in (a.task_resources or {}).values():
                for net in tr.networks or []:
                    for port in (list(net.reserved_ports)
                                 + list(net.dynamic_ports)):
                        check(port.value not in seen,
                              f"node {node.id}: port {port.value} held "
                              "twice")
                        seen.add(port.value)
        fit, dim, _ = allocs_fit(node, live)
        check(fit, f"node {node.id} over capacity ({dim})")
        checked += 1
    return checked


def run_server_storm(seed, torch, total):
    """Phase 12 (see the module docstring): config 8 through the port's
    Server. Adds each window's launch counts to ``total``; returns the
    phase's figures."""
    import numpy as np

    from nomad_tpu_torch import trace
    from nomad_tpu_torch.scheduler.batcher import get_batcher
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.structs import Plan

    figures = {}
    with ErrorRecords() as errors:
        server = Server(ServerConfig(
            num_schedulers=4, scheduler_factories={"service": "service-gpu"},
            eval_nack_timeout=60.0))
        server.start()
        try:
            clock = EvalClock(server)
            t0 = time.perf_counter()
            build_server_cluster(server, SERVER_NODES,
                                 SERVER_ALLOCS_PER_NODE, seed + 11)
            figures["cluster_build_s"] = time.perf_counter() - t0
            print(f"server cluster: {SERVER_NODES} nodes, "
                  f"{len(server.fsm.state.allocs())} allocs through the "
                  f"log in {figures['cluster_build_s']:.1f} s (host)")
            batcher = get_batcher()
            for w in range(SERVER_WARM_WAVES):
                warm = [server_job(f"warm{w}-{j}")
                        for j in range(SERVER_JOBS)]
                t0 = time.perf_counter()
                server_wave(server, clock, f"server warm wave {w}", warm)
                check_server_state(server, warm, SERVER_COUNT,
                                   f"server warm wave {w}")
                server_deregister(server, clock, f"server warm dereg {w}",
                                  warm)
                print(f"server warm wave {w}: {SERVER_JOBS} jobs placed and "
                      f"stopped in {time.perf_counter() - t0:.1f} s")

            jobs = [server_job(f"e2e-{j}") for j in range(SERVER_JOBS)]
            stats0 = batcher.stats()
            pipe0 = server.dispatch.stats()
            applier0 = server.plan_applier.stats()
            trace.get_recorder().reset()
            with GcPauses() as gc_pauses, Batches(server) as launched, \
                    Rejections() as rej:
                evs, start = counted(
                    total, "server storm", SERVER_KERNELS["storm"],
                    lambda: server_wave(server, clock, "server storm",
                                        jobs), DRAWN_IN_SCANS)
            wall = max(clock.done[e] for e in evs) - start
            lat = [clock.done[e] - start for e in evs]
            check_server_state(server, jobs, SERVER_COUNT, "server storm")
            stats = stats_delta(stats0, batcher.stats())
            pipe = server.dispatch.stats()
            pipe_d = stats_delta(pipe0, pipe)
            applier = stats_delta(applier0, server.plan_applier.stats())
            placed = sum(len(server.fsm.state.allocs_by_job(j.id))
                         for j in jobs)
            check(placed == SERVER_JOBS * SERVER_COUNT,
                  f"server storm placed {placed}")
            # Two batch members may offer one dynamic port on a node
            # (the host draws ports per eval, in both packages): the
            # applier rejects the second, whose requeue can come back
            # alone and take the host route, as in the reference. No
            # storm eval goes to the host on its first delivery.
            retried = launched.routed(server.config.dense_min_batch)
            print(f"  batches launched (evals): "
                  f"{[len(b) for b in launched.seen]}; rejections "
                  f"{json.dumps(dict(rej.tally), sort_keys=True)}")
            check(pipe_d["routed_host"] == len(retried)
                  and all(r > 0 for r in retried),
                  f"server storm: {pipe_d['routed_host']} evals routed to "
                  f"the host, requeues {retried}")
            check(not rej.suspects, f"server storm: rejections of dense "
                  f"plans that their matrix cannot explain "
                  f"{json.dumps(rej.suspects[:5])}")
            batches = max(pipe_d["batches"], 1)
            done = pipe_d["acked"] + pipe_d["nacked"]
            figures.update(
                evals=SERVER_JOBS, placed=placed,
                evals_per_s=SERVER_JOBS / wall,
                p50_ms=float(np.percentile(lat, 50)) * 1000.0,
                p99_ms=float(np.percentile(lat, 99)) * 1000.0,
                dispatches=stats["dispatches"],
                occupancy=stats["batched_requests"]
                / max(stats["dispatches"], 1),
                stack_ms=stats["stack_us"] / 1000.0,
                issue_ms=stats["issue_us"] / 1000.0,
                sync_ms=stats["sync_us"] / 1000.0,
                pipeline_batches=pipe_d["batches"],
                pipeline_occupancy=pipe_d["dispatched_evals"] / batches,
                retries_per_eval=(pipe_d["requeues"]
                                  + pipe_d["inline_retries"])
                / max(done, 1),
                plan_conflicts=pipe_d["plan_conflicts"],
                routed_retries=len(retried),
                nodes_rejected=applier["nodes_rejected"],
                **gc_pauses.summary())
            print(f"server storm: {SERVER_JOBS} evals in {wall:.3f} s = "
                  f"{figures['evals_per_s']:.2f} evals/s; per eval from "
                  f"release to complete p50 {figures['p50_ms']:.2f} ms, p99 "
                  f"{figures['p99_ms']:.2f} ms; {placed} allocs placed")
            print(f"  batcher: {stats['dispatches']} dispatches, occupancy "
                  f"{figures['occupancy']:.1f}, stack "
                  f"{figures['stack_ms']:.1f} ms, issue "
                  f"{figures['issue_ms']:.1f} ms, sync "
                  f"{figures['sync_ms']:.1f} ms")
            print(f"  pipeline: {pipe_d['batches']} batches, occupancy "
                  f"{figures['pipeline_occupancy']:.1f}, retries per eval "
                  f"{figures['retries_per_eval']:.4f}, plan conflicts "
                  f"{pipe_d['plan_conflicts']}; applier: nodes rejected "
                  f"{applier['nodes_rejected']}, plans rejected "
                  f"{applier['plans_rejected']}")
            print(f"  garbage collection in the storm: "
                  f"{json.dumps(gc_pauses.summary(), sort_keys=True)}")
            # The flight recorder's stage table over the storm alone:
            # where an eval's time goes from the broker to the commit.
            stages = trace.get_recorder().stage_stats()
            check(stages.get("e2e", {}).get("count", 0) >= SERVER_JOBS,
                  f"server storm: the recorder completed "
                  f"{stages.get('e2e', {}).get('count', 0)} traces")
            figures["storm_stages"] = stages
            print("  stages (count, p50 / p99 / max ms): " + "; ".join(
                f"{k} {v['count']}, {v['p50_ms']} / {v['p99_ms']} / "
                f"{v['max_ms']}" for k, v in sorted(stages.items())))

            # The greedy wave: phase 4's two-group shape through the
            # server, held against the host oracle on the state before.
            greedy = [server_greedy_job(f"server-greedy-{i}",
                                        SERVER_GREEDY_COUNT)
                      for i in range(SERVER_GREEDY_JOBS)]
            want = greedy_oracle(server, greedy[0], seed)
            stats0 = batcher.stats()
            t0 = time.perf_counter()
            counted(total, "server greedy wave", SERVER_KERNELS["greedy"],
                    lambda: server_wave(server, clock, "server greedy wave",
                                        greedy))
            figures["greedy_wall_s"] = time.perf_counter() - t0
            st = stats_delta(stats0, batcher.stats())
            figures["greedy_dispatches"] = st["dispatches"]
            figures["greedy_base_deltas"] = st["base_delta_updates"]
            for job in greedy:
                live = [a for a in server.fsm.state.allocs_by_job(job.id)
                        if not a.terminal_status()]
                check(len(live) == want, f"server greedy wave: job {job.id} "
                      f"placed {len(live)}, the host oracle {want}")
                committed = Plan()
                for a in live:
                    committed.node_allocation.setdefault(
                        a.node_id, []).append(a)
                check_placements(server.fsm.state, job, committed)
            print(f"server greedy wave: {SERVER_GREEDY_JOBS} jobs x "
                  f"{2 * SERVER_GREEDY_COUNT} asks in "
                  f"{figures['greedy_wall_s']:.2f} s, {st['dispatches']} "
                  f"dispatch(es), {st['base_delta_updates']} base "
                  f"delta(s), sync {st['sync_us'] / 1000:.1f} ms; each "
                  f"placed {want} as the host oracle does")

            # With pre_resolve off (the ServerConfig knob, flipped for
            # one wave) the batched evals run independent scans (K2 and
            # K1) and collide; the applier's rejections come back
            # through the pipeline's conflict requeue.
            off_uniform = [server_job(f"server-off-{i}")
                           for i in range(SERVER_OFF_JOBS)]
            off_greedy = [server_greedy_job(f"server-off-greedy-{i}",
                                            SERVER_OFF_COUNT, small=True)
                          for i in range(SERVER_OFF_JOBS)]
            pipe0 = server.dispatch.stats()
            server.config.dense_pre_resolve = False
            try:
                counted(total, "server wave, pre_resolve off",
                        SERVER_KERNELS["pre_resolve off"],
                        lambda: server_wave(server, clock,
                                            "server wave, pre_resolve off",
                                            off_uniform + off_greedy))
            finally:
                server.config.dense_pre_resolve = True
            check_server_state(server, off_uniform, SERVER_COUNT,
                               "server wave, pre_resolve off")
            check_server_state(server, off_greedy, 2 * SERVER_OFF_COUNT,
                               "server wave, pre_resolve off",
                               distinct=False)
            pipe_d = stats_delta(pipe0, server.dispatch.stats())
            figures["off_plan_conflicts"] = pipe_d["plan_conflicts"]
            figures["off_requeues"] = pipe_d["requeues"]
            print(f"server wave with pre_resolve off: "
                  f"{2 * SERVER_OFF_JOBS} evals, plan conflicts "
                  f"{pipe_d['plan_conflicts']}, requeues "
                  f"{pipe_d['requeues']}, inline retries "
                  f"{pipe_d['inline_retries']}")
            figures["net"] = server_networked_wave(server, clock, total)

            # Lone evals on an idle broker: latency-aware routing sends
            # each to the host factory, so no kernel launches.
            routed0 = server.dispatch.stats()["routed_host"]
            lone_lat = lone_evals(
                server, clock, total, "server",
                [server_job(f"lone-{i}") for i in range(SERVER_LONE)],
                SERVER_COUNT)
            routed = server.dispatch.stats()["routed_host"] - routed0
            check(routed == SERVER_LONE,
                  f"server lone evals: routed_host {routed}, not "
                  f"{SERVER_LONE}")
            figures["lone_p99_ms"] = float(
                np.percentile(lone_lat, 99)) * 1000.0
            figures["lone_p50_ms"] = float(
                np.percentile(lone_lat, 50)) * 1000.0
            print(f"server lone evals: {SERVER_LONE}, all routed to the "
                  f"host; register to complete p50 "
                  f"{figures['lone_p50_ms']:.2f} ms, p99 "
                  f"{figures['lone_p99_ms']:.2f} ms")
            t0 = time.perf_counter()
            figures["nodes_checked"] = check_server_nodes(server)
            print(f"server final state: ports unique and allocs_fit on all "
                  f"{figures['nodes_checked']} nodes "
                  f"({time.perf_counter() - t0:.1f} s)")
            figures["pipeline"] = server.dispatch.stats()
            figures["applier"] = server.plan_applier.stats()
        finally:
            server.shutdown()
    check(not errors.records, f"server phase logged errors: "
          f"{errors.records[:5]}")
    return figures


def lone_evals(server, clock, total, label, jobs, count, distinct=True):
    """Register ``jobs`` one at a time on an idle broker, each waited on
    until complete and holding ``count`` allocs. Latency-aware routing
    sends each lone eval to the host factory, so the window fails on any
    launch. Returns each eval's seconds from register to complete."""

    def lone():
        out = []
        for job in jobs:
            t = time.perf_counter()
            ev, _ = server.job_register(job)
            clock.wait(f"{label} lone eval", [ev], 60.0)
            out.append(clock.done[ev] - t)
            check_server_state(server, [job], count, f"{label} lone eval",
                               distinct)
        return out

    return counted(total, f"{label} lone evals", (), lone, ANY_KERNEL)


def server_networked_wave(server, clock, total):
    """Phase 12's networked wave with pre_resolve off (see
    SERVER_NET_JOBS): held to every eval terminal, a failed eval only on
    the attempt limit, and no suspect rejection (``Rejections``);
    returns its outcome."""
    from nomad_tpu_torch.structs import consts

    label = "server networked wave, pre_resolve off"
    jobs = [server_greedy_job(f"server-net-{i}", SERVER_NET_COUNT)
            for i in range(SERVER_NET_JOBS)]
    pipe0 = server.dispatch.stats()
    server.config.dense_pre_resolve = False
    try:
        with Rejections() as rej:
            def wave():
                paused(server)
                evs = [server.job_register(job)[0] for job in jobs]
                t = time.perf_counter()
                release(server)
                clock.wait(label, evs, allowed=(consts.EVAL_STATUS_COMPLETE,
                                                consts.EVAL_STATUS_FAILED))
                return evs, time.perf_counter() - t

            evs, wall = counted(total, label, ("greedy_scan",
                                               "expand_overlay"), wave)
    finally:
        server.config.dense_pre_resolve = True
    state = server.fsm.state
    statuses = Counter()
    for e in evs:
        ev = state.eval_by_id(e)
        statuses[ev.status] += 1
        check(ev.status == consts.EVAL_STATUS_COMPLETE
              or ev.status_description.startswith("maximum attempts"),
              f"{label}: eval {e} {ev.status}: {ev.status_description!r}")
    check(not rej.suspects, f"{label}: rejections of dense plans that "
          f"their matrix cannot explain {json.dumps(rej.suspects[:5])}; "
          f"all rejections {json.dumps(rej.tally)}")
    pipe_d = stats_delta(pipe0, server.dispatch.stats())
    out = dict(
        evals=len(evs), wall_s=wall, statuses=dict(statuses),
        placed=sum(len([a for a in state.allocs_by_job(j.id)
                        if not a.terminal_status()]) for j in jobs),
        asks=2 * SERVER_NET_COUNT * len(jobs),
        rejections=dict(rej.tally), stale_notes=rej.stale,
        **{k: pipe_d[k] for k in ("batches", "plan_conflicts", "requeues",
                                  "inline_retries", "routed_host")})
    print(f"{label}: {len(evs)} evals of {2 * SERVER_NET_COUNT} networked "
          f"asks in {wall:.2f} s: {json.dumps(out, sort_keys=True)}")
    return out


def greedy_oracle(server, job, seed):
    """The placements the host "service" scheduler makes for ``job`` on
    the server's state as it stands (nothing committed)."""
    from nomad_tpu_torch.state import StateStore
    from nomad_tpu_torch.structs import consts, new_eval

    state = StateStore.restore(server.fsm.state.persist())
    state.upsert_job(state.latest_index() + 1, job)
    ev = new_eval(state.job_by_id(job.id), consts.EVAL_TRIGGER_JOB_REGISTER)
    return host_oracle_count(state, ev, seed, set())


# --------------- configs 8 and 6 through the executive, the live defrag
# loop (phase 13)

# bench.py's ``_live_pipeline`` runs its dense arm with the scheduler
# executive on (bench.py:1035-1039): config 8 (bench.py:1210) at phase
# 12's size, and config 6 (bench.py:1197: 1,000 nodes, no fillers, 120
# jobs x 4 allocs, no networks, no distinct_hosts; warm waves of
# max(40, 120) jobs; 12 lone evals).
EXECUTIVE_THREADS = 4
CONFIG6_NODES = 1_000
CONFIG6_JOBS = 120
CONFIG6_COUNT = 4
CONFIG6_LONE = 12
# The kernels each storm must launch (a tuple: any one of them): config
# 8's uniform distinct_hosts asks under pre_resolve (K5a uniform, or K2)
# and K3; config 6's greedy asks (K5a greedy) and K3.
EXECUTIVE_KERNELS = {
    "config 8": (("uniform_topk_seq", "uniform_topk"), "expand_overlay"),
    "config 6": ("greedy_scan_seq", "expand_overlay"),
}
# The live defrag loop (bench.py:2569 ``_defrag_churn_arm``'s knobs):
# phase 8's fragmented layout at 10,000 nodes through the Server's log,
# stepped by an injected clock.
DEFRAG_LIVE_ROUNDS = 6
DEFRAG_LIVE_MOVES = 16   # defrag_max_moves_per_wave
DEFRAG_LIVE_BUDGET = 16  # migrate_max_parallel
# bench.py's arm gates a round on a gain of 0.001 over 200 nodes; a wave
# of 16 moves over 10,000 nodes gains about 0.0005 (the fragmentation
# is a cluster-wide share), so the gate scales with the node count.
DEFRAG_LIVE_MIN_GAIN = 0.0001
DEFRAG_LIVE_STEP = 20_000.0  # the injected clock between rounds (s)


def config6_job(job_id):
    """bench.py ``_live_pipeline``'s make_job for config 6: one group of
    4, cpu 20, 16 MB, no networks, no distinct_hosts."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    job = mock.job()
    job.id = job_id
    job.type = consts.JOB_TYPE_SERVICE
    tg = job.task_groups[0]
    tg.count = CONFIG6_COUNT
    tg.tasks[0].resources.networks = []
    tg.tasks[0].resources.cpu = 20
    tg.tasks[0].resources.memory_mb = 16
    return job


class Cohorts:
    """The eval ids of each cohort the executive processed inside the
    block: a cohort smaller than ``dense_min_batch`` runs on the host
    factories."""

    def __init__(self, server):
        self.executive = server.executive
        self.seen = []

    def __enter__(self):
        process = self.executive._process_cohort

        def logged(batch):
            self.seen.append([entry.eval.id for entry in batch])
            return process(batch)

        self.executive._process_cohort = logged
        return self

    def __exit__(self, *exc):
        del self.executive._process_cohort

    def routed_first(self, min_batch):
        """The evals routed to the host on their first delivery (a
        redelivered eval that comes back alone takes the host route, as
        a conflict requeue does in phase 12)."""
        earlier, out = set(), []
        for cohort in self.seen:
            if len(cohort) < min_batch:
                out += [e for e in cohort if e not in earlier]
            earlier.update(cohort)
        return out


def executive_server(**over):
    from nomad_tpu_torch.server import Server, ServerConfig

    server = Server(ServerConfig(
        num_schedulers=4, scheduler_factories={"service": "service-gpu"},
        scheduler_executive=True, executive_threads=EXECUTIVE_THREADS,
        eval_nack_timeout=60.0, **over))
    server.start()
    return server


def executive_arm(label, prefix, seed, total, n_nodes, allocs_per_node,
                  job_of, n_jobs, count, distinct, lone, min_cohorts,
                  absent=(), then=None):
    """One dense arm of bench.py's ``_live_pipeline`` with the executive
    on (phase 13 (a) and (b)): the cluster through the log, two warm
    waves of ``n_jobs`` registered with the workers and the executive
    parked, the measured storm, then ``lone`` registrations on an idle
    broker; then ``then(server, clock)`` on the loaded server, before it
    stops. Adds each window's launch counts to ``total``; returns the
    arm's figures (with ``then``'s under "then")."""
    import numpy as np

    from nomad_tpu_torch import trace
    from nomad_tpu_torch.scheduler.batcher import get_batcher

    figures = {}
    with ErrorRecords() as errors:
        server = executive_server()
        try:
            check(server.executive.enabled and not server.dispatch.enabled,
                  f"{label}: executive {server.executive.enabled}, "
                  f"pipeline {server.dispatch.enabled}")
            clock = EvalClock(server)
            t0 = time.perf_counter()
            build_server_cluster(server, n_nodes, allocs_per_node, seed + 11)
            figures["cluster_build_s"] = time.perf_counter() - t0
            for w in range(SERVER_WARM_WAVES):
                warm = [job_of(f"{prefix}-warm{w}-{j}") for j in range(n_jobs)]
                server_wave(server, clock, f"{label} warm wave {w}", warm)
                check_server_state(server, warm, count,
                                   f"{label} warm wave {w}", distinct)
                server_deregister(server, clock, f"{label} warm dereg {w}",
                                  warm)
            print(f"{label}: {n_nodes} nodes, {len(server.fsm.state.allocs())}"
                  f" allocs through the log in "
                  f"{figures['cluster_build_s']:.1f} s; "
                  f"{SERVER_WARM_WAVES} warm waves of {n_jobs} jobs placed "
                  f"and stopped in {time.perf_counter() - t0:.1f} s (host)")

            jobs = [job_of(f"{prefix}-e2e-{j}") for j in range(n_jobs)]
            batcher = get_batcher()
            stats0 = batcher.stats()
            ex0 = server.executive.stats()
            applier0 = server.plan_applier.stats()
            trace.get_recorder().reset()
            with GcPauses() as gc_pauses, Cohorts(server) as cohorts:
                evs, start = counted(
                    total, f"{label} storm", EXECUTIVE_KERNELS[label],
                    lambda: server_wave(server, clock, f"{label} storm",
                                        jobs), absent)
            wall = max(clock.done[e] for e in evs) - start
            lat = [clock.done[e] - start for e in evs]
            check_server_state(server, jobs, count, f"{label} storm", distinct)
            placed = sum(len(server.fsm.state.allocs_by_job(j.id))
                         for j in jobs)
            check(placed == n_jobs * count, f"{label} storm placed {placed}")
            ex = stats_delta(ex0, server.executive.stats())
            st = stats_delta(stats0, batcher.stats())
            applier = stats_delta(applier0, server.plan_applier.stats())
            check(ex["cohorts"] >= min_cohorts and ex["fast_evals"] >= 1,
                  f"{label} storm: {ex['cohorts']} cohorts, "
                  f"{ex['fast_evals']} fast evals")
            check(st["cohort_dispatches"] > 0,
                  f"{label} storm: no cohort dispatch")
            check(ex["device_faults"] == 0,
                  f"{label} storm: {ex['device_faults']} device faults")
            routed = cohorts.routed_first(server.config.dense_min_batch)
            check(not routed, f"{label} storm: {len(routed)} evals routed "
                  f"to the host on their first delivery")
            stages = trace.get_recorder().stage_stats()
            check(stages.get("e2e", {}).get("count", 0) >= n_jobs,
                  f"{label} storm: the recorder completed "
                  f"{stages.get('e2e', {}).get('count', 0)} traces")
            final = server.executive.stats()
            figures.update(
                evals=n_jobs, placed=placed, evals_per_s=n_jobs / wall,
                p50_ms=float(np.percentile(lat, 50)) * 1000.0,
                p99_ms=float(np.percentile(lat, 99)) * 1000.0,
                cohort_sizes=[len(c) for c in cohorts.seen],
                executive=dict(
                    cohorts=ex["cohorts"],
                    occupancy=ex["cohort_evals"] / max(ex["cohorts"], 1),
                    largest_cohort=final["largest_cohort"],
                    fast_evals=ex["fast_evals"],
                    legacy_evals=ex["legacy_evals"],
                    legacy_reasons=final["legacy_reasons"],
                    plan_conflicts=ex["plan_conflicts"],
                    routed_host=ex["routed_host"],
                    device_faults=ex["device_faults"],
                    **{k: ex[k] for k in ("drain_us", "build_us",
                                          "dispatch_us", "finalize_us")}),
                dispatches=st["dispatches"],
                cohort_dispatches=st["cohort_dispatches"],
                sync_ms=st["sync_us"] / 1000.0,
                applier=applier, storm_stages=stages,
                **gc_pauses.summary())
            print(f"{label} storm: {n_jobs} evals in {wall:.3f} s = "
                  f"{figures['evals_per_s']:.2f} evals/s; per eval from "
                  f"release to complete p50 {figures['p50_ms']:.2f} ms, "
                  f"p99 {figures['p99_ms']:.2f} ms; {placed} allocs placed; "
                  f"cohorts {figures['cohort_sizes']}")
            print(f"  executive: {json.dumps(figures['executive'], sort_keys=True)}")
            print(f"  applier: {json.dumps(applier, sort_keys=True)}")
            print("  stages (count, p50 / p99 / max ms): " + "; ".join(
                f"{k} {v['count']}, {v['p50_ms']} / {v['p99_ms']} / "
                f"{v['max_ms']}" for k, v in sorted(stages.items())))

            # Lone evals on an idle broker: a cohort of one is smaller
            # than dense_min_batch, so each takes the host factory.
            routed0 = server.executive.stats()["routed_host"]

            lone_lat = lone_evals(
                server, clock, total, label,
                [job_of(f"{prefix}-lone-{i}") for i in range(lone)], count,
                distinct)
            routed = server.executive.stats()["routed_host"] - routed0
            check(routed == lone, f"{label} lone evals: routed_host "
                  f"{routed}, not {lone}")
            figures["lone_p50_ms"] = float(np.percentile(lone_lat, 50)) * 1e3
            figures["lone_p99_ms"] = float(np.percentile(lone_lat, 99)) * 1e3
            print(f"{label} lone evals: {lone}, all routed to the host; "
                  f"register to complete p50 {figures['lone_p50_ms']:.2f} "
                  f"ms, p99 {figures['lone_p99_ms']:.2f} ms")
            figures["nodes_checked"] = check_server_nodes(server)
            if then is not None:
                figures["then"] = then(server, clock)
        finally:
            server.shutdown()
    check(not errors.records, f"{label} logged errors: {errors.records[:5]}")
    return figures


def run_executive_storms(seed, torch, total, pipeline):
    """Phase 13 (a) and (b): configs 8 and 6 through the executive, and
    phase 15 (a) on (a)'s server. ``pipeline`` is phase 12's figures,
    printed beside (a)'s."""
    figures = {"config 8": executive_arm(
        "config 8", "x8", seed, total, SERVER_NODES, SERVER_ALLOCS_PER_NODE,
        server_job, SERVER_JOBS, SERVER_COUNT, True, SERVER_LONE, 1,
        DRAWN_IN_SCANS,
        then=lambda server, clock: run_api_config8(server, clock, total))}
    figures["api"] = figures["config 8"].pop("then")
    side = {k: (pipeline.get(k), figures["config 8"][k])
            for k in ("evals_per_s", "p50_ms", "p99_ms", "lone_p50_ms",
                      "lone_p99_ms")}
    print(f"config 8, pipeline (phase 12) against executive: "
          f"{json.dumps(side, sort_keys=True)}")
    print(f"server executive figures: "
          f"{json.dumps(figures['config 8'], sort_keys=True)}")
    phase("13 (b)", "config 6 through the executive")
    figures["config 6"] = executive_arm(
        "config 6", "x6", seed, total, CONFIG6_NODES, 0, config6_job,
        CONFIG6_JOBS, CONFIG6_COUNT, False, CONFIG6_LONE, 2)
    print(f"server config 6 figures: "
          f"{json.dumps(figures['config 6'], sort_keys=True)}")
    return figures


def server_sink(server):
    """build_fragmented_cluster's writes through the server's log: each
    job and node by its own entry, the allocs SERVER_ALLOC_CHUNK nodes'
    worth an entry, after every node (build_server_cluster's order)."""

    def put_job(job):
        server.log.apply("job_register", {"job": job})
        return server.fsm.state.job_by_id(job.id)

    def put_node(node):
        server.log.apply("node_register", {"node": node})

    def put_allocs(allocs):
        per = 2 * SERVER_ALLOC_CHUNK
        for at in range(0, len(allocs), per):
            server.log.apply("alloc_update", {"allocs": allocs[at:at + per]})

    return put_job, put_node, put_allocs


def run_live_defrag(seed, total):
    """Phase 13 (c): the live DefragLoop through the port's Server with
    the executive on, stepped by an injected clock (bench.py:2569
    ``_defrag_churn_arm``), each round's wave waited on until its evals
    are terminal. Adds the window's launch counts to ``total``; returns
    the figures."""
    import numpy as np

    from nomad_tpu_torch import trace
    from nomad_tpu_torch.defrag import cluster_fragmentation
    from nomad_tpu_torch.migrate import get_governor
    from nomad_tpu_torch.scheduler.util import ALLOC_MIGRATING
    from nomad_tpu_torch.structs import consts

    figures = {}
    dcs = ["dc1", "dc2"]
    with ErrorRecords() as errors:
        server = executive_server(
            migrate_max_parallel=DEFRAG_LIVE_BUDGET, defrag_enabled=True,
            defrag_interval=10_000.0, defrag_min_gain=DEFRAG_LIVE_MIN_GAIN,
            defrag_max_moves_per_wave=DEFRAG_LIVE_MOVES)
        # The loop's own thread would race the injected clock: stop it
        # and step the loop here.
        server.defrag.stop()
        loop = server.defrag
        try:
            clock = EvalClock(server)
            t0 = time.perf_counter()
            build_fragmented_cluster(N_NODES, *server_sink(server))
            print(f"live defrag cluster: {N_NODES} nodes, "
                  f"{len(server.fsm.state.allocs())} allocs through the log "
                  f"in {time.perf_counter() - t0:.1f} s (host)")
            get_governor().reset_stats()
            # Committed eviction legs of migrations, by alloc id.
            evicted = Counter()
            submit = server.plan_submit

            def recorded(plan):
                result = submit(plan)
                for victims in result.node_update.values():
                    for a in victims:
                        if a.desired_description == ALLOC_MIGRATING:
                            evicted[a.id] += 1
                return result

            server.plan_submit = recorded
            frag = [cluster_fragmentation(server.fsm.state.snapshot(), dcs)]
            trace.get_recorder().reset()
            routed0 = server.executive.stats()["routed_host"]
            settle_ms, waves, gains = [], [], []

            def rounds():
                for k in range(DEFRAG_LIVE_ROUNDS):
                    loop.tick(now=DEFRAG_LIVE_STEP * (k + 1))
                    gains.append(loop.last_gain)
                    wave = list(loop._wave)
                    t = time.perf_counter()
                    clock.wait(f"live defrag round {k}", wave)
                    settle_ms.append(
                        (max(clock.done[e] for e in wave) - t) * 1000.0
                        if wave else 0.0)
                    waves.append(len(wave))
                    frag.append(cluster_fragmentation(
                        server.fsm.state.snapshot(), dcs))

            # K9 each round. The replacements launch no scan: a wave
            # eval's marked allocs prefer the solver's target nodes, and
            # the scheduler places a preferred node on the host
            # (scheduler/generic.py _find_preferred_node, as in the
            # reference).
            counted(total, "live defrag", ("defrag_solve",), rounds)
            # Settle: release the last wave's governor slots.
            loop.configure(enabled=False)
            loop.tick(now=DEFRAG_LIVE_STEP * (DEFRAG_LIVE_ROUNDS + 1))
            st = loop.stats()
            gov = get_governor().stats()
            state = server.fsm.state
            moved = [a for a in state.allocs()
                     if a.desired_description == ALLOC_MIGRATING]
            replaced = Counter(a.previous_allocation for a in state.allocs()
                               if a.previous_allocation)
            check(st["rounds"] == DEFRAG_LIVE_ROUNDS and st["waves"] >= 1,
                  f"live defrag: {st['rounds']} rounds, {st['waves']} waves")
            check(len(moved) == st["moves_proposed"] == st["moves_completed"]
                  and set(evicted) == {a.id for a in moved},
                  f"live defrag: {len(moved)} allocs moved, "
                  f"{st['moves_proposed']} proposed, {st['moves_completed']} "
                  f"completed, {len(evicted)} evicted")
            for a in moved:
                check(evicted[a.id] == 1 and replaced[a.id] == 1
                      and a.desired_status == consts.ALLOC_DESIRED_STOP,
                      f"live defrag: alloc {a.id} evicted {evicted[a.id]} "
                      f"times, {replaced[a.id]} replacements, "
                      f"{a.desired_status}")
            check(gov["high_water"] <= DEFRAG_LIVE_BUDGET
                  and gov["in_flight"] == 0,
                  f"live defrag: governor {json.dumps(gov)}")
            check(all(b <= a + 1e-9 for a, b in zip(frag, frag[1:])),
                  f"live defrag: fragmentation rose: {frag}")
            check(st["cold_solves"] == 1
                  and st["warm_solves"] == DEFRAG_LIVE_ROUNDS - 1,
                  f"live defrag: {st['cold_solves']} cold, "
                  f"{st['warm_solves']} warm solves")
            check(st["stale_discards"] == 0 and st["waves_lost"] == 0,
                  f"live defrag: {st['stale_discards']} stale discards, "
                  f"{st['waves_lost']} waves lost")
            ex = server.executive.stats()
            solve = trace.get_recorder().stage_stats().get("defrag.solve", {})
            figures.update(
                rounds=st["rounds"], waves=st["waves"], wave_evals=waves,
                moves_proposed=st["moves_proposed"],
                moves_completed=st["moves_completed"],
                fragmentation=frag, gains=gains,
                first_cold_solve_ms=st["first_cold_solve_ms"],
                min_warm_solve_ms=st["min_warm_solve_ms"],
                last_warm_solve_ms=st["last_warm_solve_ms"],
                solve_stage={k: solve.get(k) for k in ("count", "p50_ms",
                                                       "p99_ms", "max_ms")},
                wave_settle_ms=settle_ms, governor=gov,
                wave_legacy_evals=ex["legacy_reasons"].get(
                    f"trigger {consts.EVAL_TRIGGER_DEFRAG!r}", 0),
                wave_routed_host=ex["routed_host"] - routed0,
                settle_p50_ms=float(np.percentile(settle_ms, 50)))
            print(f"live defrag: {st['rounds']} rounds, {st['waves']} waves "
                  f"({waves} evals), {len(moved)} allocs moved, each evicted "
                  f"once with one replacement; fragmentation "
                  f"{' -> '.join(f'{f:.6f}' for f in frag)}; cold solve "
                  f"{st['first_cold_solve_ms']:.1f} ms, warm min "
                  f"{st['min_warm_solve_ms']:.1f} ms (host spans); governor "
                  f"high water {gov['high_water']} of {DEFRAG_LIVE_BUDGET}")
        finally:
            server.shutdown()
    check(not errors.records, f"live defrag logged errors: "
          f"{errors.records[:5]}")
    return figures


# Phase 14: the multi-server control plane. Three servers a cluster,
# each as phase 13's (the executive, 4 workers, 4 executive threads,
# service-gpu, nack timeout 60 s). The load goes through the leader's raft
# log from CLUSTER_WRITERS threads at once; a filler entry carries
# CLUSTER_ALLOC_CHUNK nodes' allocs (500 allocs: phase 12's entries of
# 5,000 would hold every follower's apply for a large part of the 150 ms
# election floor).
CLUSTER_SERVERS = 3
CLUSTER_WRITERS = 4
CLUSTER_ALLOC_CHUNK = 100
CLUSTER_WAIT_S = 60.0
CLIENT_HEARTBEAT_S = 5.0
# Phases 14 (a) and (c) draw each election timeout from [1 s, 2 s), as
# hashicorp/raft's default config does (HeartbeatTimeout and
# ElectionTimeout 1 s, each timer randomized up to twice that). The
# port's 150-300 ms floor suits one server a process; three servers in
# one interpreter share its GIL, and the storm's threads held a
# follower's timer past 300 ms often enough to elect a new leader
# mid-storm, whose broker no longer holds the tokens of the old
# leader's plans (each then fails with an ERROR record). Phase 14 (b)
# measures an election and keeps the port's own timeouts.
CLUSTER_ELECTION_TIMEOUT_S = (1.0, 2.0)
# Phase 14 (a)'s warm waves: one, not config 8's two, to keep the whole
# run inside its wall-time budget (the second warm wave took 8-9 s on the
# H100's host and is held to nothing the first is not).
CLUSTER_WARM_WAVES = 1
# The kernels the failover storm must launch after the disconnect: the
# greedy scan, K3, and K0 or K4 (the scan reads K0's noise at B = 64 on
# 16 CTAs; the new leader's base is the warm waves' re-keyed, since they
# stop what they place, so K4 fuses no delta there).
FAILOVER_KERNELS = ("greedy_scan_seq", "expand_overlay",
                    ("threefry_uniform", "base_delta"))


@contextlib.contextmanager
def election_timeouts(low, high):
    """Raft's election timeouts drawn from [low, high) s while the block
    runs (the port reads ``ELECTION_TIMEOUT_MIN`` and ``_MAX`` each time
    it arms a timer and each time it weighs a PreVote); the port's own
    after it. Every server the block starts is shut down inside it."""
    from nomad_tpu_torch.server import raft

    saved = raft.ELECTION_TIMEOUT_MIN, raft.ELECTION_TIMEOUT_MAX
    raft.ELECTION_TIMEOUT_MIN, raft.ELECTION_TIMEOUT_MAX = low, high
    try:
        yield
    finally:
        raft.ELECTION_TIMEOUT_MIN, raft.ELECTION_TIMEOUT_MAX = saved


def settle_heap():
    """Move every object the collector tracks out of its reach
    (``gc.freeze``), as ``bulk_load`` does after a load: called before
    each wave of a cluster phase, so that the wave's gen-2 collections
    walk only the objects made since. A gen-2 pause stops every thread,
    and a pause past the 150 ms election floor elects a new leader
    mid-storm, when it walks the earlier waves' objects; the leader's
    in-flight plans then fail with an ERROR record. Only inside
    ``running_cluster``, whose exit gives the objects back."""
    gc.freeze()


@contextlib.contextmanager
def bulk_load():
    """The collector off while the block loads a cluster, then every
    object it tracks (the loaded cluster, three stores' worth) moved out
    of its reach (``gc.freeze``, no collection first), as a long-lived
    server process would after loading its state: a gen-2 collection
    over three 10,000-node stores stops every thread, raft's heartbeats
    and election timers included, for well over the 150 ms election
    floor (one store's gen-2 pause was 1.3-1.5 s on the H100's host in
    phases 12 and 13). ``gc.unfreeze`` gives them back."""
    gc.disable()
    try:
        yield
    finally:
        gc.freeze()
        gc.enable()


def cluster_server(**over):
    from nomad_tpu_torch.server import Server, ServerConfig

    return Server(ServerConfig(
        num_schedulers=4, scheduler_factories={"service": "service-gpu"},
        scheduler_executive=True, executive_threads=EXECUTIVE_THREADS,
        eval_nack_timeout=60.0, **over))


def inmem_cluster():
    """CLUSTER_SERVERS servers over one InmemTransport (start_with_raft),
    each with its EvalClock; returns (transport, servers, clocks)."""
    from nomad_tpu_torch.server.raft import InmemTransport

    transport = InmemTransport()
    ids = [f"s{i}" for i in range(CLUSTER_SERVERS)]
    servers, cluster = [], {}
    for node_id in ids:
        server = cluster_server(node_name=node_id)
        server.start_with_raft(node_id, ids, transport, cluster)
        servers.append(server)
    return transport, servers, [EvalClock(s) for s in servers]


def stable_leader(servers, label, timeout=CLUSTER_WAIT_S):
    """The one leader every server names, once its election barrier has
    committed and it still leads 0.5 s later (a boot can flap)."""
    deadline = time.perf_counter() + timeout

    def settled():
        leaders = [s for s in servers
                   if s.raft is not None and s.is_leader()]
        if len(leaders) != 1 or any(s.raft is None or s.raft.leader_id
                                    != leaders[0].node_id for s in servers):
            return None
        raft = leaders[0].raft
        if raft.known_commit_index() < raft._term_start_index:
            return None
        return leaders[0], raft.stats()["term"]

    while True:
        check(time.perf_counter() < deadline,
              f"{label}: no stable leader after {timeout:.0f} s: "
              f"{[s.raft and s.raft.stats() for s in servers]}")
        first = settled()
        if first is None:
            time.sleep(0.01)
            continue
        time.sleep(0.5)
        if settled() == first:
            return first[0]


def cluster_paused(servers):
    for server in servers:
        paused(server)


def cluster_release(servers):
    for server in servers:
        release(server)


def caught_up(servers, leader, label, timeout=CLUSTER_WAIT_S):
    """Wait until every server has applied the leader's commit index."""
    index = leader.raft.known_commit_index()
    deadline = time.perf_counter() + timeout
    while any(s.raft.last_index() < index for s in servers):
        check(time.perf_counter() < deadline,
              f"{label}: followers behind index {index}: "
              f"{[s.raft.last_index() for s in servers]}")
        time.sleep(0.005)


def cluster_entries(n_nodes, allocs_per_node, seed):
    """build_server_cluster's nodes and filler allocs (the same values
    from ``seed``) as raft payloads: every node, then the allocs
    CLUSTER_ALLOC_CHUNK nodes' worth an entry."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import consts

    rng = random.Random(seed)
    filler = mock.job()
    filler.id = "filler"
    filler.type = consts.JOB_TYPE_SERVICE
    filler.task_groups[0].tasks[0].resources.networks = []
    nodes, chunks, fills = [], [], []
    for i in range(n_nodes):
        node = mock.node()
        node.compute_class()
        nodes.append(("node_register", {"node": node}))
        for _ in range(allocs_per_node):
            alloc = mock.alloc()
            alloc.node_id = node.id
            alloc.job_id = filler.id
            alloc.job = filler
            alloc.desired_status = consts.ALLOC_DESIRED_RUN
            alloc.client_status = consts.ALLOC_CLIENT_RUNNING
            for tr in alloc.task_resources.values():
                tr.cpu = rng.choice([50, 100])
                tr.memory_mb = rng.choice([64, 128])
                tr.networks = []
            alloc.resources = None
            fills.append(alloc)
        if fills and ((i + 1) % CLUSTER_ALLOC_CHUNK == 0 or i + 1 == n_nodes):
            chunks.append(("alloc_update", {"allocs": fills}))
            fills = []
    return nodes, chunks


def load_cluster(servers, label, n_nodes, allocs_per_node, seed):
    """The cluster's nodes and fillers written through the leader's raft
    log from CLUSTER_WRITERS threads at once (``bulk_load``), every
    follower caught up. A write that finds no leader (an election under
    the load) is retried, as a client retries "no cluster leader": the
    loader's writes are upserts, so a repeat is harmless. Returns the
    leader after the load and the load's figures (seconds, entries,
    retries, elections)."""
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.server.raft import NotLeaderError

    retries = Counter()

    def write(entry):
        deadline = time.perf_counter() + CLUSTER_WAIT_S
        while True:
            try:
                return leader.log.apply(*entry)
            except (NotLeaderError, TimeoutError, ConnectionError):
                check(time.perf_counter() < deadline,
                      f"{label}: no leader took the load's writes")
                retries[entry[0]] += 1
                time.sleep(0.05)

    with bulk_load():
        # The entries are made with the collector off too: a gen-2
        # pause over the earlier phases' objects would elect a new
        # leader before the load starts.
        nodes, chunks = cluster_entries(n_nodes, allocs_per_node, seed)
        leader = stable_leader(servers, label)
    t0 = time.perf_counter()
    with Elections(servers) as elections, bulk_load():
        with ThreadPoolExecutor(CLUSTER_WRITERS) as pool:
            list(pool.map(write, nodes))
            list(pool.map(write, chunks))
        leader = stable_leader(servers, label)
        caught_up(servers, leader, label)
    figures = dict(build_s=time.perf_counter() - t0,
                   entries=len(nodes) + len(chunks),
                   retries=sum(retries.values()), **elections.summary())
    print(f"{label}: {n_nodes} nodes, {n_nodes * allocs_per_node} allocs "
          f"in {figures['entries']} raft entries through the leader's log, "
          f"every follower caught up in {figures['build_s']:.1f} s (host); "
          f"{figures['elections']} elections and {figures['retries']} "
          f"retried writes under the load")
    return leader, figures


class Clients:
    """The nodes' clients: every CLIENT_HEARTBEAT_S, every node the
    current leader times heartbeats through it, as a node's client agent
    does. A leader that takes over arms a TTL timer for every node in its
    state (heartbeat.go initializeHeartbeatTimers) and marks down each
    node that does not heartbeat within its TTL."""

    def __init__(self, servers):
        import threading

        self.servers = servers
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(CLIENT_HEARTBEAT_S):
            leader = next((s for s in self.servers if s.is_leader()), None)
            if leader is None:
                continue
            timers = leader.heartbeats
            with timers._lock:
                node_ids = list(timers._timers)
            for node_id in node_ids:
                timers.reset_timer(node_id)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30.0)


@contextlib.contextmanager
def running_cluster(label, servers):
    """Run the block with the cluster's clients heartbeating and no ERROR
    record on the port's loggers; shut every server down after it and
    give the frozen load back to the collector."""
    with ErrorRecords() as errors:
        try:
            with Clients(servers):
                yield
        finally:
            for server in servers:
                server.shutdown()
            gc.unfreeze()
    check(not errors.records, f"{label} logged errors: {errors.records[:5]}")


class Elections:
    """Terms and won elections across the cluster while the block runs
    (each leadership gain is one won election)."""

    def __init__(self, servers):
        self.servers = servers
        self.won = Counter()

    def __enter__(self):
        self.term0 = max(s.raft.current_term for s in self.servers)
        for s in self.servers:
            notify = s.raft._notify_leadership

            def counted_notify(is_leader, notify=notify, name=s.node_id):
                if is_leader:
                    self.won[name] += 1
                return notify(is_leader)

            s.raft._notify_leadership = counted_notify
        return self

    def __exit__(self, *exc):
        for s in self.servers:
            del s.raft._notify_leadership
        self.terms = max(s.raft.current_term for s in self.servers) - \
            self.term0

    def summary(self):
        return dict(terms=self.terms, elections=sum(self.won.values()),
                    won_by=dict(self.won))


class FollowerLag:
    """The largest gap between the leader's commit index and a
    follower's applied index, sampled every 2 ms while the block runs."""

    def __init__(self, leader, servers):
        import threading

        self.leader = leader
        self.followers = [s for s in servers if s is not leader]
        self.most = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.wait(0.002):
            commit = self.leader.raft.commit_index
            lag = commit - min(f.raft.last_applied for f in self.followers)
            self.most = max(self.most, lag)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)


class PlacedBy:
    """Allocs placed by the plans each server submits while the block
    runs (the executive and workers submit through ``plan_submit``)."""

    def __init__(self, servers):
        self.servers = servers
        self.placed = Counter()

    def __enter__(self):
        for s in self.servers:
            submit = s.plan_submit

            def counted_submit(plan, submit=submit, name=s.node_id):
                result = submit(plan)
                self.placed[name] += sum(
                    len(v) for v in result.node_allocation.values())
                return result

            s.plan_submit = counted_submit
        return self

    def __exit__(self, *exc):
        for s in self.servers:
            del s.plan_submit


class Forwarded:
    """Writes forwarded from a follower to the leader over the
    transport while the block runs."""

    def __init__(self, transport):
        self.transport = transport
        self.count = 0

    def __enter__(self):
        forward = self.transport.forward_apply

        def counted(peer, msg_type, payload):
            self.count += 1
            return forward(peer, msg_type, payload)

        self.transport.forward_apply = counted
        return self

    def __exit__(self, *exc):
        del self.transport.forward_apply


def fsm_tables(server, full=False):
    """The FSM's node, alloc and eval tables by id: with create/modify
    indexes, or (``full``) as plain data, without the nodes'
    ``status_updated_at``, which each replica stamps with its own clock
    when it applies a status change (the JAX store does the same)."""
    from nomad_tpu_torch.utils.codec import to_dict

    state = server.fsm.state.snapshot()

    def rec(obj):
        if not full:
            return (obj.create_index, obj.modify_index)
        out = to_dict(obj)
        out.pop("status_updated_at", None)
        return out

    return {"nodes": {n.id: rec(n) for n in state.nodes()},
            "allocs": {a.id: rec(a) for a in state.allocs()},
            "evals": {e.id: rec(e) for e in state.evals()},
            "jobs": {j.id: (j.create_index, j.modify_index)
                     for j in state.jobs()}}


def check_equal_fsms(servers, label, full=False):
    """The servers' FSM tables are equal once every server has applied
    the same index (the leader's commit index at that moment); compared
    against the current leader's. Returns the row counts."""
    deadline = time.perf_counter() + CLUSTER_WAIT_S
    while True:
        check(time.perf_counter() < deadline,
              f"{label}: the servers never reached one applied index")
        leader = next((s for s in servers if s.is_leader()), None)
        applied = {s.raft.last_index() for s in servers}
        if (leader is not None and len(applied) == 1
                and applied == {leader.raft.known_commit_index()}):
            want = fsm_tables(leader, full)
            others = [fsm_tables(s, full) for s in servers if s is not leader]
            if {s.raft.last_index() for s in servers} == applied:
                break
        time.sleep(0.01)
    for got in others:
        for table in want:
            differ = [k for k in set(want[table]) | set(got[table])
                      if want[table].get(k) != got[table].get(k)]
            check(not differ, f"{label}: a server's {table} differ from "
                  f"the leader's on {len(differ)} rows, e.g. {differ[:3]}")
    return {t: len(v) for t, v in want.items()}


def percentile_ms(values, q):
    import numpy as np

    return float(np.percentile(values, q)) * 1000.0


def cluster_storm(label, servers, leader, via, clock, total, jobs, count,
                  distinct, kernels, absent=(), release=None):
    """Register ``jobs`` through ``via`` with every server parked,
    release all (``release(servers)``, every server at once unless
    given), and wait until each eval is complete; returns (eval ids,
    released-at, figures) with each server's cohorts, fast evals and
    placements."""
    figures = {}
    ex0 = {s.node_id: s.executive.stats() for s in servers}
    applier0 = leader.plan_applier.stats()
    with contextlib.ExitStack() as stack:
        cohorts = {s.node_id: stack.enter_context(Cohorts(s))
                   for s in servers}
        placed = stack.enter_context(PlacedBy(servers))
        evs, start = counted(
            total, label, kernels,
            lambda: cluster_wave(servers, via, clock, label, jobs, release),
            absent)
    wall = max(clock.done[e] for e in evs) - start
    lat = [clock.done[e] - start for e in evs]
    # One snapshot for the holds: a store read makes the FSM's next
    # write copy the table it shares, under the raft apply.
    snap = leader.fsm.state.snapshot()
    check_server_state(leader, jobs, count, label, distinct, snap)
    n = sum(len(snap.allocs_by_job(j.id)) for j in jobs)
    check(n == len(jobs) * count, f"{label} placed {n}")
    per_server = {}
    for s in servers:
        ex = stats_delta(ex0[s.node_id], s.executive.stats())
        check(ex["device_faults"] == 0,
              f"{label}: {ex['device_faults']} device faults on {s.node_id}")
        per_server[s.node_id] = dict(
            leader=s is leader, cohorts=ex["cohorts"],
            fast_evals=ex["fast_evals"], legacy_evals=ex["legacy_evals"],
            routed_host=ex["routed_host"],
            plan_conflicts=ex["plan_conflicts"],
            placements=placed.placed[s.node_id],
            cohort_sizes=[len(c) for c in cohorts[s.node_id].seen])
    figures.update(
        evals=len(jobs), placed=n, evals_per_s=len(jobs) / wall,
        p50_ms=percentile_ms(lat, 50), p99_ms=percentile_ms(lat, 99),
        servers=per_server,
        applier=stats_delta(applier0, leader.plan_applier.stats()))
    return evs, start, figures


def cluster_wave(servers, via, clock, label, jobs, release=None):
    cluster_paused(servers)
    settle_heap()
    evs = [via.job_register(job)[0] for job in jobs]
    start = time.perf_counter()
    (release or cluster_release)(servers)
    clock.wait(label, evs)
    return evs, start


def cluster_deregister(servers, via, clock, label, jobs):
    cluster_paused(servers)
    evs = [via.job_deregister(job.id) for job in jobs]
    cluster_release(servers)
    clock.wait(label, evs)


def run_cluster_config8(seed, total, single):
    """Phase 14 (a): config 8 on three servers over InmemTransport, the
    storm and the lone evals registered through a follower. ``single`` is
    phase 13 (a)'s figures, printed beside."""
    from nomad_tpu_torch import trace

    label = "cluster config 8"
    transport, servers, clocks = inmem_cluster()
    with running_cluster(label, servers):
        leader, load = load_cluster(servers, label, SERVER_NODES,
                                    SERVER_ALLOCS_PER_NODE, seed + 11)
        figures = {"load": load}
        clock = clocks[servers.index(leader)]
        follower = next(s for s in servers if s is not leader)
        t0 = time.perf_counter()
        for w in range(CLUSTER_WARM_WAVES):
            warm = [server_job(f"c8-warm{w}-{j}") for j in range(SERVER_JOBS)]
            cluster_wave(servers, leader, clock, f"{label} warm wave {w}",
                         warm)
            check_server_state(leader, warm, SERVER_COUNT,
                               f"{label} warm wave {w}")
            cluster_deregister(servers, leader, clock,
                               f"{label} warm dereg {w}", warm)
        print(f"{label}: {CLUSTER_WARM_WAVES} warm wave(s) of {SERVER_JOBS} "
              f"jobs placed and stopped in {time.perf_counter() - t0:.1f} s "
              f"(host)")

        jobs = [server_job(f"c8-e2e-{j}") for j in range(SERVER_JOBS)]
        trace.get_recorder().reset()
        with Elections(servers) as elections, \
                FollowerLag(leader, servers) as lag, \
                Forwarded(transport) as forwarded:
            evs, start, storm = cluster_storm(
                f"{label} storm", servers, leader, follower, clock, total,
                jobs, SERVER_COUNT, True, EXECUTIVE_KERNELS["config 8"],
                DRAWN_IN_SCANS)
        figures.update(storm)
        figures.update(elections.summary())
        figures["forwarded_writes"] = forwarded.count
        figures["max_follower_lag"] = lag.most
        figures["storm_stages"] = trace.get_recorder().stage_stats()
        figures["fsm_rows"] = check_equal_fsms(servers, f"{label} storm")
        print(f"{label} storm: {SERVER_JOBS} evals registered through "
              f"follower {follower.node_id}, {figures['evals_per_s']:.2f} "
              f"evals/s, release to complete p50 {figures['p50_ms']:.2f} ms, "
              f"p99 {figures['p99_ms']:.2f} ms; {figures['forwarded_writes']}"
              f" writes forwarded; follower lag at most "
              f"{figures['max_follower_lag']} entries; {figures['terms']} new "
              f"terms, {figures['elections']} elections; the three FSMs "
              f"equal ({json.dumps(figures['fsm_rows'], sort_keys=True)})")
        print(f"  servers: {json.dumps(figures['servers'], sort_keys=True)}")

        # The follower's own clock: the eval reads complete there once
        # the follower applied its plan.
        settle_heap()
        with Forwarded(transport) as forwarded:
            lone = lone_evals(
                follower, clocks[servers.index(follower)], total, label,
                [server_job(f"c8-lone-{i}") for i in range(SERVER_LONE)],
                SERVER_COUNT)
        figures["lone_forwarded_writes"] = forwarded.count
        figures["lone_p50_ms"] = percentile_ms(lone, 50)
        figures["lone_p99_ms"] = percentile_ms(lone, 99)
        figures["nodes_checked"] = check_server_nodes(
            leader, leader.fsm.state.snapshot())
        print(f"{label} lone evals: {SERVER_LONE} through follower "
              f"{follower.node_id}, register to complete p50 "
              f"{figures['lone_p50_ms']:.2f} ms, p99 "
              f"{figures['lone_p99_ms']:.2f} ms")
    side = {k: (single.get(k), figures[k])
            for k in ("evals_per_s", "p50_ms", "p99_ms", "lone_p50_ms",
                      "lone_p99_ms")}
    print(f"config 8, one server (phase 13 (a)) against three: "
          f"{json.dumps(side, sort_keys=True)}")
    return figures


def cut_leader(transport, leader, survivors, evs, clocks, label):
    """Cut ``leader`` off, wait until both survivors name a new leader
    and its broker is enabled, release the survivors, and wait until
    ``evs`` are complete on the new leader. The survivors are released
    only then: before it, the in-process cluster map would still hand
    them the cut leader's broker, which no partition allows. Returns the
    new leader and the times of the cut, the election and the broker."""
    cut = time.perf_counter()
    transport.disconnect(leader.node_id)
    deadline = cut + CLUSTER_WAIT_S
    new = None
    while new is None:
        check(time.perf_counter() < deadline, f"{label}: no new leader")
        time.sleep(0.001)
        new = next((s for s in survivors if s.is_leader() and all(
            f.raft.leader_id == s.node_id for f in survivors)), None)
    elected = time.perf_counter()
    while not new.broker.enabled():
        check(time.perf_counter() < deadline,
              f"{label}: the new leader's broker is disabled")
        time.sleep(0.001)
    enabled = time.perf_counter()
    cluster_release(survivors)
    clocks[survivors.index(new)].wait(label, evs)
    return new, cut, elected, enabled


def run_cluster_failover(seed, total):
    """Phase 14 (b): config 6's storm registered with every server
    parked, then the leader cut off (``transport.disconnect``) and the two
    others released once they name a new leader (``cut_leader``). The cut
    leader stays parked: it cannot commit, and whatever it launched would
    count as the survivors' launches."""
    label = "cluster failover"
    transport, servers, clocks = inmem_cluster()
    with running_cluster(label, servers):
        _leader, load = load_cluster(servers, label, CONFIG6_NODES, 0,
                                     seed + 11)
        figures = failover_storm(label, transport, servers, clocks, total)
        figures["load"] = load
    return figures


def failover_storm(label, transport, servers, clocks, total):
    """Phase 14 (b) on a loaded cluster: warm waves through the leader,
    the storm registered parked, the cut (``cut_leader``) and the holds;
    the cut leader rejoins at the end."""
    leader = stable_leader(servers, label)
    clock = clocks[servers.index(leader)]
    for w in range(SERVER_WARM_WAVES):
        warm = [config6_job(f"fo-warm{w}-{j}") for j in range(CONFIG6_JOBS)]
        cluster_wave(servers, leader, clock, f"{label} warm wave {w}", warm)
        cluster_deregister(servers, leader, clock, f"{label} warm dereg {w}",
                           warm)
    jobs = [config6_job(f"fo-e2e-{j}") for j in range(CONFIG6_JOBS)]
    cluster_paused(servers)
    evs = [leader.job_register(job)[0] for job in jobs]
    caught_up(servers, leader, label)
    survivors = [s for s in servers if s is not leader]
    with Elections(survivors) as elections:
        new, cut, elected, enabled = counted(
            total, f"{label} storm", FAILOVER_KERNELS,
            lambda: cut_leader(transport, leader, survivors, evs,
                               [clocks[servers.index(s)] for s in survivors],
                               label))
    done = [clocks[servers.index(new)].done[e] for e in evs]
    snap = new.fsm.state.snapshot()
    check_server_state(new, jobs, CONFIG6_COUNT, label, False, snap)
    allocs = [a for j in jobs for a in snap.allocs_by_job(j.id)]
    check(len(allocs) == CONFIG6_JOBS * CONFIG6_COUNT
          and len({a.id for a in allocs}) == len(allocs)
          and len({(a.job_id, a.name) for a in allocs}) == len(allocs),
          f"{label}: {len(allocs)} allocs, some placed twice")
    figures = dict(
        new_leader=new.node_id, old_leader=leader.node_id,
        to_new_leader_ms=(elected - cut) * 1000.0,
        to_broker_enabled_ms=(enabled - cut) * 1000.0,
        to_first_complete_ms=(min(done) - cut) * 1000.0,
        to_last_complete_ms=(max(done) - cut) * 1000.0,
        evals_per_s=len(evs) / (max(done) - cut),
        fsm_rows=check_equal_fsms(survivors, label), **elections.summary())
    print(f"{label}: leader {leader.node_id} cut off with {len(evs)} evals "
          f"registered; {new.node_id} elected in "
          f"{figures['to_new_leader_ms']:.1f} ms, broker enabled at "
          f"{figures['to_broker_enabled_ms']:.1f} ms, first eval complete at "
          f"{figures['to_first_complete_ms']:.1f} ms, last at "
          f"{figures['to_last_complete_ms']:.1f} ms "
          f"({figures['evals_per_s']:.2f} evals/s); every job "
          f"{CONFIG6_COUNT} allocs, none placed twice; the two FSMs equal")
    transport.reconnect(leader.node_id)
    return figures


class FollowerDequeues:
    """Evals that followers' workers and executives dequeue while the
    block runs: a server that does not lead takes them from the leader's
    broker through its HTTP API (``RemoteLeader``)."""

    def __init__(self, servers):
        self.servers = servers
        self.by = Counter()

    def __enter__(self):
        for s in self.servers:
            one, many = s.eval_dequeue, s.eval_dequeue_many

            def dequeue(schedulers, timeout, s=s, one=one):
                follower = not s.is_leader()
                ev, token = one(schedulers, timeout)
                if follower and ev is not None:
                    self.by[s.node_id] += 1
                return ev, token

            def dequeue_many(schedulers, max_n, s=s, many=many):
                follower = not s.is_leader()
                got = many(schedulers, max_n)
                if follower:
                    self.by[s.node_id] += len(got)
                return got

            s.eval_dequeue, s.eval_dequeue_many = dequeue, dequeue_many
        return self

    def __exit__(self, *exc):
        for s in self.servers:
            del s.eval_dequeue, s.eval_dequeue_many


def consistent_reads(servers, https, leader, eval_id, label):
    """Phase 15 (b)'s read: once each follower has heard of the leader's
    last commit, a ``?consistent`` read of ``eval_id`` on the follower's
    API serves at or past the leader's store index then, with the eval
    as the leader holds it. Returns the index read."""
    import urllib.request

    commit = leader.raft.known_commit_index()
    store_index = leader.fsm.state.latest_index()
    want = leader.fsm.state.eval_by_id(eval_id)
    for server, http in zip(servers, https):
        if server is leader:
            continue
        wait_for(lambda s=server: s.raft.known_commit_index() >= commit,
                 label, f"{server.node_id} to hear of commit {commit}")
        url = f"{http.addr}/v1/evaluation/{eval_id}?consistent"
        with urllib.request.urlopen(url, timeout=API_WAIT_S) as resp:
            body = json.loads(resp.read())
            index = int(resp.headers["X-Nomad-Index"])
        check(server.fsm.state.latest_index() >= store_index
              and body["status"] == want.status
              and index >= want.modify_index,
              f"{label}: ?consistent on {server.node_id} read index {index}"
              f", status {body['status']}, store "
              f"{server.fsm.state.latest_index()}; the leader's store "
              f"{store_index}, eval {want.status} at {want.modify_index}")
    return store_index


def run_cluster_tcp(seed, total):
    """Phase 14 (c) with phase 15 (b): config 6 on three servers over
    TCPTransport that find each other by gossip (setup_serf, serf_join,
    setup_raft_cluster(expect=3) on 127.0.0.1 ephemeral ports). Each
    server runs the port's HTTPServer on 127.0.0.1:0 and tags its
    address into serf, so the followers find the leader's HTTP address
    and their workers and executives dequeue, submit plans and ack
    through it beside the leader's own."""
    from nomad_tpu_torch.server.transport import (TCPTransport,
                                                  fsm_payload_decoder)

    label = "cluster over TCP"
    servers, transports, https = [], [], []
    t0 = time.perf_counter()
    try:
        for i in range(CLUSTER_SERVERS):
            servers.append(cluster_server(node_name=f"t{i}",
                                          bootstrap_expect=CLUSTER_SERVERS))
            transport = TCPTransport(fsm_payload_decoder)
            transports.append((transport, transport.serve("127.0.0.1", 0)))
            https.append(http_api(servers[-1]))
        with running_cluster(label, servers):
            for server, (_t, addr), http in zip(servers, transports, https):
                server.setup_serf("127.0.0.1", 0, http_addr=http.addr,
                                  rpc_addr=addr)
            seed_addr = servers[0].serf.local_member.addr
            for server in servers[1:]:
                check(server.serf_join([seed_addr]) == 1,
                      f"{label}: serf join failed")
            for server, (transport, addr) in zip(servers, transports):
                server.setup_raft_cluster(transport, addr,
                                          expect=CLUSTER_SERVERS)
            leader = stable_leader(servers, label)
            figures = {"bootstrap_s": time.perf_counter() - t0}
            check(sorted(leader.raft.stats()["members"])
                  == sorted(a for _t, a in transports),
                  f"{label}: members {leader.raft.stats()['members']}")
            leader, figures["load"] = load_cluster(
                servers, label, CONFIG6_NODES, 0, seed + 11)
            for server in servers:
                if server is not leader:
                    want = https[servers.index(leader)].addr
                    wait_for(lambda s=server: s.leader_http_addr() == want,
                             label, f"{server.node_id} to find the leader's "
                             f"HTTP address {want} in serf")
            clock = EvalClock(leader)
            jobs = [config6_job(f"tcp-e2e-{j}") for j in range(CONFIG6_JOBS)]
            phase("15 (b)", "followers schedule through the leader's HTTP")

            def followers_first(servers):
                cluster_release([s for s in servers if s is not leader])
                wait_for(lambda: sum(dequeues.by.values()) >= 1, label,
                         "a follower's first dequeue through the leader's "
                         "HTTP")
                release(leader)

            with FollowerDequeues(servers) as dequeues:
                evs, _start, storm = cluster_storm(
                    f"{label} storm", servers, leader, leader, clock, total,
                    jobs, CONFIG6_COUNT, False, EXECUTIVE_KERNELS["config 6"],
                    release=followers_first)
            figures.update(storm)
            figures["follower_dequeued"] = dict(dequeues.by)
            n = sum(dequeues.by.values())
            check(n >= 1, f"{label}: no eval dequeued by a follower "
                  f"through the leader's HTTP")
            last = max(evs, key=lambda e: clock.done[e])
            figures["consistent_read_index"] = consistent_reads(
                servers, https, leader, last, label)
            figures["fsm_rows"] = check_equal_fsms(servers, label, full=True)
            print(f"{label}: bootstrap to one leader in "
                  f"{figures['bootstrap_s']:.2f} s; storm "
                  f"{figures['evals_per_s']:.2f} evals/s, p99 "
                  f"{figures['p99_ms']:.2f} ms; {n} evals dequeued by "
                  f"followers through the leader's HTTP "
                  f"({json.dumps(figures['follower_dequeued'])}); a "
                  f"?consistent read on each follower served at the "
                  f"leader's store index {figures['consistent_read_index']};"
                  f" the followers' decoded FSMs equal the leader's field "
                  f"by field")
    finally:
        for http in https:
            http.stop()
        for transport, _addr in transports:
            transport.close()
    return figures


API_WRITERS = 4         # SDK threads registering phase 15 (a)'s storm
API_WAIT_S = 120.0      # the deadline of each wait in phase 15
API_BLOCK_WAIT_S = 60.0  # a blocking query's ?wait


def http_api(server):
    """The port's HTTPServer in front of ``server`` on 127.0.0.1:0,
    started; the caller stops it."""
    from nomad_tpu_torch.api import HTTPServer

    http = HTTPServer(server, "127.0.0.1", 0)
    http.start()
    return http


def os_threads():
    """The process's threads as the kernel counts them: Python's and
    the native ones (torch's, the CUDA driver's)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("Threads:"):
                return int(line.split()[1])
    return -1


def take_response(buf):
    """One whole HTTP/1.1 response off the front of ``buf``: ((status,
    lower-cased headers, body), rest), or (None, buf) until it has
    arrived."""
    head_end = buf.find(b"\r\n\r\n")
    if head_end < 0:
        return None, buf
    lines = buf[:head_end].decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    end = head_end + 4 + int(headers.get("content-length", "0"))
    if len(buf) < end:
        return None, buf
    return (int(lines[0].split()[1]), headers, buf[head_end + 4:end]), \
        buf[end:]


class EvalWatchers:
    """Blocking queries on evals, ``GET /v1/evaluation/<id>?index=N``,
    each on its own keep-alive socket, all read from the calling thread
    through one selector: this side holds no thread a query, so the
    process's thread count shows what the server holds while they are
    parked. A watcher asks once without an index, then past each index
    it is answered with, until the eval reads terminal."""

    TERMINAL = ("complete", "failed", "cancelled")

    def __init__(self, addr, label):
        import selectors

        host, port = addr.split("//", 1)[1].rsplit(":", 1)
        self.host, self.port, self.label = host, int(port), label
        self.sel = selectors.DefaultSelector()
        self.recs = {}
        self.blocking_answers = 0

    def add(self, eval_id, registered_at):
        import selectors
        import socket

        sock = socket.create_connection((self.host, self.port),
                                        timeout=API_WAIT_S)
        rec = dict(id=eval_id, sock=sock, buf=b"", registered=registered_at,
                   asked_blocking=False, done=None, status=None)
        self.recs[eval_id] = rec
        self.sel.register(sock, selectors.EVENT_READ, rec)
        self._ask(rec, f"/v1/evaluation/{eval_id}")

    def _ask(self, rec, path):
        rec["sock"].sendall(
            f"GET {path} HTTP/1.1\r\nHost: smoke\r\n\r\n".encode())

    def _answer(self, rec, status, headers, body):
        check(status == 200, f"{self.label}: eval {rec['id']} answered "
              f"{status}: {body[:200]!r}")
        if rec["asked_blocking"]:
            self.blocking_answers += 1
        ev = json.loads(body)
        if ev["status"] in self.TERMINAL:
            rec["done"], rec["status"] = time.perf_counter(), ev["status"]
            self.sel.unregister(rec["sock"])
            rec["sock"].close()
            return
        rec["asked_blocking"] = True
        self._ask(rec, f"/v1/evaluation/{rec['id']}?index="
                  f"{headers['x-nomad-index']}&wait={API_BLOCK_WAIT_S:g}")

    def pump(self, until, what):
        """Read answers until ``until()`` holds; past API_WAIT_S, fail
        naming ``what`` and the evals not yet answered terminal."""
        deadline = time.perf_counter() + API_WAIT_S
        while not until():
            left = [r["id"] for r in self.recs.values() if r["done"] is None]
            check(time.perf_counter() < deadline,
                  f"{self.label}: waited {API_WAIT_S:.0f} s for {what}; "
                  f"{len(left)} evals not answered terminal, e.g. {left[:3]}")
            for key, _ev in self.sel.select(timeout=0.05):
                rec = key.data
                chunk = rec["sock"].recv(1 << 16)
                check(chunk, f"{self.label}: the server closed eval "
                      f"{rec['id']}'s query")
                rec["buf"] += chunk
                while rec["done"] is None:
                    got, rec["buf"] = take_response(rec["buf"])
                    if got is None:
                        break
                    self._answer(rec, *got)

    def all_done(self):
        return all(r["done"] is not None for r in self.recs.values())

    def close(self):
        for rec in self.recs.values():
            if rec["done"] is None:
                self.sel.unregister(rec["sock"])
                rec["sock"].close()
        self.sel.close()


def wait_for(cond, label, what):
    """Poll ``cond`` until it holds; past API_WAIT_S, fail naming
    ``what`` (a string, or a callable that gives it then)."""
    deadline = time.perf_counter() + API_WAIT_S
    while not cond():
        if time.perf_counter() >= deadline:
            raise SmokeFailure(f"{label}: waited {API_WAIT_S:.0f} s for "
                               f"{what() if callable(what) else what}")
        time.sleep(0.005)


def thread_names():
    """The process's Python threads by name, less their pool index."""
    import threading

    return dict(Counter(t.name.rstrip("0123456789-_")
                        for t in threading.enumerate()))


def run_api_config8(server, clock, total):
    """Phase 15 (a) (see the module docstring), on phase 13 (a)'s loaded
    server after its lone evals. Adds each window's launch counts to
    ``total``; returns the figures."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from nomad_tpu_torch.api import Client
    from nomad_tpu_torch.scheduler.batcher import get_batcher

    label = "config 8 over HTTP"
    phase("15 (a)", "the API: config 8 submitted and watched over HTTP on "
          "phase 13 (a)'s server")
    jobs = [server_job(f"api-e2e-{j}") for j in range(SERVER_JOBS)]
    figures = {}
    http = http_api(server)
    watchers = EvalWatchers(http.addr, label)
    try:
        def register(part):
            client = Client(http.addr, timeout=API_WAIT_S)
            try:
                out = []
                for job in part:
                    t = time.perf_counter()
                    out.append((client.jobs.register(job), t))
                return out
            finally:
                client.pool.close()

        def storm():
            paused(server)
            with ThreadPoolExecutor(API_WRITERS) as pool:
                for got in pool.map(register, [jobs[i::API_WRITERS]
                                               for i in range(API_WRITERS)]):
                    for eval_id, t in got:
                        watchers.add(eval_id, t)
            watchers.pump(lambda: all(r["asked_blocking"]
                                      for r in watchers.recs.values()),
                          "every eval's first answer")
            mux = server.read_mux
            wait_for(lambda: mux.stats()["parked"] == SERVER_JOBS, label,
                     lambda: f"{SERVER_JOBS} parked queries "
                     f"({mux.stats()['parked']} parked)")
            # The handler threads of the parked queries exit; the
            # registering clients' connections close.
            wait_for(lambda: threading.active_count() < SERVER_JOBS, label,
                     lambda: f"fewer threads than parked queries "
                     f"({threading.active_count()} threads: "
                     f"{json.dumps(thread_names(), sort_keys=True)})")
            figures.update(parked=mux.stats()["parked"],
                           threads_parked=threading.active_count(),
                           os_threads_parked=os_threads(),
                           thread_names=thread_names())
            start = time.perf_counter()
            release(server)
            watchers.pump(watchers.all_done, "every eval complete")
            return start

        mux0 = server.read_mux.stats()
        stats0 = get_batcher().stats()
        ex0 = server.executive.stats()
        with Cohorts(server) as cohorts:
            start = counted(total, f"{label} storm",
                            EXECUTIVE_KERNELS["config 8"], storm,
                            DRAWN_IN_SCANS)
        recs = list(watchers.recs.values())
        bad = sorted({r["status"] for r in recs} - {"complete"})
        check(not bad, f"{label}: evals ended {bad}")
        clock.wait(label, [r["id"] for r in recs])
        check_server_state(server, jobs, SERVER_COUNT, label, True)
        placed = sum(len(server.fsm.state.allocs_by_job(j.id)) for j in jobs)
        check(placed == SERVER_JOBS * SERVER_COUNT, f"{label}: placed {placed}")
        # A serve counts itself after its answer is on the wire.
        wait_for(lambda: stats_delta(mux0, server.read_mux.stats())["served"]
                 >= watchers.blocking_answers, label,
                 lambda: f"the read mux to count its serves "
                 f"({json.dumps(server.read_mux.stats(), sort_keys=True)}, "
                 f"{watchers.blocking_answers} blocking answers)")
        mux = stats_delta(mux0, server.read_mux.stats())
        # Each write wakes its own eval's query only: no wake whose scope
        # had not moved, every answer a park that a wake (or the
        # park-time recheck) served, none timed out.
        check(mux["spurious"] == 0 and mux["timeouts"] == 0
              and mux["write_errors"] == 0,
              f"{label}: read mux {json.dumps(mux, sort_keys=True)}")
        check(mux["served"] == watchers.blocking_answers
              and 1 <= mux["wakes"] <= mux["served"],
              f"{label}: {watchers.blocking_answers} blocking answers, "
              f"read mux {json.dumps(mux, sort_keys=True)}")
        ex = stats_delta(ex0, server.executive.stats())
        st = stats_delta(stats0, get_batcher().stats())
        check(ex["cohorts"] >= 1 and ex["fast_evals"] >= 1
              and ex["device_faults"] == 0,
              f"{label}: executive {json.dumps(ex, sort_keys=True)}")
        check(st["cohort_dispatches"] > 0, f"{label}: no cohort dispatch")
        routed = cohorts.routed_first(server.config.dense_min_batch)
        check(not routed, f"{label}: {len(routed)} evals routed to the "
              f"host on their first delivery")
        done = [r["done"] for r in recs]
        from_register = [r["done"] - r["registered"] for r in recs]
        from_release = [d - start for d in done]
        figures.update(
            evals=SERVER_JOBS, placed=placed,
            evals_per_s=SERVER_JOBS / (max(done) - start),
            p50_ms=percentile_ms(from_register, 50),
            p99_ms=percentile_ms(from_register, 99),
            release_p50_ms=percentile_ms(from_release, 50),
            release_p99_ms=percentile_ms(from_release, 99),
            cohort_sizes=[len(c) for c in cohorts.seen],
            cohort_dispatches=st["cohort_dispatches"],
            blocking_answers=watchers.blocking_answers,
            read_mux={k: mux[k] for k in ("parked_total", "wakes",
                                          "spurious", "served",
                                          "timeouts")})
        print(f"{label} storm: {SERVER_JOBS} jobs registered through the SDK"
              f" from {API_WRITERS} threads, each eval watched by a blocking "
              f"query; {figures['evals_per_s']:.2f} evals/s; register to the "
              f"answer of complete p50 {figures['p50_ms']:.2f} ms, p99 "
              f"{figures['p99_ms']:.2f} ms (release to it p50 "
              f"{figures['release_p50_ms']:.2f}, p99 "
              f"{figures['release_p99_ms']:.2f}); {placed} allocs placed; "
              f"read mux parked high water {figures['parked']} with "
              f"{figures['threads_parked']} Python threads "
              f"({figures['os_threads_parked']} in all) in the process; "
              f"cohorts {figures['cohort_sizes']}")

        routed0 = server.executive.stats()["routed_host"]
        lone_jobs = [server_job(f"api-lone-{i}") for i in range(SERVER_LONE)]

        def lone():
            client = Client(http.addr, timeout=API_WAIT_S)
            try:
                for job in lone_jobs:
                    t = time.perf_counter()
                    watchers.add(client.jobs.register(job), t)
                    watchers.pump(watchers.all_done, "a lone eval complete")
            finally:
                client.pool.close()

        lone_start = len(recs)
        counted(total, f"{label} lone evals", (), lone, ANY_KERNEL)
        lone_recs = list(watchers.recs.values())[lone_start:]
        check(all(r["status"] == "complete" for r in lone_recs),
              f"{label}: lone evals ended "
              f"{sorted({r['status'] for r in lone_recs})}")
        check_server_state(server, lone_jobs, SERVER_COUNT,
                           f"{label} lone evals", True)
        routed = server.executive.stats()["routed_host"] - routed0
        check(routed == SERVER_LONE, f"{label} lone evals: routed_host "
              f"{routed}, not {SERVER_LONE}")
        lone_lat = [r["done"] - r["registered"] for r in lone_recs]
        figures["lone_p50_ms"] = percentile_ms(lone_lat, 50)
        figures["lone_p99_ms"] = percentile_ms(lone_lat, 99)
        figures["nodes_checked"] = check_server_nodes(server)
        figures["connections_accepted"] = http.connections_accepted
        print(f"{label} lone evals: {SERVER_LONE}, all routed to the host; "
              f"register to the answer of complete p50 "
              f"{figures['lone_p50_ms']:.2f} ms, p99 "
              f"{figures['lone_p99_ms']:.2f} ms")
    finally:
        watchers.close()
        http.stop()
    print(f"server API figures: {json.dumps(figures, sort_keys=True)}")
    return figures


def run_cluster(seed, total, single):
    """Phase 14: (a), (b) and (c); prints ``server cluster figures``."""
    t0 = time.perf_counter()
    phase("14 (a)", "config 8 on three servers over InmemTransport")
    with election_timeouts(*CLUSTER_ELECTION_TIMEOUT_S):
        figures = {"config 8": run_cluster_config8(seed, total, single)}
    phase("14 (b)", "failover during config 6's storm")
    figures["failover"] = run_cluster_failover(seed, total)
    phase("14 (c)", "config 6 on three servers over TCP, with the API")
    with election_timeouts(*CLUSTER_ELECTION_TIMEOUT_S):
        figures["tcp"] = run_cluster_tcp(seed, total)
    figures["wall_s"] = time.perf_counter() - t0
    print(f"server cluster figures: {json.dumps(figures, sort_keys=True)}")
    return figures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # Line-buffered: a run cut by its time limit still shows how far it got.
    sys.stdout.reconfigure(line_buffering=True)

    if not os.path.isdir(os.path.join(HERE, "nomad_tpu_torch")):
        print("chip_smoke: nomad_tpu_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    logging.basicConfig(level=logging.WARNING)

    try:
        phase(1, "card identity and the kernels' build")
        card = card_identity()
        kind = torch.cuda.get_device_name(0)
        print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
              f"cuda {torch.version.cuda}")

        from nomad_tpu_torch.ops import cuda

        t0 = time.perf_counter()
        cuda.library()
        info = dict(cuda.build_info)
        print(f"kernels: built in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {info.get('build_s', 0.0):.1f} s, cached "
              f"{info.get('cached')})")
        log = os.path.join(os.path.dirname(info["path"]), "build.log")
        if os.path.exists(log):
            section = ""
            for line in open(log):
                if line.startswith("=="):
                    section = line
                # Every kernel's registers; the cluster scans' and the
                # base delta's entries by name, with their spills.
                if "registers" in line or line.startswith("==") or (
                        any(x in section for x in (
                            "greedy_scan.cu", "gang_scan.cu",
                            "preempt_scan.cu", "base_delta.cu"))
                        and ("spill" in line or "Compiling entry" in line)):
                    print("  " + line.rstrip())

        total = Counter()
        with ShapeCalls() as relax_calls:
            phase("2-3", "the north-star cluster and its evals")
            counts, _lat_ms, main_h = run_main_path(args.seed, torch)
            total.update(counts)
            phase(4, "the eval storm")
            storm, storm_h = run_storm(args.seed, torch, total)
            runtime = storm.pop("runtime")
            print(f"storm figures: {json.dumps(storm, sort_keys=True)}")
            phase(5, "preemption on a red cluster")
            k6 = run_preemption(args.seed, torch, total)
            phase(6, "gangs")
            gangs, gang_programs = run_gangs(args.seed, torch, total)
            phase(8, "the convex kernel and the defrag solve")
            convex_calls = run_convex(args.seed, torch, total, main_h,
                                      storm_h)
            phase(9, "the node-sharded mesh path")
            mesh_figures, mesh_calls = run_mesh(args.seed, torch, total,
                                                storm_h)
            more, more_calls = run_mesh_programs(
                args.seed, torch, total, main_h, storm_h,
                convex_calls.pop("frag_h"), gang_programs)
        mesh_figures.update(more)
        print("relaxation calls by shape: " + json.dumps(
            {k: relax_calls.of(k) for k in sorted(relax_calls.by_kernel)}))
        print(f"mesh figures: {json.dumps(mesh_figures, sort_keys=True)}")
        del main_h, storm_h
        phase(10, "config 5, the system drain storm")
        system = run_system_drain(args.seed, total)
        print(f"system drain figures: {json.dumps(system, sort_keys=True)}")
        phase(11, "the runtime's cost")
        runtime.update(run_runtime_cost(args.seed, torch, total))
        print(f"runtime figures: {json.dumps(runtime, sort_keys=True)}")
        phase(12, "config 8 through the dev-mode Server")
        server = run_server_storm(args.seed, torch, total)
        print(f"server storm figures: {json.dumps(server, sort_keys=True)}")
        phase("13 (a)", "config 8 through the executive")
        executive = run_executive_storms(args.seed, torch, total, server)
        phase("13 (c)", "the live defrag loop")
        defrag = run_live_defrag(args.seed, total)
        print(f"server defrag figures: {json.dumps(defrag, sort_keys=True)}")
        run_cluster(args.seed, total, executive["config 8"])
        phase(7, "each kernel against its plain version")
        results = bench_kernels(torch, np, args.seed)
        results.update(bench_new_kernels(torch, np, args.seed))
        results.update(bench_legs(torch, k6, gangs))
        results.update(bench_convex(torch, np, convex_calls))
        results.update(bench_mesh(torch, np, mesh_calls))
        results.update(bench_mesh_programs(torch, np, more_calls))
        for name in relax_calls.by_kernel:
            results[name][PRIMARY[name]]["calls_by_shape"] = \
                relax_calls.of(name)
        torch.cuda.synchronize()
    except SmokeFailure as e:
        for out in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAILED in phase {PHASE[0]}: {e}", file=out)
        return 1
    except Exception:
        # Not a check: a fault of the run itself. Name the phase, show
        # the traceback, and fail.
        import traceback

        for out in (sys.stdout, sys.stderr):
            print(f"chip_smoke: FAILED in phase {PHASE[0]} with an "
                  f"exception", file=out)
        traceback.print_exc()
        return 1

    print(f"launches on the main paths: {json.dumps(total, sort_keys=True)}")
    print("greedy scan launches by noise mode, by path: "
          f"{json.dumps(SCAN_MODES, sort_keys=True)}")
    kernels = []
    for name, shapes in results.items():
        src, replaces = REPLACES[name]
        lead = shapes[PRIMARY[name]]
        for shape, r in shapes.items():
            print(f"{name} {shape}: {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.6f} by "
                  f"{r['bound_by']}, library {r['library_ms']})")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": total.get(name, 0),
            **lead, "shape": str(PRIMARY[name]),
            "shapes": {str(k): v for k, v in shapes.items()
                       if k != PRIMARY[name]},
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
