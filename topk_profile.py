#!/usr/bin/env python3
"""Where the time of the uniform top-K kernel (csrc/uniform_topk.cu),
of the node-shard kernels K10a and K10b (parallel/shard.py
sharded_base_delta, sharded_group_capacity), and of the relaxation's
launch (csrc/relax.cuh) and of the greedy scan's cluster launch
(csrc/greedy_scan.cu, with K8b, its rounding-bias case, and K7's gang
scan, csrc/gang_scan.cu, and K6's preemption scan, csrc/preempt_scan.cu)
goes on one NVIDIA card, at chip_smoke.py's
widths (N = 10,240 nodes, G = 2, inputs from chip_smoke.kernel_inputs;
4 shards of one card).

    python3 topk_profile.py [--seed N]
        [--sections host,waves,steps,shards,relax,scan,modes]

Prints, one JSON object a line:

1. ``card``: ``nvidia-smi``'s name and power limit.
2. ``build``: each instantiation of nt_topk_cluster_kernel (KM 8 and 32:
   register lists; 0: the radix select) with its registers, stack and
   spill bytes from the kernels' ptxas log (build.log).
3. ``host``: at B = 1, K = 1,024, the host time of one call of
   ``binpack.uniform_topk`` and of its parts: the argument checks
   (``_check_scan_args``), the segment arrays (ctypes), the two output
   allocations, the stream lookup (``cuda.stream_ptr``), the launch
   count (``cuda.count_launch``), the C entry point's launch
   (``cuda.launch``), a launch of the smallest kernel through the same
   path (nt_argmax_chain, one round) and ``torch.topk``'s call;
   medians of host ``perf_counter`` spans, the card synchronised
   between calls. Beside them the calls' CUDA-event and profiler device
   times (a fresh carry a call).
4. ``waves``: K2 at K = 1,024 for B = 1 and 64 with 1, 2, 4 and 8 CTAs
   a cluster: the clusters the card holds at once
   (cudaOccupancyMaxActiveClusters), the launch's clusters, and the
   call and device times.
5. ``steps``: config 4's storm kernel (B = 64, K = 8, ``seq``) after
   each step of its design: A.1 selection with no sort on one CTA, A.2
   the node axis over a cluster of 8 CTAs, A.3 the rows resident in
   shared memory (the wrappers' launch); call and device times, each
   step's choices and carry held equal to A.3's.
6. ``shards``: K10a (R = 256 and 4,096 payload rows) and K10b (g_pad
   10,240 singletons and 256 racks of 40) on 4 shards of one card:
   each call held bit-equal to its plain version, its launches, its
   CUDA-event time, its device time (torch.profiler: every device
   activity of the call, copies included, and the kernels alone), the
   library calls' times, and its host split (``HostSplit``): the mean
   host span of a call (median) and, of its mean with the parts timed,
   the argument checks, ``place``, the payload's upload, the child
   arrays' allocation, allocations, clones, stream lookups, ctypes
   tables, C entry points (``cuda.launch``: the ctypes call and the
   launch), launch counts, device switches and the host sort of the
   rows. Only the outermost of nested parts counts; "other" is the
   Python glue. Parts that a tree does not have are skipped, so the
   section runs on an earlier checkout's package too (copy this script
   and chip_smoke.py, whose timers and ``library_delta`` it uses,
   beside it).
7. ``relax``: the relaxation's launch (K8a's placement mode) at B x K =
   1 x 1,024 and 1 x 8, over one segment and over 4 (K10g-a's shards of
   one card): the whole solve's CUDA-event time at 12 iterations, at 0
   and at 24 (their difference over 24 is an iteration's time, its two
   grid barriers included), and each phase alone (an ordinary launch of
   that phase over the same table, its tiles as the grid: prologue, A,
   B, x, y, pref); the launch's grid and tiles.
8. ``scan``: the greedy scan (K1) at K = 1,024: (a) ``clusters``, B =
   1 and seq 4 x 1,024 on 1, 2, 4, 8 and 16 CTAs a cluster, resident
   where the plan's layout fits and streamed, and B = 64 on 1, 2 and 4
   CTAs: the clusters the card holds at once, the call's CUDA-event
   time and the cluster chain term at that shape (nt_argmax_chain_
   cluster), each call's choices and carry held equal to the plan's;
   (b) ``cache``, at the plan's launch for each of those shapes: the
   score cache on and off in turns (on, off, on, off; held equal), on
   one ask throughout (chip_smoke's records), on the greedy storm's
   two groups (two runs of alike asks an eval) and on varied asks
   (chip_smoke.varied_asks: none alike), with the share of alike
   steps; (c) ``parts``, at the plan's launch for B = 1, B = 64 and
   seq 4 x 1,024: a step split into the waits for staged rows (an
   eval's; reading the noise, its stage),
   the asks' loads, scoring (with the noise of the thread's nodes past
   the first 5, drawn there), the warp and block reduction with the CTA
   key's sends (block argmax), the next step's draw (the noise of the
   thread's first 5 nodes, hashed while the keys travel), the wait for
   the cluster's keys (exchange) and the winner's reduction and row
   update, from the kernel's clock counters on one thread of rank 0
   (warp 1's lane 0, which issues no bulk copies; ``prof``): each
   part's share of the cycles and its microseconds a step at the call's
   measured time; each shape with the noise drawn in the kernel and
   read from K0's tensor (staged where it fits), in turns (drawn, read,
   drawn, read), the call's time including K0's launch where it reads.
   Every call here takes the batch's keys (a ``prng.Draw``). (d) K8b's
   and K7's steps split the same way at their plans (the same kernel
   with the rounding bias, and the gang scan of csrc/gang_scan.cu): K8b
   at B = 1 x K = 1,024 and a storm eval under seq (1 x 8), K7 at phase
   6's three timed shapes on chip_smoke's node rows (a free gang under
   distinct_hosts at K = 1,024, an ici slice at K = 64, a spread over
   10,240 one-node groups at K = 512), each held against its plain
   version; K7's "asks" part is the member's active flag, and its
   "winner" part holds the group-count add (and, in spread and affinity
   mode, its block barrier). K6 (csrc/preempt_scan.cu) at phase 5's
   shapes, K = 1,024 and 8 on a red cluster (256 nodes with room, the
   rest evicting); its "block" part holds both keys' reductions and
   sends, its "winner" part the owner's walk again and row update.
9. ``modes``: the greedy scan (K1, stacked, K = 1,024) at B = 4, 16,
   17, 31, 33 and 64 with its noise drawn in the kernel and read from
   K0's tensor, each mode on its own plan (``scan.plan_for(...,
   drawn=)``: its cluster and form), in turns (drawn, read, drawn,
   read), the call's time including K0's launch where it reads; the
   two modes' outputs held equal; K0's time alone; the nodes a CTA
   hashes a step drawing (its slice) against the nodes an SM hashes a
   step in K0 (B N over the card's SMs); and the mode the plan takes.

Exits non-zero with no result when no CUDA card is present.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RUNS = 50


# The host parts of a wrapper call: (label, owner, attribute). A string
# owner names a module of the port; the attribute is replaced there and
# in every loaded module of the port that holds the same object. A part
# that a tree lacks is skipped (the tables and the device switch have
# an older tree's names beside this one's).
SPLIT_PARTS = (
    ("checks", "nomad_tpu_torch.ops.binpack", "_check"),
    ("checks", "nomad_tpu_torch.parallel.shard", "_check_delta"),
    ("place", "nomad_tpu_torch.parallel.mesh", "place"),
    ("upload", "nomad_tpu_torch.parallel.shard", "_upload"),
    ("children", "nomad_tpu_torch.parallel.shard", "_child_views"),
    ("sorts", "nomad_tpu_torch.parallel.shard", "delta_row_table"),
    ("stream", "nomad_tpu_torch.ops.cuda", "stream_ptr"),
    ("tables", "nomad_tpu_torch.ops.cuda", "table"),
    ("tables", "nomad_tpu_torch.parallel.shard", "_seg_table"),
    ("entry", "nomad_tpu_torch.ops.cuda", "launch"),
    ("count", "nomad_tpu_torch.ops.cuda", "count_launch"),
    ("device_switch", "nomad_tpu_torch.ops.cuda", "on_device"),
    ("device_switch", "nomad_tpu_torch.parallel.shard", "_on"),
)


class HostSplit:
    """Times the host parts of the calls made inside the block (see
    SPLIT_PARTS, plus ``torch.empty``/``torch.zeros`` as allocations and
    ``Tensor.clone`` as clones): each part's total seconds in ``spent``.
    A part called inside another part counts as the outer one's."""

    def __init__(self, torch, np):
        self.spent = {}
        self.depth = 0
        self.undo = []
        self.parts = [(label, sys.modules.get(owner), name)
                      for label, owner, name in SPLIT_PARTS]
        self.parts += [("allocs", torch, "empty"), ("allocs", torch, "zeros"),
                       ("clones", torch.Tensor, "clone")]

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            if self.depth:
                return fn(*args, **kwargs)
            self.depth = 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.spent[label] = self.spent.get(label, 0.0) + (
                    time.perf_counter() - t0)
                self.depth = 0
        return timed

    def __enter__(self):
        port = [m for name, m in list(sys.modules.items())
                if name.startswith("nomad_tpu_torch") and m is not None]
        for label, owner, name in self.parts:
            orig = getattr(owner, name, None) if owner is not None else None
            if orig is None:
                continue
            timed = self._wrap(label, orig)
            holders = [owner] + [m for m in port if m is not owner
                                 and getattr(m, name, None) is orig]
            for h in holders:
                self.undo.append((h, name, orig, name in vars(h)))
                setattr(h, name, timed)
        return self

    def __exit__(self, *exc):
        for h, name, orig, own in reversed(self.undo):
            if own:
                setattr(h, name, orig)
            else:
                delattr(h, name)
        self.undo = []


def host_split(torch, np, fn, runs=RUNS):
    """Host span of ``fn()`` in ms: the median without the parts timed
    (``host_ms``), the mean with them (HostSplit, ``timed_host_ms``) and
    each part's mean a call (``parts_ms``, adding up to the timed mean);
    the card synchronised before each call. ``other`` is the rest of
    the timed span."""
    plain = []
    for _ in range(10):
        fn()
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        plain.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    split = HostSplit(torch, np)
    spans = []
    with split:
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            spans.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    parts = {k: v * 1000.0 / runs for k, v in sorted(split.spent.items())}
    timed = sum(spans) * 1000.0 / runs
    parts["other"] = timed - sum(parts.values())
    return dict(host_ms=statistics.median(plain) * 1000.0,
                timed_host_ms=timed, parts_ms=parts)


def shard_section(torch, np, cs, seed):
    """K10a and K10b on 4 shards of one card (section 6)."""
    from nomad_tpu_torch.ops import cuda
    from nomad_tpu_torch.ops.gang import group_capacity_plain
    from nomad_tpu_torch.parallel import shard
    from nomad_tpu_torch.parallel.mesh import gather, make_mesh, place

    n, w = cs.BENCH_N, 4
    mesh = make_mesh(devices=["cuda:0"] * w)
    rng = np.random.default_rng(seed + 80)

    def launches(name, fn):
        cuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, cuda.launch_counts().get(name, 0)

    def record(kernel, shape, name, call, match, library):
        n_launch = launches(name, call)[1]
        out = dict(kernel=kernel, **shape, shards=w, launches=n_launch,
                   call_ms=cs.time_cuda(torch, call, RUNS),
                   device_ms=cs.device_ms(torch, call, RUNS),
                   kernel_device_ms=cs.device_ms(torch, call, RUNS,
                                                 match=match),
                   **host_split(torch, np, call))
        for key, fn in library.items():
            out[key] = cs.time_cuda(torch, fn, RUNS)
        print(json.dumps({"shards": out}))

    # ---- K10a: R payload rows (R - 56 distinct, the rest repeating the
    # first, as the batcher pads) over the 4 shards of a placed parent
    parent = (rng.random((n, 4)).astype(np.float32),
              rng.random(n).astype(np.float32),
              rng.random(n).astype(np.float32), rng.random(n) < 0.5)
    specs = [("nodes", None), ("nodes",), ("nodes",), ("nodes",)]
    targets = place(mesh, parent, specs)
    flat = [torch.from_numpy(x).cuda() for x in parent]
    for r in (256, 4096):
        real = r - 56
        rows = np.full(r, 0, np.int32)
        rows[:real] = rng.choice(n, real, replace=False)
        rows[real:] = rows[0]
        vals = [rng.random((r, 4)).astype(np.float32),
                rng.random(r).astype(np.float32),
                rng.random(r).astype(np.float32), rng.random(r) < 0.5]
        for v in vals:
            v[real:] = v[0]
        payload = (rows, *vals)
        run = lambda: shard.sharded_base_delta(mesh)(  # noqa: E731
            *targets, *payload)
        got = run()
        for j, (g, p) in enumerate(zip(got, parent)):
            want = torch.from_numpy(p.copy())
            want[torch.from_numpy(rows).long()] = torch.from_numpy(vals[j])
            cs.check(torch.equal(gather(g), want),
                     f"K10a R={r}: differs from the one-device scatter")
        idx = (torch.from_numpy(rows).long().cuda(),)
        on_card = [torch.from_numpy(v).cuda() for v in vals]
        lib = cs.library_delta(torch, np, targets, payload)
        cs.check(all(torch.equal(g.parts[0][s], lib[s][j])
                     for j, g in enumerate(got) for s in range(w)),
                 f"K10a R={r}: differs from the library calls")
        record("K10a", dict(r=r), "sharded_base_delta", run, "delta", {
            "library_ms": lambda: [torch.index_put(x, idx, v)
                                   for x, v in zip(flat, on_card)],
            "library_place_ms": lambda: cs.library_delta(
                torch, np, targets, payload)})
    # ---- K10b: singletons (g_pad 10,240) and racks of 40 (g_pad 256)
    units = rng.integers(0, 40, n).astype(np.float32)
    for g_pad, ids in ((n, np.arange(n)), (256, np.arange(n) // 40)):
        ids = ids.astype(np.int32)
        ids[rng.choice(n, 64, replace=False)] = -1
        u_sh, i_sh = place(mesh, (units, ids), (("nodes",), ("nodes",)))
        fn = shard.sharded_group_capacity(mesh, g_pad)
        run = lambda: fn(u_sh, i_sh)  # noqa: E731
        want = shard.group_capacity_combine_plain(torch.stack([
            group_capacity_plain(u.cpu(), i.cpu(), g_pad)
            for u, i in zip(u_sh.parts[0], i_sh.parts[0])]))
        cs.check(torch.equal(run().cpu(), want),
                 f"K10b g_pad={g_pad}: differs from the plain version")
        keep = ids >= 0
        tu = torch.from_numpy(units[keep]).cuda()
        ti = torch.from_numpy(ids[keep]).long().cuda()
        record("K10b", dict(g_pad=g_pad), "group_capacity", run, "group", {
            "library_ms": lambda: torch.zeros(
                g_pad, device=tu.device).index_add_(0, ti, tu)})


def build_entries(path):
    """(name, registers, stack, spill stores, spill loads) of each
    nt_topk_cluster_kernel instantiation in the ptxas log."""
    out, name, props = [], None, None
    section = None
    for line in open(path):
        if line.startswith("== "):
            section = line[3:].strip()
        if section != "uniform_topk.cu":
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = [int(x) for x in m.groups()]
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name and "nt_topk_cluster_kernel" in name:
            km = re.search(r"nt_topk_cluster_kernelILi(\d+)E", name)
            out.append(dict(km=int(km.group(1)) if km else None,
                            registers=int(m.group(1)),
                            stack=props[0] if props else None,
                            spill_stores=props[1] if props else None,
                            spill_loads=props[2] if props else None))
            name = props = None
    return out


def relax_section(torch, np, cs, seed):
    """The relaxation's launch, whole and a phase at a time (section 7)."""
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.ops import cuda, relax
    from nomad_tpu_torch.parallel.mesh import shard_bounds

    dev = torch.device("cuda")
    n, g, penalty = cs.BENCH_N, 2, 10.0
    for k in (1024, 8):
        base, jc, tgc, feas, asks, _u, _keys = cs.kernel_inputs(
            torch, np, n, k, g, 1, seed + 90, dev)
        carry = cs.new_carry(torch, base, jc, tgc)
        static = (base["capacity"], base["sched_capacity"],
                  base["bw_avail"], base["node_ok"])
        for w in (1, 4):
            segs, keep = [], []
            for lo, hi in shard_bounds(n, w):
                cut = [x.narrow(0, lo, hi - lo).contiguous() for x in static]
                own = [c.narrow(1, lo, hi - lo).contiguous() for c in carry]
                f = feas.narrow(1, lo, hi - lo).contiguous()
                out = torch.empty((2, 1, k, hi - lo), device=dev)
                keep += cut + own + [f, out]
                segs.append(relax.Segment(dev, hi - lo, dict(
                    capacity=cut[0].data_ptr(), sched=cut[1].data_ptr(),
                    bw_avail=cut[2].data_ptr(), node_ok=cut[3].data_ptr(),
                    util=own[0].data_ptr(), bw_used=own[1].data_ptr(),
                    ports_free=own[2].data_ptr(),
                    job_count=own[3].data_ptr(), tg_count=own[4].data_ptr(),
                    feasible=f.data_ptr(), logits=out[0].data_ptr(),
                    pref=out[1].data_ptr()),
                    convex.relax_asks(asks)))
            plan = relax.relax_plan(tuple(s.n for s in segs), 1, k)

            def whole(iters):
                card = relax.card_launch("place", plan, g, iters, False,
                                         False, segs)
                return card, lambda: cuda.launch(
                    "nt_relax_solve", 0, relax.PHASES["all"], card.grid,
                    penalty, card.dims, card.table, card.stream)

            ms = {}
            for iters in (0, convex.SOLVE_ITERS, 24):
                card, fn = whole(iters)
                ms[f"all_{iters}"] = cs.time_cuda(torch, fn, cs.RUNS)
            card, _fn = whole(convex.SOLVE_ITERS)
            for name, phase in relax.PHASES.items():
                if phase < 0:
                    continue
                rows = name in ("prologue", "b", "x", "pref")
                grid = plan.row_tiles if rows else plan.col_tiles
                ms[name] = cs.time_cuda(torch, lambda: cuda.launch(
                    "nt_relax_solve", 0, phase, grid, penalty, card.dims,
                    card.table, card.stream), cs.RUNS)
            print(json.dumps({"relax": dict(
                b=1, k=k, n=n, shards=w, grid=card.grid,
                row_tiles=plan.row_tiles, col_tiles=plan.col_tiles,
                splits=plan.splits, pieces=plan.pieces_total,
                iteration_ms=(ms["all_24"] - ms["all_0"]) / 24, ms=ms)}))
            torch.cuda.synchronize()


def two_group_asks(torch, asks):
    """``asks`` as the greedy storm's 512 + 512 two-group job gives them
    (chip_smoke.two_group_job): task group 0's ask for the first half
    of each eval's steps, task group 1's (250 CPU, 384 MB) for the
    rest."""
    b, k = asks.bw.shape
    res = asks.resources.clone()
    res[:, k // 2:, 0] = 250.0
    res[:, k // 2:, 1] = 384.0
    tg = torch.zeros_like(asks.tg_index)
    tg[:, k // 2:] = 1
    return asks._replace(resources=res, tg_index=tg)


def scan_section(torch, np, cs, seed):
    """The greedy scan's cluster launch (section 8)."""
    from nomad_tpu_torch.ops import prng, scan

    dev = torch.device("cuda")
    n, g, k = cs.BENCH_N, 2, 1024
    shapes = (("B=1", 1, False, (1, 2, 4, 8, 16)),
              ("seq 4x1024", 4, True, (1, 4, 8, 16)),
              ("B=64", 64, False, (1, 2, 4)))
    for label, b, seq, sizes in shapes:
        base, jc, tgc, feas, asks, _u, keys = cs.kernel_inputs(
            torch, np, n, k, g, b, seed + 70 + b, dev)
        static = (base["capacity"], base["sched_capacity"],
                  base["bw_avail"], base["node_ok"])
        draw = prng.Draw(keys, 2.0)
        box = {}

        def fresh():
            box["c"] = (cs.seq_carry(base, jc, tgc) if seq
                        else cs.new_carry(torch, base, jc, tgc))

        def run(p, a=asks, prof=None):
            return scan.launch(p, static, box["c"], feas, a, draw, 10.0,
                               seq, prof)

        plan = scan.plan_for(dev, b, n, g, seq)
        fresh()
        want = (*run(plan), box["c"])
        steps = (b if seq else 1) * k
        for ctas in sizes:
            for resident in (None, False):
                try:
                    p = scan.plan_for(dev, b, n, g, seq, ctas, resident)
                except RuntimeError as e:
                    print(json.dumps({"clusters": dict(
                        shape=label, ctas=ctas, resident=resident,
                        refused=str(e))}))
                    continue
                if resident is False \
                        and p == scan.plan_for(dev, b, n, g, seq, ctas):
                    continue  # the plan's form is streamed already
                fresh()
                got = (*run(p), box["c"])
                cs.check(all(torch.equal(x, y) for x, y in zip(
                    (got[0], *got[2]), (want[0], *want[2]))),
                    f"K1 {label} on {ctas} CTAs ({p.form}) differs")
                print(json.dumps({"clusters": dict(
                    shape=label, ctas=ctas, threads=p.threads, form=p.form,
                    clusters=p.clusters, clusters_at_once=p.occupancy,
                    waves=p.waves, plan=p == plan,
                    ms=cs.time_cuda(torch, lambda: run(p), cs.RUNS,
                                    setup=fresh),
                    cluster_chain_ms=cs.cluster_chain_ms(
                        torch, steps, ctas, p.threads, dev))}))
        # The score cache on and off at the plan's launch, in turns, on
        # the record's asks (one ask throughout), the greedy storm's
        # (two runs of alike asks an eval) and varied asks (none alike).
        off = plan._replace(cache=False, smem=scan.layout(
            plan.ctas, plan.threads // 32, plan.slice, g, plan.resident,
            plan.stage_noise, plan.eval_bufs, False)[1])
        for kind, a in (("one ask", asks), ("two groups",
                                             two_group_asks(torch, asks)),
                        ("varied", cs.varied_asks(torch, asks, 7 + b))):
            outs = []
            for p in (plan, off):
                fresh()
                outs.append((*run(p, a), box["c"]))
            cs.check_scan(torch, f"K1 {label} {kind}: cache off", *outs)
            ms = {}
            for p in (plan, off, plan, off):
                ms.setdefault("on" if p is plan else "off", []).append(
                    cs.time_cuda(torch, lambda: run(p, a), cs.RUNS,
                                 setup=fresh))
            total, alike, _act, _both = cs.alike_steps(torch, a)
            print(json.dumps({"cache": dict(
                shape=label, asks=kind, alike_share=alike / total,
                cache=plan.cache, ctas=plan.ctas, form=plan.form,
                on_ms=ms["on"], off_ms=ms["off"])}))
        # The step's parts at the plan's cluster and form, the noise
        # drawn in the kernel and read from K0's (K0's draw is outside
        # the kernel's clock and inside the call's time), in turns.
        modes = {}
        for drawn in (True, False, True, False):
            p = scan.plan_for(dev, b, n, g, seq, plan.ctas, plan.resident,
                              drawn)
            prof = torch.zeros(len(scan.PARTS), dtype=torch.int64,
                               device=dev)
            fresh()
            got = (*run(p, prof=prof), box["c"])
            cs.check(all(torch.equal(x, y) for x, y in zip(
                (got[0], got[1], *got[2]), (want[0], want[1], *want[2]))),
                f"K1 {label} with the noise {drawn and 'drawn' or 'read'} "
                "differs")
            cycles = prof.tolist()
            ms = cs.time_cuda(torch, lambda: run(p), cs.RUNS, setup=fresh)
            modes.setdefault(drawn, []).append((ms, cycles, p))
        for drawn, runs in modes.items():
            ms, cycles, p = runs[0]
            step_us = ms * 1000.0 / steps
            share = [c / max(sum(cycles), 1) for c in cycles]
            print(json.dumps({"parts": dict(
                shape=label, ctas=p.ctas, threads=p.threads, form=p.form,
                drawn=drawn, plan=drawn == plan.drawn,
                stage_noise=p.stage_noise, ms=ms,
                ms_turns=[r[0] for r in runs], step_us=step_us,
                cycles=dict(zip(scan.PARTS, cycles)),
                share=dict(zip(scan.PARTS, share)),
                us_a_step={x: step_us * f
                           for x, f in zip(scan.PARTS, share)},
                one_block_chain_ms=cs.chain_ms(torch, steps, dev),
                cluster_chain_ms=cs.cluster_chain_ms(
                    torch, steps, p.ctas, p.threads, dev))}))
        torch.cuda.synchronize()
    round_parts(torch, np, cs, seed)
    gang_parts(torch, np, cs, seed)
    preempt_parts(torch, np, cs, seed)


def parts_record(torch, cs, kind, label, plan, steps, prof, ms, dev, **more):
    """One ``parts`` line: a step split into its parts from the kernel's
    clock counters (``prof``), at the call's measured time."""
    from nomad_tpu_torch.ops import scan

    cycles = prof.tolist()
    step_us = ms * 1000.0 / steps
    share = [c / max(sum(cycles), 1) for c in cycles]
    print(json.dumps({"parts": dict(
        kernel=kind, shape=label, ctas=plan.ctas, threads=plan.threads,
        form=plan.form, stage_noise=plan.stage_noise, cache=plan.cache,
        ms=ms, step_us=step_us, cycles=dict(zip(scan.PARTS, cycles)),
        share=dict(zip(scan.PARTS, share)),
        us_a_step={x: step_us * f for x, f in zip(scan.PARTS, share)},
        one_block_chain_ms=cs.chain_ms(torch, steps, dev),
        cluster_chain_ms=cs.cluster_chain_ms(torch, steps, plan.ctas,
                                             plan.threads, dev), **more)}))


def round_parts(torch, np, cs, seed):
    """K8b's step parts (section 8 (d)) at its plan, at the convex
    program's shapes: the 512 + 512 eval (B = 1, K = 1,024) and a storm
    eval under pre_resolve (seq, 1 x 8), N = 10,240; K0's noise and a
    seeded pref read; held against the plain version."""
    from nomad_tpu_torch.kernels import convex
    from nomad_tpu_torch.ops import prng, scan

    dev = torch.device("cuda")
    n, g = cs.BENCH_N, 2
    for label, k, seq in (("1x1024", 1024, False), ("seq 1x8", 8, True)):
        base, jc, tgc, feas, asks, _u, keys = cs.kernel_inputs(
            torch, np, n, k, g, 1, seed + 80 + k, dev)
        static = (base["capacity"], base["sched_capacity"],
                  base["bw_avail"], base["node_ok"])
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)
        pref = torch.rand((1, k, n), device=dev,
                          generator=torch.Generator(dev).manual_seed(seed))
        box = {}

        def fresh():
            box["c"] = (cs.seq_carry(base, jc, tgc) if seq
                        else cs.new_carry(torch, base, jc, tgc))

        plan = scan.plan_for(dev, 1, n, g, seq, bias=True)
        prof = torch.zeros(len(scan.PARTS), dtype=torch.int64, device=dev)
        fresh()
        got = (*scan.launch_round(plan, static, box["c"], feas, asks, noise,
                                  pref, 10.0, seq, prof), box["c"])
        fresh()
        want = (*convex.convex_round_plain(*static, box["c"], feas, asks,
                                           noise, 10.0, pref, seq), box["c"])
        cs.check_scan(torch, f"K8b {label} (timed kernel)", got, want)
        ms = cs.time_cuda(torch, lambda: convex.convex_round(
            *static, box["c"], feas, asks, noise, 10.0, pref, seq), cs.RUNS,
            setup=fresh)
        parts_record(torch, cs, "K8b", label, plan, k, prof, ms, dev)
        torch.cuda.synchronize()


def gang_parts(torch, np, cs, seed):
    """K7's step parts (section 8 (d)) at its plan, at phase 6's timed
    shapes on chip_smoke's node rows: a free gang under distinct_hosts
    (K = 1,024, racks of 40, g_pad 256), an ici slice (K = 64, groups of
    16, g_pad 1,024) and a spread without meta (K = 512, every node its
    own group, g_pad 10,240); held against the plain version."""
    from nomad_tpu_torch.ops import gang as ops_gang
    from nomad_tpu_torch.ops import prng, scan

    dev = torch.device("cuda")
    n = cs.BENCH_N
    for label, k, size, g_pad, mode, dh in (
            ("free K=1024", 1024, 40, 256, "free", True),
            ("ici slice K=64", 64, 16, 1024, "slice", False),
            ("spread K=512 no meta", 512, 1, 10240, "spread", False)):
        base, jc, _tgc, feas, _a, _u, keys = cs.kernel_inputs(
            torch, np, n, 8, 2, 1, seed + 60 + k, dev)
        topo = torch.arange(n, dtype=torch.int32, device=dev) // size
        state = ops_gang.GangState(
            base["capacity"], base["sched_capacity"], base["util"],
            base["bw_avail"], base["bw_used"], base["ports_free"],
            base["node_ok"] & feas[0, :, 0], jc[0].contiguous(),
            torch.zeros(n, dtype=torch.int32, device=dev), topo)
        ask = torch.tensor([500.0, 256.0, 300.0, 0.0], device=dev)
        abw = torch.tensor(50.0, device=dev)
        aports = torch.tensor(1.0, device=dev)
        active = torch.ones(k, dtype=torch.bool, device=dev)
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)[0]
        gnoise = prng.threefry_uniform(keys + 1, (g_pad,), 0.0, 1.0)[0]
        cfg = ops_gang.GangConfig(anti_affinity_penalty=10.0, mode=mode,
                                  distinct_hosts=dh, g_pad=g_pad)
        box = {}

        def fresh():
            box["a"] = (state._replace(util=state.util.clone(),
                                       bw_used=state.bw_used.clone(),
                                       ports_free=state.ports_free.clone()),
                        ask, abw, aports, active, noise, gnoise, cfg,
                        torch.zeros(n, dtype=torch.int32, device=dev),
                        torch.zeros(g_pad, device=dev))

        m = ops_gang._MODE_IDS[mode]
        plan = scan.gang_plan_for(dev, n, g_pad, m)
        prof = torch.zeros(len(scan.PARTS), dtype=torch.int64, device=dev)
        fresh()
        a = box["a"]
        got = scan.launch_gang(plan, *a[:7], m, dh, 10.0, a[8], a[9], prof)
        fresh()
        want = ops_gang.gang_scan_plain(*box["a"])
        cs.check(torch.equal(got[0], want[0]) and int(got[2]) == int(
            want[2]) and (got[1] - want[1]).abs().max().item() <= 1e-4,
            f"K7 {label} (timed kernel) differs from the plain version")
        ms = cs.time_cuda(torch, lambda: ops_gang.gang_scan(*box["a"]),
                          cs.RUNS, setup=fresh)
        parts_record(torch, cs, "K7", label, plan, k, prof, ms, dev,
                     groups="shared" if plan.groups else "global",
                     placed=int((got[0] >= 0).sum()))
        torch.cuda.synchronize()


def preempt_inputs(torch, np, n, k, seed, dev):
    """A red cluster of chip_smoke's phase 5 shape for K6: every node
    full but 256, five victims a node at priorities 10-40 (the filler
    jobs) with footprints from ``seed``, one task group under
    distinct_hosts, K asks of one resource vector."""
    from nomad_tpu_torch.ops import binpack, preempt

    rng = np.random.default_rng(seed)
    v = preempt.PREEMPT_MAX_VICTIMS
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    cap = np.tile(np.array([[4000, 8192, 102400, 150]], np.float32), (n, 1))
    sched = cap - np.array([[100, 256, 4096, 0]], np.float32)
    res = np.zeros((n, v, 4), np.float32)
    res[:, :5, 0] = rng.integers(7, 9, (n, 5)) * 100
    res[:, :5, 1] = rng.integers(12, 16, (n, 5)) * 100
    util = (cap - sched) + res.sum(1)
    util[rng.choice(n, 256, replace=False), :2] = (100, 256)
    prio = np.full((n, v), np.inf, np.float32)
    prio[:, :5] = np.sort(rng.choice([10, 20, 30, 40], (n, 5)), 1)
    ok = np.zeros((n, v), bool)
    ok[:, :5] = True
    state = binpack.NodeState(
        t(cap), t(sched), t(util), t(np.full(n, 1000, np.float32)),
        t(np.zeros(n, np.float32)), t(np.full(n, 6, np.float32)),
        t(np.zeros(n, np.int32)), t(np.zeros((n, 1), np.int32)),
        t(np.ones((n, 1), bool)), t(np.ones(n, bool)))
    victims = preempt.VictimState(t(res), t(np.zeros((n, v), np.float32)),
                                  t(np.zeros((n, v), np.float32)), t(prio),
                                  t(ok))
    asks = binpack.Asks(
        t(np.tile(np.array([[500, 256, 300, 0]], np.float32), (k, 1))),
        t(np.zeros(k, np.float32)), t(np.ones(k, np.float32)),
        t(np.zeros(k, np.int32)), t(np.ones(k, bool)),
        torch.tensor(False, device=dev), t(np.array([True])))
    return state, victims, asks


def preempt_parts(torch, np, cs, seed):
    """K6's step parts (section 8 (d)) at its plan, at phase 5's shapes
    (K = 1,024 and 8 on a red cluster of 10,240 nodes: 256 with room,
    the rest evicting); held against the plain version."""
    from nomad_tpu_torch.ops import preempt, prng, scan

    dev = torch.device("cuda")
    n = cs.BENCH_N
    for k in (1024, 8):
        state, victims, asks = preempt_inputs(torch, np, n, k, seed + k, dev)
        keys = torch.tensor([[0, seed + k]], device=dev)
        noise = prng.threefry_uniform(keys, (k, n), 0.0, 2.0)[0]
        box = {}

        def fresh():
            box["a"] = (state._replace(
                util=state.util.clone(), bw_used=state.bw_used.clone(),
                ports_free=state.ports_free.clone(),
                job_count=state.job_count.clone(),
                tg_count=state.tg_count.clone()), victims,
                victims.ok.clone(), asks, noise, 70.0, 10.0)

        plan = scan.preempt_plan_for(dev, n, 1)
        prof = torch.zeros(len(scan.PARTS), dtype=torch.int64, device=dev)
        fresh()
        got = scan.launch_preempt(plan, *box["a"], prof)
        fresh()
        want = preempt.preempt_scan_plain(*box["a"])
        cs.check(torch.equal(got[0], want[0]) and torch.equal(
            got[2], want[2]) and (got[1] - want[1]).abs().max().item()
            <= 1e-4, f"K6 K={k} (timed kernel) differs from the plain "
            "version")
        ms = cs.time_cuda(torch, lambda: preempt.preempt_scan(*box["a"]),
                          cs.RUNS, setup=fresh)
        parts_record(torch, cs, "K6", f"K={k}", plan, k, prof, ms, dev,
                     placed=int((got[0] >= 0).sum()),
                     evicting=int((got[2] > 0).sum()))
        torch.cuda.synchronize()


MODE_BATCHES = (4, 16, 17, 31, 33, 64)


def modes_section(torch, np, cs, seed):
    """The greedy scan's two noise modes by B (section 9)."""
    from nomad_tpu_torch.ops import prng, scan

    dev = torch.device("cuda")
    n, g, k = cs.BENCH_N, 2, 1024
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in MODE_BATCHES:
        base, jc, tgc, feas, asks, _u, keys = cs.kernel_inputs(
            torch, np, n, k, g, b, seed + 90 + b, dev)
        static = (base["capacity"], base["sched_capacity"],
                  base["bw_avail"], base["node_ok"])
        draw = prng.Draw(keys, 2.0)
        box = {}

        def fresh():
            box["c"] = cs.new_carry(torch, base, jc, tgc)

        def run(p):
            return scan.launch(p, static, box["c"], feas, asks, draw, 10.0,
                               False)

        plan = scan.plan_for(dev, b, n, g, False)
        plans = {d: scan.plan_for(dev, b, n, g, False, drawn=d)
                 for d in (True, False)}
        outs = {}
        for d, p in plans.items():
            fresh()
            outs[d] = (*run(p), *box["c"])
        cs.check(all(torch.equal(x, y)
                     for x, y in zip(outs[True], outs[False])),
                 f"K1 B={b}: the drawn and the read noise differ")
        del outs
        ms = {True: [], False: []}
        for d in (True, False, True, False):
            ms[d].append(cs.time_cuda(torch, lambda: run(plans[d]), cs.RUNS,
                                      setup=fresh))
        k0_ms = cs.time_cuda(torch, lambda: prng.threefry_uniform(
            keys, (k, n), 0.0, 2.0), cs.RUNS)
        print(json.dumps({"modes": dict(
            B=b, plan="drawn" if plan.drawn else "read", k0_ms=k0_ms,
            k0_nodes_an_sm_step=b * n / sms, **{
                ("drawn" if d else "read"): dict(
                    ctas=p.ctas, threads=p.threads, form=p.form,
                    stage_noise=p.stage_noise, cache=p.cache,
                    nodes_a_cta_step=p.slice, ms=ms[d])
                for d, p in plans.items()})}))
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sections",
                    default="host,waves,steps,shards,relax,scan,modes",
                    help="comma-separated sections to run (build and card "
                    "always print)")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    import torch

    if not torch.cuda.is_available():
        print("topk_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from nomad_tpu_torch.ops import binpack, cuda, prng
    import numpy as np

    dev = torch.device("cuda")
    print(json.dumps({"card": cs.card_identity()}))
    cuda.library()
    log = os.path.join(os.path.dirname(cuda.build_info["path"]), "build.log")
    print(json.dumps({"build": build_entries(log)}))
    n, g = cs.BENCH_N, 2

    def inputs(b, k, seed):
        base, jc, tgc, feas, _a, uasks, keys = cs.kernel_inputs(
            torch, np, n, k, g, b, seed, dev)
        static = (base["capacity"], base["sched_capacity"], base["bw_avail"],
                  base["node_ok"])
        return base, jc, tgc, feas, uasks, static, prng.Draw(keys, 2.0)

    def occupancy(b, k, seq, cps):
        out = (ctypes.c_int * 1)()
        cuda.launch("nt_uniform_topk_occupancy", b, g, k, n, int(seq), cps,
                    out)
        return out[0]

    if "host" in sections:
        # ---- host: B = 1, K = 1,024
        b, k = 1, 1024
        base, jc, tgc, feas, uasks, static, draw = inputs(b, k, args.seed + 1)
        carry = cs.new_carry(torch, base, jc, tgc)
        box = {"c": carry}
        fresh = lambda: box.__setitem__(  # noqa: E731
            "c", cs.new_carry(torch, base, jc, tgc))
        # The host spans reuse one carry; the card's times take a fresh one
        # a call (a carry filled by earlier calls ties every key).
        call = lambda: binpack.uniform_topk(  # noqa: E731
            *static, box["c"], feas, uasks, draw, 10.0)
        checks = lambda: (  # noqa: E731
            binpack._check_scan_args(*static, carry, feas, uasks, None, None,
                                     False),
            binpack._check_draw(draw, b, n, static[0].device))
        ts = (*static, *carry, feas)

        def arrays():
            dims = (ctypes.c_longlong * 2)(0, n)
            ptrs = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in ts])
            return dims, ptrs

        dims, ptrs = arrays()
        choices = torch.empty((b, k), dtype=torch.int32, device=dev)
        scores = torch.empty((b, k), dtype=torch.float32, device=dev)
        stream = cuda.stream_ptr(dev)
        launch = lambda: cuda.launch(  # noqa: E731
            "nt_uniform_topk", b, g, k, 1, n, 10.0, 0, 0, binpack.TOPK_CLUSTER,
            1, dims, ptrs, uasks.resources.data_ptr(), uasks.bw.data_ptr(),
            uasks.ports.data_ptr(), uasks.tg_index.data_ptr(),
            uasks.active.data_ptr(), uasks.job_distinct_hosts.data_ptr(),
            uasks.tg_distinct_hosts.data_ptr(), draw.keys.data_ptr(),
            draw.scale32, choices.data_ptr(), scores.data_ptr(), stream)
        one = torch.empty(1, dtype=torch.int32, device=dev)
        small = lambda: cuda.launch(  # noqa: E731
            "nt_argmax_chain", 1, one.data_ptr(), stream)
        score = torch.randn((b, n), device=dev)
        topk = lambda: torch.topk(score, k, dim=1)  # noqa: E731
        alloc = lambda: (  # noqa: E731
            torch.empty((b, k), dtype=torch.int32, device=dev),
            torch.empty((b, k), dtype=torch.float32, device=dev))
        print(json.dumps({"host": dict(
            b=b, k=k, call_ms=cs.host_ms(torch, call, RUNS),
            checks_ms=cs.host_ms(torch, checks, RUNS),
            arrays_ms=cs.host_ms(torch, arrays, RUNS),
            alloc_ms=cs.host_ms(torch, alloc, RUNS),
            stream_ms=cs.host_ms(torch, lambda: cuda.stream_ptr(dev),
                                 RUNS),
            count_ms=cs.host_ms(torch, lambda: cuda.count_launch(
                "uniform_topk"), RUNS),
            launch_ms=cs.host_ms(torch, launch, RUNS),
            smallest_launch_ms=cs.host_ms(torch, small, RUNS),
            library_call_ms=cs.host_ms(torch, topk, RUNS),
            call_event_ms=cs.time_cuda(torch, call, RUNS, setup=fresh),
            call_device_ms=cs.device_ms(torch, call, RUNS, setup=fresh,
                                        match="topk"),
            library_event_ms=cs.time_cuda(torch, topk, RUNS),
            library_device_ms=cs.device_ms(torch, topk, RUNS))}))

    if "waves" in sections:
        # ---- waves: K = 1,024, B = 1 and 64, 1-8 CTAs a cluster
        for b in (1, 64):
            base, jc, tgc, feas, uasks, static, draw = inputs(
                b, k, args.seed + b)
            want = None
            for cps in (1, 2, 4, 8):
                box = {}
                fresh = lambda: box.__setitem__(  # noqa: E731
                    "c", cs.new_carry(torch, base, jc, tgc))

                def run(cps=cps):
                    segs = [(0, n, (*static, *box["c"], feas))]
                    return binpack.uniform_topk_cluster(
                        "uniform_topk", segs, uasks, draw, g, n, 10.0, False,
                        False, cps)

                fresh()
                got = run()
                want = want or got
                cs.check(torch.equal(got[0], want[0]) and torch.equal(
                    got[1], want[1]), f"K2 B={b} with {cps} CTAs differs")
                print(json.dumps({"waves": dict(
                    b=b, k=k, ctas=cps, clusters=b,
                    clusters_at_once=occupancy(b, k, False, cps),
                    call_ms=cs.time_cuda(torch, run, RUNS, setup=fresh),
                    device_ms=cs.device_ms(torch, run, RUNS, setup=fresh,
                                           match="topk"))}))

    if "steps" in sections:
        # ---- steps: config 4's storm kernel, B = 64, K = 8, seq
        b, k = 64, 8
        base, jc, tgc, feas, uasks, static, draw = inputs(
            b, k, args.seed + 11)
        box = {}
        fresh = lambda: box.__setitem__(  # noqa: E731
            "c", cs.seq_carry(base, jc, tgc))
        held = None
        for step, cps, resident in (("A.3", 8, True), ("A.1", 1, False),
                                    ("A.2", 8, False)):
            def run(cps=cps, resident=resident):
                segs = [(0, n, (*static, *box["c"], feas))]
                return binpack.uniform_topk_cluster(
                    "uniform_topk_seq", segs, uasks, draw, g, n, 10.0, True,
                    False, cps, resident=resident)

            fresh()
            got = (*run(), box["c"])
            held = held or got
            cs.check(all(torch.equal(x, y) for x, y in zip(
                (got[0], got[1], *got[2]), (held[0], held[1], *held[2]))),
                f"K2-seq step {step} differs from A.3")
            print(json.dumps({"steps": dict(
                step=step, b=b, k=k, ctas=cps, resident=resident,
                call_ms=cs.time_cuda(torch, run, cs.RUNS, setup=fresh),
                device_ms=cs.device_ms(torch, run, cs.RUNS, setup=fresh,
                                       match="topk"))}))
    if "shards" in sections:
        shard_section(torch, np, cs, args.seed)
    if "relax" in sections:
        relax_section(torch, np, cs, args.seed)
    if "scan" in sections:
        scan_section(torch, np, cs, args.seed)
    if "modes" in sections:
        modes_section(torch, np, cs, args.seed)
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
