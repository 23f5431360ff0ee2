#!/usr/bin/env python3
"""Where the time of the uniform top-K kernel (csrc/uniform_topk.cu)
goes on one NVIDIA card, at chip_smoke.py's widths (N = 10,240 nodes,
G = 2, inputs from chip_smoke.kernel_inputs).

    python3 topk_profile.py [--seed N]

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


def host_ms(torch, fn, runs=RUNS):
    """Median host span of ``fn()`` in ms, the card synchronised before
    each call (so no queue of earlier work delays the launch)."""
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
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
        return base, jc, tgc, feas, uasks, static, prng.threefry_uniform(
            keys, (n,), 0.0, 2.0)

    def occupancy(b, k, seq, cps):
        out = (ctypes.c_int * 1)()
        cuda.launch("nt_uniform_topk_occupancy", b, g, k, n, int(seq), cps,
                    out)
        return out[0]

    # ---- host: B = 1, K = 1,024
    b, k = 1, 1024
    base, jc, tgc, feas, uasks, static, noise = inputs(b, k, args.seed + 1)
    carry = cs.new_carry(torch, base, jc, tgc)
    box = {"c": carry}
    fresh = lambda: box.__setitem__(  # noqa: E731
        "c", cs.new_carry(torch, base, jc, tgc))
    # The host spans reuse one carry; the card's times take a fresh one
    # a call (a carry filled by earlier calls ties every key).
    call = lambda: binpack.uniform_topk(  # noqa: E731
        *static, box["c"], feas, uasks, noise, 10.0)
    checks = lambda: binpack._check_scan_args(  # noqa: E731
        *static, carry, feas, uasks, noise, (n,), False)
    ts = (*static, *carry, feas, noise)

    def arrays():
        dims = (ctypes.c_longlong * 2)(0, n)
        ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in ts])
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
        uasks.tg_distinct_hosts.data_ptr(), choices.data_ptr(),
        scores.data_ptr(), stream)
    one = torch.empty(1, dtype=torch.int32, device=dev)
    small = lambda: cuda.launch(  # noqa: E731
        "nt_argmax_chain", 1, one.data_ptr(), stream)
    score = torch.randn((b, n), device=dev)
    topk = lambda: torch.topk(score, k, dim=1)  # noqa: E731
    alloc = lambda: (  # noqa: E731
        torch.empty((b, k), dtype=torch.int32, device=dev),
        torch.empty((b, k), dtype=torch.float32, device=dev))
    print(json.dumps({"host": dict(
        b=b, k=k, call_ms=host_ms(torch, call),
        checks_ms=host_ms(torch, checks),
        arrays_ms=host_ms(torch, arrays),
        alloc_ms=host_ms(torch, alloc),
        stream_ms=host_ms(torch, lambda: cuda.stream_ptr(dev)),
        count_ms=host_ms(torch, lambda: cuda.count_launch("uniform_topk")),
        launch_ms=host_ms(torch, launch),
        smallest_launch_ms=host_ms(torch, small),
        library_call_ms=host_ms(torch, topk),
        call_event_ms=cs.time_cuda(torch, call, RUNS, setup=fresh),
        call_device_ms=cs.device_ms(torch, call, RUNS, setup=fresh,
                                    match="topk"),
        library_event_ms=cs.time_cuda(torch, topk, RUNS),
        library_device_ms=cs.device_ms(torch, topk, RUNS))}))

    # ---- waves: K = 1,024, B = 1 and 64, 1-8 CTAs a cluster
    for b in (1, 64):
        base, jc, tgc, feas, uasks, static, noise = inputs(
            b, k, args.seed + b)
        want = None
        for cps in (1, 2, 4, 8):
            box = {}
            fresh = lambda: box.__setitem__(  # noqa: E731
                "c", cs.new_carry(torch, base, jc, tgc))

            def run(cps=cps):
                segs = [(0, n, (*static, *box["c"], feas, noise))]
                return binpack.uniform_topk_cluster(
                    "uniform_topk", segs, uasks, g, n, 10.0, False, False,
                    cps)

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

    # ---- steps: config 4's storm kernel, B = 64, K = 8, seq
    b, k = 64, 8
    base, jc, tgc, feas, uasks, static, noise = inputs(b, k, args.seed + 11)
    box = {}
    fresh = lambda: box.__setitem__(  # noqa: E731
        "c", cs.seq_carry(base, jc, tgc))
    held = None
    for step, cps, resident in (("A.3", 8, True), ("A.1", 1, False),
                                ("A.2", 8, False)):
        def run(cps=cps, resident=resident):
            segs = [(0, n, (*static, *box["c"], feas, noise))]
            return binpack.uniform_topk_cluster(
                "uniform_topk_seq", segs, uasks, g, n, 10.0, True, False,
                cps, resident=resident)

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
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
