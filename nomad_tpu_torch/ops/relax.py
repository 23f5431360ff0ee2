"""The host side of the mirror-descent solve (K8a, K9, K10f, K10g-a):
one launch of csrc/relax.cuh's persistent kernel a card.

``relax_plan`` cuts the node axis of a solve into the kernel's tiles
from the shapes alone: row tiles of 16 rows over one piece of a
segment, column tiles of 128 nodes over one span of the rows, no tile
across a segment. Every
shard of a card is one segment of one cooperative launch (``solve``'s
"card" route), whose grid is as many blocks as fit on the card at once
(``grid_size``, from the kernel's occupancy, cached a device). Shards
on distinct cards (or more than ``SEGS`` of one card) take the
"shards" route: the same phases, one launch a phase a shard, their
statistics combined on the first shard's card between phases
(``nt_relax_combine``) and sent back; the same pieces and the same
orders give the same bits as the card route.

Scratch (the kernel allocates nothing) is one allocation a card, cut by
pointer (``scratch_bytes``); the grid barrier word and the tiles'
counters are one zeroed int32 buffer a (device, stream), which every
launch leaves zeroed, as K10b's counter.

Nothing here runs at import, and nothing here runs on the CPU: the
wrappers (kernels/convex.py, parallel/shard.py) run the plain versions
for CPU tensors and call ``solve`` for CUDA ones.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from . import cuda

# csrc/relax.cuh: rows a row tile (NT_RX_WARPS), nodes a column tile
# (NT_RX_COL), segments a launch (NT_RX_SEGS), pieces a segment
# (NT_RX_PIECES_MAX), spans of rows a column tile (NT_RX_SPLITS).
ROW_TILE = 16
COL_TILE = 128
SEGS = 8
PIECES_MAX = 256
SPLITS_MAX = 8
# A piece holds at least PIECE_MIN nodes; pieces are cut so that a row
# phase has about ROW_TILES tiles (every SM busy, the folds short). A
# column tile's rows are cut into spans of at least SPAN_MIN rows so
# that a column phase has about COL_TILES tiles.
PIECE_MIN = 128
ROW_TILES = 512
SPAN_MIN = 32
COL_TILES = 320

MODES = {"place": 0, "defrag": 1, "loop": 2}
PHASES = {"all": -1, "prologue": 0, "a": 1, "b": 2, "x": 3, "y": 4,
          "pref": 5}
# NtRxArgs' pointers (csrc/relax.cuh), in order: the asks, the asks
# scaled by activity, then what crosses tiles.
ASK_PTRS = ("ask_res", "ask_bw", "ask_ports", "tg_index", "active",
            "job_dh", "tg_dh", "fresh", "res_active", "bw_active",
            "ports_active", "act")
CROSS_PTRS = ("part_m", "part_s", "npart", "stats_out", "stats_in",
              "rowmax_out", "rowmax_in", "ypart", "ymax_out", "ymax_in",
              "bar", "cnt")
# NtRxSeg's pointers, in order.
SEG_PTRS = ("capacity", "sched", "bw_avail", "node_ok", "util", "bw_used",
            "ports_free", "job_count", "tg_count", "feasible", "logits", "x",
            "pref", "mask", "lin", "denom", "base_frac", "bw_denom",
            "base_bw_frac", "ports_denom", "terms", "y")


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


class RelaxPlan(NamedTuple):
    """The tiles of one launch: B evals x K rows over segments of
    ``nodes`` nodes; segment s cut into ``pieces[s]`` pieces of
    ``piece[s]`` nodes (numbered from ``piece0[s]``) and ``cols[s]``
    column tiles of COL_TILE nodes (from ``col0[s]``), each column tile
    over ``splits`` spans of the rows."""

    b: int
    k: int
    nodes: Tuple[int, ...]
    piece: Tuple[int, ...]
    pieces: Tuple[int, ...]
    piece0: Tuple[int, ...]
    cols: Tuple[int, ...]
    col0: Tuple[int, ...]
    splits: int

    @property
    def row_groups(self) -> int:
        return -(-self.k // ROW_TILE)

    @property
    def pieces_total(self) -> int:
        return sum(self.pieces)

    @property
    def cols_total(self) -> int:
        return sum(self.cols)

    @property
    def row_tiles(self) -> int:
        return self.b * self.row_groups * self.pieces_total

    @property
    def col_tiles(self) -> int:
        return self.b * self.cols_total * self.splits

    @property
    def counters(self) -> int:
        """The barrier word, one counter a row group, one an eval, one
        a column tile's node span."""
        return 1 + self.b * self.row_groups + self.b \
            + self.b * self.cols_total

    def dims(self, mode: str, g: int, iters: int, stacked: bool,
             shared: bool) -> List[int]:
        """The launch table's dims (csrc/convex_relax.cu nt_rx_args)."""
        out = [MODES[mode], self.b, self.k, g, iters, int(stacked),
               int(shared), len(self.nodes), self.row_groups,
               self.pieces_total, self.cols_total, self.splits]
        for s in range(len(self.nodes)):
            out += [self.nodes[s], self.piece[s], self.pieces[s],
                    self.piece0[s], self.col0[s]]
        return out


@functools.lru_cache(maxsize=256)
def relax_plan(nodes: Tuple[int, ...], b: int, k: int) -> RelaxPlan:
    """The tiles for segments of ``nodes`` nodes (in shard order), B
    evals and K rows. Pieces share one length over the launch, chosen
    so that a row phase has about ROW_TILES tiles and at least
    PIECE_MIN nodes a piece (a multiple of 32), and grown on a segment
    past PIECES_MAX x that length; the rows split into spans of at
    least SPAN_MIN for about COL_TILES column tiles. It depends on the
    shapes alone (``shard_plan`` cuts a shard as the card's plan
    does)."""
    nodes = tuple(int(n) for n in nodes)
    if not nodes or min(nodes) < 1 or b < 1 or k < 1:
        raise ValueError(f"no solve over nodes {nodes}, B {b}, K {k}")
    row_groups = -(-k // ROW_TILE)
    want = max(1, -(-ROW_TILES // (b * row_groups)))
    base = max(PIECE_MIN, _up(-(-sum(nodes) // want), 32))
    piece, pieces, piece0, cols, col0 = [], [], [], [], []
    for n in nodes:
        p = max(base, _up(-(-n // PIECES_MAX), 32))
        piece0.append(sum(pieces))
        piece.append(p)
        pieces.append(-(-n // p))
        col0.append(sum(cols))
        cols.append(-(-n // COL_TILE))
    splits = max(1, min(-(-COL_TILES // (b * sum(cols))), k // SPAN_MIN,
                        SPLITS_MAX))
    return RelaxPlan(b, k, nodes, tuple(piece), tuple(pieces),
                     tuple(piece0), tuple(cols), tuple(col0), splits)


def shard_plan(whole: RelaxPlan, s: int) -> RelaxPlan:
    """Segment s of ``whole`` as a launch of its own (the shards route):
    its pieces and column tiles numbered from 0."""
    return RelaxPlan(whole.b, whole.k, (whole.nodes[s],), (whole.piece[s],),
                     (whole.pieces[s],), (0,), (whole.cols[s],), (0,),
                     whole.splits)


def grid_size(plan: RelaxPlan, blocks_per_sm: int, sms: int) -> int:
    """Blocks of a card route's cooperative launch: every block resident
    at once (``blocks_per_sm`` from the kernel's occupancy x the SMs),
    and no more than the larger phase has tiles."""
    if blocks_per_sm < 1 or sms < 1:
        raise ValueError(f"the kernel fits {blocks_per_sm} blocks a SM on "
                         f"{sms} SMs: no co-resident grid")
    return max(1, min(blocks_per_sm * sms,
                      max(plan.row_tiles, plan.col_tiles)))


def route(devices: Sequence) -> str:
    """"card": every segment on one card, at most SEGS of them, one
    launch; else "shards": a launch a phase a shard."""
    devs = {torch.device(d) for d in devices}
    return "card" if len(devs) == 1 and len(devices) <= SEGS else "shards"


def launches(route_: str, w: int, iters: int, mode: str) -> int:
    """Launches of one solve: 1 on a card; on the shards route, W a
    phase, plus a combine after the prologue, each iteration and (in
    placement mode) the maxima."""
    if route_ == "card":
        return 1
    n = (w + 1) + iters * (2 * w + 1) + w
    if mode == "place":
        n += (w + 1) + w
    return n


def scratch_bytes(plan: RelaxPlan, mode: str,
                  given: Sequence[str] = ()) -> List[Tuple[str, int, int]]:
    """The launch's scratch as (name, segment or -1, bytes), in carving
    order (each 16-byte aligned): the asks scaled by activity and what
    crosses tiles, then each segment's mask, lin and node terms; ``given``
    names what the caller passes (the loop-only mode's operands)."""
    b, k = plan.b, plan.k
    bk = b * k
    out = []
    glob = [("res_active", 16 * bk), ("bw_active", 4 * bk),
            ("ports_active", 4 * bk), ("act", 4 * bk),
            ("part_m", 4 * plan.pieces_total * bk),
            ("part_s", 4 * plan.pieces_total * bk),
            ("npart", 8 * plan.splits * b * plan.cols_total * 6 * COL_TILE),
            ("stats", 8 * bk),
            ("rowmax", 4 * bk), ("ypart", 4 * b * plan.cols_total),
            ("ymax", 4 * b)]
    out += [(name, -1, size) for name, size in glob if name not in given]
    for s, n in enumerate(plan.nodes):
        seg = [("mask", bk * n), ("lin", 4 * bk * n), ("denom", 16 * b * n),
               ("base_frac", 16 * b * n), ("bw_denom", 4 * b * n),
               ("base_bw_frac", 4 * b * n), ("ports_denom", 4 * b * n),
               ("terms", 24 * b * n), ("y", 4 * b * n)]
        out += [(name, s, size) for name, size in seg if name not in given]
    return out


@functools.lru_cache(maxsize=256)
def _layout(plan: RelaxPlan, mode: str, given: Tuple[str, ...]):
    """``scratch_bytes`` laid out in one allocation: (bytes, ((name,
    segment), offset) pairs), each offset 16-byte aligned."""
    offsets, total = [], 0
    for name, s, size in scratch_bytes(plan, mode, given):
        offsets.append(((name, s), total))
        total += _up(size, 16)
    return max(total, 16), tuple(offsets)


def _carve(dev, plan, mode, given) -> Tuple[torch.Tensor, Dict]:
    """The launch's scratch as one uint8 allocation on ``dev``: (buffer,
    {(name, segment): pointer})."""
    total, offsets = _layout(plan, mode, tuple(given))
    buf = torch.empty(total, dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    return buf, {key: base + at for key, at in offsets}


_counters: dict = {}
_occupancy: dict = {}


def counters(dev, stream: int, need: int) -> torch.Tensor:
    """The zeroed int32 barrier word and tile counters of (device,
    stream), grown to ``need``; every launch leaves them zeroed."""
    key = (torch.device(dev), stream)
    c = _counters.get(key)
    if c is None or c.numel() < need:
        c = _counters[key] = torch.zeros(max(need, 2 * (0 if c is None
                                                        else c.numel())),
                                         dtype=torch.int32, device=dev)
    return c


def occupancy(dev, float_mask: bool) -> Tuple[int, int]:
    """(blocks a SM, SMs) of the kernel on ``dev``, asked once."""
    import ctypes

    dev = torch.device(dev)
    key = (dev, bool(float_mask))
    got = _occupancy.get(key)
    if got is None:
        blocks = ctypes.c_int(0)
        with cuda.on_device(dev):
            cuda.launch("nt_relax_occupancy", int(float_mask),
                        ctypes.byref(blocks))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        got = _occupancy[key] = (int(blocks.value), int(sms))
    return got


class Segment(NamedTuple):
    """One node segment of a solve: its device, nodes, NtRxSeg pointers
    by name (missing: the launch's scratch, or none) and the asks'
    pointers by name (ASK_PTRS; missing: scratch, or none)."""

    device: torch.device
    n: int
    ptrs: Dict[str, int]
    asks: Dict[str, int]


def _table(plan, mode, g, iters, stacked, shared, asks, cross, segs):
    ptrs = [asks.get(name, 0) for name in ASK_PTRS]
    ptrs += [cross.get(name, 0) for name in CROSS_PTRS]
    for seg in segs:
        ptrs += [seg.get(name, 0) for name in SEG_PTRS]
    return cuda.table(plan.dims(mode, g, iters, stacked, shared), ptrs)


def _fill(plan, mode, segs, dev, given):
    """Scratch for what the callers do not pass: (buffer, asks, cross,
    per-segment pointer dicts)."""
    buf, at = _carve(dev, plan, mode, given)
    asks = dict(segs[0].asks)
    for name in ("res_active", "bw_active", "ports_active", "act"):
        asks.setdefault(name, at.get((name, -1), 0))
    cross = {name: at.get((name, -1), 0)
             for name in ("part_m", "part_s", "npart", "ypart")}
    out = []
    for s, seg in enumerate(segs):
        ptrs = dict(seg.ptrs)
        for name in SEG_PTRS:
            if name not in ptrs and (name, s) in at:
                ptrs[name] = at[(name, s)]
        if mode == "place" and not ptrs.get("x"):
            ptrs["x"] = ptrs["pref"]  # x staged in pref's buffer
        out.append(ptrs)
    return buf, asks, cross, at, out


def solve(mode: str, b: int, k: int, g: int, iters: int, penalty: float,
          stacked: bool, shared: bool, segs: List[Segment],
          force_shards: bool = False) -> int:
    """One mirror-descent solve over ``segs`` (in shard order) in
    ``mode`` ("place", "defrag" or "loop"); the outputs land in the
    segments' logits, x and pref. Returns the launches it made (the
    caller counts them under its kernel's name). ``force_shards`` takes
    the shards route on one card (the tests' hook)."""
    if b == 0 or k == 0:
        return 0
    devices = [s.device for s in segs]
    plan = relax_plan(tuple(s.n for s in segs), b, k)
    float_mask = mode == "loop"
    how = "shards" if force_shards else route(devices)
    if how == "card":
        card = card_launch(mode, plan, g, iters, stacked, shared, segs)
        with cuda.on_device(card.device):
            cuda.launch("nt_relax_solve", int(float_mask), PHASES["all"],
                        card.grid, float(penalty), card.dims, card.table,
                        card.stream)
        return 1
    if float_mask:
        raise ValueError("the loop-only solve runs on one card")
    return _shards(mode, plan, g, iters, penalty, stacked, shared, segs)


class CardLaunch(NamedTuple):
    """A card route's launch: its device, stream, table (dims, ptrs),
    co-resident grid, and the scratch buffer and counters it points
    into."""

    device: torch.device
    stream: int
    dims: object
    table: object
    grid: int
    scratch: torch.Tensor
    counters: torch.Tensor


def card_launch(mode, plan, g, iters, stacked, shared, segs) -> CardLaunch:
    """The card route's table over ``segs`` (one card), its scratch
    carved and its counters taken."""
    dev = segs[0].device
    float_mask = mode == "loop"
    given = ("mask", "lin", "denom", "base_frac", "bw_denom",
             "base_bw_frac", "ports_denom", "res_active", "bw_active",
             "ports_active", "act") if float_mask else ()
    with cuda.on_device(dev):
        stream = cuda.stream_ptr(dev)
        buf, asks, cross, at, ptrs = _fill(plan, mode, segs, dev, given)
        cnt = counters(dev, stream, plan.counters)
        base = cnt.data_ptr()
        cross.update(stats_out=at[("stats", -1)], stats_in=at[("stats", -1)],
                     rowmax_out=at[("rowmax", -1)],
                     rowmax_in=at[("rowmax", -1)], ymax_out=at[("ymax", -1)],
                     ymax_in=at[("ymax", -1)], bar=base, cnt=base + 4)
        dims, table = _table(plan, mode, g, iters, stacked, shared, asks,
                             cross, ptrs)
        grid = grid_size(plan, *occupancy(dev, int(float_mask)))
    return CardLaunch(dev, stream, dims, table, grid, buf, cnt)


class _Exchange:
    """Float partial rows of the W shards gathered on the combining
    device, and the combined row sent back. A shard on the combining
    device writes its row of the combining buffer and reads the combined
    row in place; a shard on another card has buffers of its own,
    copied across outside the kernels."""

    def __init__(self, devices, home, part_len: int, out_len: int):
        f32 = torch.float32
        self.home = home
        self.part = torch.empty((len(devices), part_len), dtype=f32,
                                device=home)
        self.out = torch.empty(out_len, dtype=f32, device=home)
        self.local = [
            (self.part[s], self.out) if dev == home else
            (torch.empty(part_len, dtype=f32, device=dev),
             torch.empty(out_len, dtype=f32, device=dev))
            for s, dev in enumerate(devices)]

    def combine(self, count: int, mode: int):
        for s, (part, _out) in enumerate(self.local):
            if part.device != self.home:
                self.part[s].copy_(part, non_blocking=True)
        with cuda.on_device(self.home):
            cuda.launch("nt_relax_combine", len(self.local), count, mode,
                        self.part.data_ptr(), self.out.data_ptr(),
                        cuda.stream_ptr(self.home))
        for _part, out in self.local:
            if out.device != self.home:
                out.copy_(self.out, non_blocking=True)


def _shards(mode, whole, g, iters, penalty, stacked, shared, segs) -> int:
    """The shards route: each shard a launch a phase, on its own plan
    cut from ``whole``; the statistics and maxima combined between."""
    devices = [torch.device(s.device) for s in segs]
    home = devices[0]
    bk = whole.b * whole.k
    w = len(segs)
    stats = _Exchange(devices, home, 2 * bk, 2 * bk)
    maxima = _Exchange(devices, home, bk + whole.b, bk + whole.b)
    runs, keep = [], []
    for s, seg in enumerate(segs):
        dev = devices[s]
        plan = shard_plan(whole, s)
        with cuda.on_device(dev):
            stream = cuda.stream_ptr(dev)
            buf, asks, cross, _at, ptrs = _fill(plan, mode, [seg], dev, ())
            cnt = counters(dev, stream, plan.counters)
            part, out = stats.local[s]
            mpart, mout = maxima.local[s]
            cross.update(stats_out=part.data_ptr(), stats_in=out.data_ptr(),
                         rowmax_out=mpart.data_ptr(),
                         rowmax_in=mout.data_ptr(),
                         ymax_out=mpart.data_ptr() + 4 * bk,
                         ymax_in=mout.data_ptr() + 4 * bk,
                         bar=0, cnt=cnt.data_ptr() + 4)
            keep.append(buf)
            runs.append((dev, stream, plan, _table(
                plan, mode, g, iters, stacked, shared, asks, cross, ptrs)))

    def phase(name):
        for dev, stream, plan, (dims, table) in runs:
            rows = name in ("prologue", "b", "x", "pref")
            with cuda.on_device(dev):
                cuda.launch("nt_relax_solve", 0, PHASES[name],
                            plan.row_tiles if rows else plan.col_tiles,
                            float(penalty), dims, table, stream)

    phase("prologue")
    stats.combine(bk, 0)
    for _ in range(iters):
        phase("a")
        phase("b")
        stats.combine(bk, 0)
    phase("x")
    if mode == "place":
        phase("y")
        maxima.combine(bk + whole.b, 1)
        phase("pref")
    return launches("shards", w, iters, mode)
