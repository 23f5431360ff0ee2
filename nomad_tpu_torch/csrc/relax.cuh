// The convex relaxation's mirror-descent solve (K8a, K9, K10f, K10g-a)
// as one persistent kernel: csrc/convex_relax.cu's entries launch it
// and say what each mode computes. This header is the kernel.
//
// The problem: B evals x K asks (rows) x N nodes (columns), the node
// axis cut into up to NT_RX_SEGS segments, each with its own arrays
// (one segment for K8a / K9; a card's node shards for K10f / K10g-a).
// An iteration of the loop is two reductions that cross each other:
// the softmax of each row runs over the nodes, and the contractions of
// x with the asks (4 resources, bandwidth, ports) run over the rows.
//
// Tiles. A row tile is (eval, 16 rows, one piece of a segment): warp w
// takes row 16 g + w across the piece's nodes, a lane 4 nodes a batch
// (all loaded before any is stored). A column tile is (eval, 128 nodes
// of a segment, one span of the rows): a lane takes one node, four
// warps a row's 128 nodes, and four groups of warps share the span's
// rows; the groups' sums add in group order, and the spans' sums (in
// float64 scratch) in span order by the node tile's last span. No tile
// straddles a segment. The host (ops/relax.py relax_plan) fixes the
// pieces and spans from the shapes alone, so a card's launch and the
// per-shard launches of shards on distinct cards cut the nodes alike.
//
// Phases, one grid barrier between two (one launch runs them all):
//   prologue (row tiles): the node terms (denominators, base fractions)
//     and the asks scaled by activity; per pair the mask and lin and
//     the logits' start; each row's softmax statistics;
//   per iteration:
//     A (column tiles): x = softmax(logits + mask) * act from the row
//       statistics, and per node the six contractions over all K in
//       float64 (a float32 sum over K = 1,024 drifts ~5x farther from
//       a float64 solve, and the relaxation amplifies it), then the
//       node terms of the gradient;
//     B (row tiles): the gradient and the logits step, and the new
//       logits' softmax statistics;
//   epilogue: X (row tiles) x and each row's max of x; Y (column tiles)
//   y = sum_k x in float64 and its max; P (row tiles) pref.
//
// Statistics across tiles. A row tile folds its row over its piece
// (an online max and sum of exp a lane, then a fixed shuffle tree) and
// writes the piece's partial. The last tile of a row group to finish
// (a fence and a counter it resets: atomics on counters only, never on
// values) folds the partials: the pieces of each segment in one fixed
// order into (m_s, s_s), then the segments in shard order, m = max m_s
// and s = sum s_s exp(m_s - m), as parallel/shard.py
// _softmax_over_shards does. A segment's launch of its own (shards on
// distinct cards) ends at (m_s, s_s), and nt_relax_combine folds the
// segments in the same order, so both give the same bits. A row masked
// on every node folds to m = NEG_INF, s = N: x = 1 / N over the whole
// node axis. Every sum has one order: a run gives the same bits twice.
//
// Bound on the card: bytes. An iteration reads logits and the mask (A),
// then logits, lin and the mask and writes logits (B): ~18 B a pair,
// 0.68 ms for 12 iterations at K = 1,024 x N = 10,240. Scratch between
// phases (statistics, node terms, partials) is O(K + N) and stays in
// L2; reads of what another block wrote in this launch bypass L1
// (__ldcg). Per-pair divisions are products by a row's reciprocal: an
// IEEE division takes its slow path on the tiny x of a softmax tail,
// and ran the x and pref phases at a third of the card's rate.
#pragma once

#include "common.cuh"

#define NT_RX_THREADS 512
#define NT_RX_WARPS 16
#define NT_RX_SEGS 8
#define NT_RX_COL 128          // nodes a column tile
#define NT_RX_STRIPS 4         // its 32-node strips
#define NT_RX_GROUPS 4         // warp groups over a column tile's rows
#define NT_RX_SPLITS 8         // spans of rows a column tile, at most
#define NT_RX_STAGE 1024       // node terms staged in shared memory
#define NT_RX_PIECES_MAX 256   // pieces a segment
#define NT_RX_U 4              // a lane's nodes loaded before any store
#define NT_RX_AROWS 8          // rows a column tile's warp loads at once
#define NT_RX_ACHUNK 256       // rows whose terms A stages at a time

// kernels/convex.py constants (convex.py:70-83 in the JAX package).
#define NT_SOLVE_STEP 0.35f
#define NT_OVER_PENALTY 60.0f
#define NT_PACK_REWARD 6.0f

enum { NT_RX_PLACE = 0, NT_RX_DEFRAG = 1, NT_RX_LOOP = 2 };
enum {
  NT_RX_ALL = -1,
  NT_RX_PRO = 0,
  NT_RX_A = 1,
  NT_RX_B = 2,
  NT_RX_X = 3,
  NT_RX_Y = 4,
  NT_RX_P = 5
};

// One node segment: its n nodes cut into `pieces` pieces of `piece`
// nodes (row tiles) and ceil(n / 32) column tiles, numbered from piece0
// and col0 in the launch. Arrays with a leading B carry one row a
// eval; `stacked` static rows and non-`shared` carried rows too.
struct NtRxSeg {
  int n, piece, pieces, piece0, col0;
  // placement / defrag inputs: capacity, sched [N,4] (stacked [B,N,4]),
  // bw_avail [N], node_ok [N]; util [B,N,4] (shared [N,4]), bw_used,
  // ports_free [B,N] (shared [N]); placement only: job_count [B,N],
  // tg_count [B,N,G], feasible [B,N,G].
  const float4* capacity;
  const float4* sched;
  const float* bw_avail;
  const unsigned char* node_ok;
  const float4* util;
  const float* bw_used;
  const float* ports_free;
  const int* job_count;
  const int* tg_count;
  const unsigned char* feasible;
  // [B,K,N]: logits (in / out), x, pref (out); mask (the feasibility
  // bytes the prologue writes, or the caller's float mask), lin.
  float* logits;
  float* x;
  float* pref;
  void* mask;
  float* lin;
  // [B,N]: the node terms (the caller's in the loop-only mode).
  float4* denom;
  float4* base_frac;
  float* bw_denom;
  float* base_bw_frac;
  float* ports_denom;
  float* terms;  // [6,B,N]: t0..t3, cbw, cpo of the current iteration
  float* y;      // [B,N]
};

struct NtRxArgs {
  int mode, phase, B, K, G, iters, stacked, shared, nseg;
  int row_groups, pieces, cols;  // over the launch's segments
  int splits;                    // spans of rows a column tile
  float penalty;
  // [B,K] asks (placement: tg_index, job_dh [B], tg_dh [B,G]; defrag:
  // fresh [K]) and the asks scaled by activity (the caller's in the
  // loop-only mode).
  const float4* ask_res;
  const float* ask_bw;
  const float* ask_ports;
  const int* tg_index;
  const unsigned char* active;
  const unsigned char* job_dh;
  const unsigned char* tg_dh;
  const unsigned char* fresh;
  float4* res_active;
  float* bw_active;
  float* ports_active;
  float* act;
  // Across tiles: piece partials [pieces,B*K] (max, sum); the folded
  // statistics (m, s) [B*K] written (out) and read (in), the same buffer
  // in one launch; rowmax [B*K], the column tiles' y maxima [B,cols],
  // ymax [B].
  float* part_m;
  float* part_s;
  double* npart;  // [splits,B,cols,6,128]: column tiles' span sums
  float2* stats_out;
  const float2* stats_in;
  float* rowmax_out;
  const float* rowmax_in;
  float* ypart;
  float* ymax_out;
  const float* ymax_in;
  unsigned int* bar;  // the grid barrier word (zero, left zero mod 2^31)
  unsigned int* cnt;  // [B*row_groups + B + B*cols] counters, left zero
  NtRxSeg seg[NT_RX_SEGS];
};

// ------------------------------------------------------------- helpers

// s * exp(m - to), 0 for an empty partial (s = 0, m = -inf).
__device__ __forceinline__ float nt_rx_scale(float s, float m, float to) {
  return s == 0.0f ? 0.0f : __fmul_rn(s, expf(__fsub_rn(m, to)));
}

// (m, s) after the first `count` values of v: the online softmax of one
// lane, a batch at a time (its max first, then one sum of exp).
template <int U>
__device__ __forceinline__ void nt_rx_push(float& m, float& s,
                                           const float (&v)[U], int count) {
  float bm = m;
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < count) bm = fmaxf(bm, v[u]);
  float acc = nt_rx_scale(s, m, bm);
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < count) acc = __fadd_rn(acc, expf(__fsub_rn(v[u], bm)));
  s = acc;
  m = bm;
}

// A lane's nodes in the batch from n0: n0, n0 + 32, ... below hi.
__device__ __forceinline__ int nt_rx_count(int n0, int hi) {
  return n0 < hi ? min(NT_RX_U, (hi - n0 + 31) / 32) : 0;
}

// The warp's (m, s) in a fixed xor tree; every lane ends with the same.
__device__ __forceinline__ void nt_rx_warp_stats(float& m, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, m2);
    s = __fadd_rn(nt_rx_scale(s, m, mn), nt_rx_scale(s2, m2, mn));
    m = mn;
  }
}

__device__ __forceinline__ float nt_rx_warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The segments' statistics (m_s, s_s) folded in shard order.
__device__ __forceinline__ float2 nt_rx_cross(float2 acc, float2 seg,
                                              float m) {
  acc.y = __fadd_rn(acc.y, nt_rx_scale(seg.y, seg.x, m));
  return acc;
}

// The mask's raw entry at i (a byte, or the float), loaded apart from
// its use so that a batch's loads are all in flight at once.
template <bool FM>
__device__ __forceinline__ float nt_rx_mask_raw(const void* __restrict__ mask,
                                                size_t i) {
  if (FM) return __ldg((const float*)mask + i);
  return __ldcg((const unsigned char*)mask + i) ? 0.0f : NT_NEG_INF;
}

// l + the mask entry nt_rx_mask_raw loaded: logits + mask.
__device__ __forceinline__ float nt_rx_apply(float l, float raw) {
  return raw == 0.0f ? l : __fadd_rn(l, raw);
}

// Phase A's loads of one batch: rows r0, r0 + 4, ... below rows of a
// column (from index at, rows N apart): the logits and the raw mask.
template <bool FM>
__device__ __forceinline__ void nt_rx_load_rows(
    const float* __restrict__ logits, const void* __restrict__ mask,
    size_t at, int r0, int rows, int N, float (&v)[NT_RX_AROWS],
    float (&mk)[NT_RX_AROWS]) {
#pragma unroll
  for (int r = 0; r < NT_RX_AROWS; ++r) {
    const int rr = r0 + NT_RX_GROUPS * r;
    if (rr < rows) {
      v[r] = __ldcg(logits + at + (size_t)rr * N);
      mk[r] = nt_rx_mask_raw<FM>(mask, at + (size_t)rr * N);
    }
  }
}

// Phase B's loads of one batch (a lane's nodes nn0, nn0 + 32, ... below
// len, from index at): lin, the logits and the raw mask.
template <bool FM>
__device__ __forceinline__ void nt_rx_load_step(
    const float* __restrict__ lin_p, const float* __restrict__ logits,
    const void* __restrict__ mask, size_t at, int nn0, int len,
    float (&lin)[NT_RX_U], float (&lg)[NT_RX_U], float (&mk)[NT_RX_U]) {
#pragma unroll
  for (int u = 0; u < NT_RX_U; ++u) {
    const int nn = nn0 + 32 * u;
    if (nn < len) {
      lin[u] = __ldcg(lin_p + at + nn);
      lg[u] = __ldcg(logits + at + nn);
      mk[u] = nt_rx_mask_raw<FM>(mask, at + nn);
    }
  }
}

// The grid barrier: block 0 adds 2^31 - (grid - 1), the others 1, so
// the word's top bit flips once every block has arrived and its low
// bits come back to zero (cooperative groups' grid sync, on a word of
// the caller's).
__device__ __forceinline__ void nt_rx_grid_sync(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, add);
    while (((old ^ *(volatile unsigned int*)bar) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

// True in every thread of the block that finished the counter's last
// tile (after a fence of each thread's writes); that block resets the
// counter when it is done (nt_rx_release).
__device__ __forceinline__ bool nt_rx_last(unsigned int* c,
                                           unsigned int target) {
  __threadfence();
  __syncthreads();
  const bool last =
      __syncthreads_or(threadIdx.x == 0 && atomicAdd(c, 1u) == target - 1);
  if (last) __threadfence();
  return last;
}

__device__ __forceinline__ void nt_rx_release(unsigned int* c) {
  __syncthreads();
  if (threadIdx.x == 0) *c = 0u;
}

__device__ __forceinline__ int nt_rx_seg_of_piece(const NtRxArgs& p,
                                                  int pc) {
  int s = 0;
  while (s + 1 < p.nseg && pc >= p.seg[s + 1].piece0) ++s;
  return s;
}

__device__ __forceinline__ int nt_rx_seg_of_col(const NtRxArgs& p, int c) {
  int s = 0;
  while (s + 1 < p.nseg && c >= p.seg[s + 1].col0) ++s;
  return s;
}

// Row bk's statistics from its pieces' partials: each segment's in one
// fixed order (lane l its pieces l, l + 32, ... in order, then a fixed
// xor tree over the lanes), then the segments in shard order.
__device__ float2 nt_rx_fold_stats(const NtRxArgs& p, size_t bk, int lane) {
  constexpr int kPer = NT_RX_PIECES_MAX / 32;
  const size_t bkn = (size_t)p.B * p.K;
  float m = -INFINITY;
  for (int j = lane; j < p.pieces; j += 32)
    m = fmaxf(m, __ldcg(p.part_m + (size_t)j * bkn + bk));
  m = nt_rx_warp_max(m);
  float2 acc = make_float2(m, 0.0f);
  for (int s = 0; s < p.nseg; ++s) {
    const NtRxSeg& sg = p.seg[s];
    const size_t at = (size_t)sg.piece0 * bkn + bk;
    float mj[kPer], sj[kPer];
    float ms = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int j = lane + 32 * i;
      mj[i] = j < sg.pieces ? __ldcg(p.part_m + at + (size_t)j * bkn)
                            : -INFINITY;
      sj[i] = j < sg.pieces ? __ldcg(p.part_s + at + (size_t)j * bkn) : 0.0f;
      ms = fmaxf(ms, mj[i]);
    }
    ms = nt_rx_warp_max(ms);
    float ss = 0.0f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      ss = __fadd_rn(ss, nt_rx_scale(sj[i], mj[i], ms));
    for (int off = 16; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    acc = nt_rx_cross(acc, make_float2(ms, ss), m);
  }
  return acc;
}

// Row bk's max over its pieces' partials (order-free).
__device__ float nt_rx_fold_max(const NtRxArgs& p, size_t bk, int lane) {
  const size_t bkn = (size_t)p.B * p.K;
  float m = -INFINITY;
  for (int j = lane; j < p.pieces; j += 32)
    m = fmaxf(m, __ldcg(p.part_m + (size_t)j * bkn + bk));
  return nt_rx_warp_max(m);
}

// ------------------------------------------------------------ row tiles

// A's terms of one row: m, 1 / s, and the scaled asks in float64.
struct NtRxRow {
  double a[6];
  float m, inv;
};

struct NtRxSmem {
  union {
    double red[NT_RX_WARPS][6][32];  // column tiles' warp sums
    float stage[6][NT_RX_STAGE];     // B: the piece's node terms
    NtRxRow rows[NT_RX_ACHUNK];      // A: a chunk of the span's rows
  } u;
  float wmax[NT_RX_WARPS];
};

// Prologue of one pair (placement / defrag): the mask, lin, and the
// logits' start, returned.
__device__ __forceinline__ float nt_rx_pair(const NtRxArgs& p,
                                            const NtRxSeg& sg, int b, int k,
                                            size_t bk, int n, size_t i) {
  const int N = sg.n;
  const size_t sn = (p.stacked ? (size_t)b * N : 0) + n;
  const size_t cn = (p.shared ? 0 : (size_t)b * N) + n;
  const float4 cap = sg.capacity[sn];
  const float4 sc = sg.sched[sn];
  const float4 u = sg.util[cn];
  const float4 a = p.ask_res[bk];
  bool f = sg.node_ok[sn] != 0;
  f = f && a.x <= __fsub_rn(cap.x, u.x) && a.y <= __fsub_rn(cap.y, u.y) &&
      a.z <= __fsub_rn(cap.z, u.z) && a.w <= __fsub_rn(cap.w, u.w);
  f = f && p.ask_bw[bk] <= __fsub_rn(sg.bw_avail[sn], sg.bw_used[cn]);
  f = f && p.ask_ports[bk] <= sg.ports_free[cn];
  int jc = 0;
  if (p.mode == NT_RX_PLACE) {
    const int tg = p.tg_index[bk];
    const size_t ng = ((size_t)b * N + n) * p.G + tg;
    jc = sg.job_count[(size_t)b * N + n];
    f = f && sg.feasible[ng] != 0;
    if (p.job_dh[b]) f = f && jc == 0;
    if (p.tg_dh[(size_t)b * p.G + tg]) f = f && sg.tg_count[ng] == 0;
  } else {
    f = f && cap.x > 0.0f;
  }
  const float d0 = fmaxf(sc.x, 1.0f), d1 = fmaxf(sc.y, 1.0f);
  const float fc = __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(u.x, a.x), d0));
  const float fm = __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(u.y, a.y), d1));
  // 10^x as exp10f, within 2 ulp of powf (the greedy scans keep powf
  // for their bit-equal scores; here lin is held to a tolerance).
  float fit = __fsub_rn(20.0f, __fadd_rn(exp10f(fc), exp10f(fm)));
  fit = fminf(fmaxf(fit, 0.0f), 18.0f);
  if (sc.x <= 0.0f || sc.y <= 0.0f) fit = 0.0f;
  if (p.mode == NT_RX_PLACE)
    fit = __fsub_rn(fit, __fmul_rn(p.penalty, (float)jc));
  const float lin = f ? fit : 0.0f;
  ((unsigned char*)sg.mask)[i] = f ? 1 : 0;
  sg.lin[i] = lin;
  if (p.mode == NT_RX_PLACE || p.fresh[k]) {
    sg.logits[i] = lin;
    return lin;
  }
  return __ldcg(sg.logits + i);
}

// The prologue's per-node terms of eval b on nodes [lo, hi).
__device__ __forceinline__ void nt_rx_node_terms(const NtRxArgs& p,
                                                 const NtRxSeg& sg, int b,
                                                 int lo, int hi) {
  const int N = sg.n;
  for (int n = lo + threadIdx.x; n < hi; n += NT_RX_THREADS) {
    const size_t sn = (p.stacked ? (size_t)b * N : 0) + n;
    const size_t cn = (p.shared ? 0 : (size_t)b * N) + n;
    const size_t bn = (size_t)b * N + n;
    const float4 sc = sg.sched[sn];
    const float4 u = sg.util[cn];
    const float4 d = make_float4(fmaxf(sc.x, 1.0f), fmaxf(sc.y, 1.0f),
                                 fmaxf(sc.z, 1.0f), fmaxf(sc.w, 1.0f));
    sg.denom[bn] = d;
    sg.base_frac[bn] =
        make_float4(__fdiv_rn(u.x, d.x), __fdiv_rn(u.y, d.y),
                    __fdiv_rn(u.z, d.z), __fdiv_rn(u.w, d.w));
    const float bwd = fmaxf(sg.bw_avail[sn], 1.0f);
    sg.bw_denom[bn] = bwd;
    sg.base_bw_frac[bn] = __fdiv_rn(sg.bw_used[cn], bwd);
    sg.ports_denom[bn] = fmaxf(sg.ports_free[cn], 1.0f);
  }
}

// One row tile of phase PH (PRO, B, X or P); see the header.
template <bool FM, int PH>
__device__ void nt_rx_row_tile(const NtRxArgs& p, NtRxSmem& sm, int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pc = t % p.pieces;
  const int rest = t / p.pieces;
  const int rg = rest % p.row_groups, b = rest / p.row_groups;
  // A copy of the segment's row: the loops' stores cannot alias it.
  const NtRxSeg sg = p.seg[nt_rx_seg_of_piece(p, pc)];
  const void* __restrict__ mask = sg.mask;
  float* __restrict__ logits = sg.logits;
  const int N = sg.n;
  const int lo = (pc - sg.piece0) * sg.piece;
  const int hi = min(N, lo + sg.piece);
  const int k = rg * NT_RX_WARPS + warp;
  const bool row = k < p.K;
  const size_t bk = (size_t)b * p.K + (row ? k : 0);
  const size_t bkn = (size_t)p.B * p.K;
  const size_t base = bk * N;
  float m = -INFINITY, s = 0.0f;

  if (PH == NT_RX_PRO) {
    if (p.mode != NT_RX_LOOP) {
      if (rg == 0) nt_rx_node_terms(p, sg, b, lo, hi);
      if (pc == 0 && row && lane == 0) {
        const float a = p.active[bk] ? 1.0f : 0.0f;
        const float4 r = p.ask_res[bk];
        p.res_active[bk] = make_float4(__fmul_rn(r.x, a), __fmul_rn(r.y, a),
                                       __fmul_rn(r.z, a), __fmul_rn(r.w, a));
        p.bw_active[bk] = __fmul_rn(p.ask_bw[bk], a);
        p.ports_active[bk] = __fmul_rn(p.ask_ports[bk], a);
        p.act[bk] = a;
      }
    }
    if (row)
      for (int n0 = lo + lane; n0 < hi; n0 += 32 * NT_RX_U) {
        float l[NT_RX_U];
#pragma unroll
        for (int u = 0; u < NT_RX_U; ++u) {
          const int n = n0 + 32 * u;
          if (n < hi)
            l[u] = p.mode == NT_RX_LOOP
                       ? __ldcg(logits + base + n)
                       : nt_rx_pair(p, sg, b, k, bk, n, base + n);
        }
#pragma unroll
        for (int u = 0; u < NT_RX_U; ++u)
          if (n0 + 32 * u < hi)
            l[u] = nt_rx_apply(
                l[u], nt_rx_mask_raw<FM>(mask, base + n0 + 32 * u));
        nt_rx_push(m, s, l, nt_rx_count(n0, hi));
      }
  } else if (PH == NT_RX_B) {
    float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
    float bw = 0.0f, po = 0.0f;
    if (row) {
      r = __ldcg(p.res_active + bk);
      bw = __ldcg(p.bw_active + bk);
      po = __ldcg(p.ports_active + bk);
    }
    const float two_op = 2.0f * NT_OVER_PENALTY;
    const size_t bN = (size_t)b * N, plane = (size_t)p.B * N;
    const float* __restrict__ lin_p = sg.lin;
    const float* __restrict__ terms = sg.terms;
    for (int c0 = lo; c0 < hi; c0 += NT_RX_STAGE) {
      const int len = min(NT_RX_STAGE, hi - c0);
      const size_t at = base + c0;
      // The first batch's loads are in flight while the terms stage,
      // and each next batch's while the current one computes.
      float lin[NT_RX_U], lg[NT_RX_U], mk[NT_RX_U];
      if (row)
        nt_rx_load_step<FM>(lin_p, logits, mask, at, lane, len, lin, lg, mk);
      for (int q = threadIdx.x; q < 6 * len; q += NT_RX_THREADS) {
        const int w = q / len, nn = q - w * len;
        sm.u.stage[w][nn] = __ldcg(terms + w * plane + bN + c0 + nn);
      }
      __syncthreads();
      if (row)
        for (int nn0 = lane; nn0 < len; nn0 += 32 * NT_RX_U) {
          float lin2[NT_RX_U], lg2[NT_RX_U], mk2[NT_RX_U];
          if (nn0 + 32 * NT_RX_U < len)
            nt_rx_load_step<FM>(lin_p, logits, mask, at, nn0 + 32 * NT_RX_U,
                                len, lin2, lg2, mk2);
          float v[NT_RX_U];
#pragma unroll
          for (int u = 0; u < NT_RX_U; ++u) {
            const int nn = nn0 + 32 * u;
            if (nn >= len) continue;
            const float g = __fsub_rn(
                __fadd_rn(lin[u],
                          __fadd_rn(
                              __fadd_rn(
                                  __fadd_rn(__fmul_rn(sm.u.stage[0][nn], r.x),
                                            __fmul_rn(sm.u.stage[1][nn], r.y)),
                                  __fmul_rn(sm.u.stage[2][nn], r.z)),
                              __fmul_rn(sm.u.stage[3][nn], r.w))),
                __fmul_rn(two_op,
                          __fadd_rn(__fmul_rn(bw, sm.u.stage[4][nn]),
                                    __fmul_rn(po, sm.u.stage[5][nn]))));
            const float l = __fadd_rn(lg[u], __fmul_rn(NT_SOLVE_STEP, g));
            logits[at + nn] = l;
            v[u] = nt_rx_apply(l, mk[u]);
          }
          nt_rx_push(m, s, v, nt_rx_count(nn0, len));
#pragma unroll
          for (int u = 0; u < NT_RX_U; ++u) {
            lin[u] = lin2[u];
            lg[u] = lg2[u];
            mk[u] = mk2[u];
          }
        }
      __syncthreads();
    }
  } else if (PH == NT_RX_X) {
    if (row) {
      const float2 st = __ldcg(p.stats_in + bk);
      const float inv = __frcp_rn(st.y);
      const float a = p.mode == NT_RX_DEFRAG ? __ldcg(p.act + bk) : 1.0f;
      float* __restrict__ x = sg.x;
      for (int n0 = lo + lane; n0 < hi; n0 += 32 * NT_RX_U) {
        float v[NT_RX_U], mk[NT_RX_U];
#pragma unroll
        for (int u = 0; u < NT_RX_U; ++u) {
          const size_t i = base + n0 + 32 * u;
          if (n0 + 32 * u < hi) {
            v[u] = __ldcg(logits + i);
            mk[u] = nt_rx_mask_raw<FM>(mask, i);
          }
        }
#pragma unroll
        for (int u = 0; u < NT_RX_U; ++u) {
          if (n0 + 32 * u >= hi) continue;
          float e = __fmul_rn(
              expf(__fsub_rn(nt_rx_apply(v[u], mk[u]), st.x)), inv);
          if (p.mode == NT_RX_DEFRAG) e = __fmul_rn(e, a);
          x[base + n0 + 32 * u] = e;
          m = fmaxf(m, e);
        }
      }
    }
    if (p.mode == NT_RX_DEFRAG) return;
  } else {  // NT_RX_P
    if (row) {
      const float rm = __frcp_rn(__fadd_rn(__ldcg(p.rowmax_in + bk), 1e-9f));
      const float ym = __frcp_rn(__fadd_rn(__ldcg(p.ymax_in + b), 1e-9f));
      const size_t bN = (size_t)b * N;
      const float* x = sg.x;  // may be pref's own buffer
      const float* __restrict__ y = sg.y;
      float* pref = sg.pref;
      for (int n0 = lo + lane; n0 < hi; n0 += 32 * NT_RX_U) {
        // x may be pref's own buffer: each entry is read before it is
        // written, by the same thread.
        float xv[NT_RX_U], yv[NT_RX_U];
#pragma unroll
        for (int u = 0; u < NT_RX_U; ++u) {
          const int n = n0 + 32 * u;
          if (n < hi) {
            xv[u] = __ldcg(x + base + n);
            yv[u] = __ldcg(y + bN + n);
          }
        }
#pragma unroll
        for (int u = 0; u < NT_RX_U; ++u) {
          const int n = n0 + 32 * u;
          if (n < hi)
            pref[base + n] = __fmul_rn(
                __fadd_rn(__fmul_rn(xv[u], rm), __fmul_rn(yv[u], ym)), 0.5f);
        }
      }
    }
    return;
  }

  // The piece's partial, then the row group's fold by its last tile.
  if (PH == NT_RX_X)
    m = nt_rx_warp_max(m);
  else
    nt_rx_warp_stats(m, s);
  if (row && lane == 0) {
    p.part_m[(size_t)pc * bkn + bk] = m;
    if (PH != NT_RX_X) p.part_s[(size_t)pc * bkn + bk] = s;
  }
  unsigned int* c = p.cnt + (size_t)b * p.row_groups + rg;
  if (!nt_rx_last(c, (unsigned)p.pieces)) return;
  if (row) {
    if (PH == NT_RX_X) {
      const float mx = nt_rx_fold_max(p, bk, lane);
      if (lane == 0) p.rowmax_out[bk] = mx;
    } else {
      const float2 st = nt_rx_fold_stats(p, bk, lane);
      if (lane == 0) p.stats_out[bk] = st;
    }
  }
  nt_rx_release(c);
}

// --------------------------------------------------------- column tiles

// One column tile of phase A (x and the node terms) or Y (y): 128
// nodes of a segment (4 strips of 32, a lane a node) over one of the
// launch's `splits` spans of rows (4 groups of warps, warp group g
// taking rows g, g + 4, ... of the span). Four warps read 512
// contiguous bytes of a row. The strips' warps add the groups' sums in
// group order; with several spans, the last span's tile of the node
// tile adds the spans' sums in span order (all in float64).
template <bool FM, int PH>
__device__ void nt_rx_col_tile(const NtRxArgs& p, NtRxSmem& sm, int t) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip = warp % NT_RX_STRIPS, grp = warp / NT_RX_STRIPS;
  const int split = t % p.splits;
  const int rest = t / p.splits;
  const int c = rest % p.cols, b = rest / p.cols;
  const NtRxSeg sg = p.seg[nt_rx_seg_of_col(p, c)];
  const void* __restrict__ mask = sg.mask;
  const float* __restrict__ logits = sg.logits;
  const float* __restrict__ x_p = sg.x;
  const int N = sg.n;
  const int pos = strip * 32 + lane;
  const int n = (c - sg.col0) * NT_RX_COL + pos;
  const bool valid = n < N;
  const size_t bN = (size_t)b * N;
  // The node terms' inputs, loaded while the rows are read.
  float4 nd = make_float4(1.f, 1.f, 1.f, 1.f), nf = nd;
  float nbwd = 1.f, nbbf = 0.f, npd = 1.f;
  if (PH == NT_RX_A && grp == 0 && valid) {
    const size_t bn = bN + n;
    nd = __ldcg(sg.denom + bn);
    nf = __ldcg(sg.base_frac + bn);
    nbwd = __ldcg(sg.bw_denom + bn);
    nbbf = __ldcg(sg.base_bw_frac + bn);
    npd = __ldcg(sg.ports_denom + bn);
  }
  const int span = (p.K + p.splits - 1) / p.splits;
  const int k_hi = min(p.K, (split + 1) * span);
  const int first = split * span + grp;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  if (PH == NT_RX_A) {
    // The span's row terms staged in shared memory a chunk of rows at a
    // time: m, 1 / s, and the scaled asks as float64 (act is in them:
    // an inactive row's asks are 0).
    for (int k0 = split * span; k0 < k_hi; k0 += NT_RX_ACHUNK) {
      const int k1 = min(k_hi, k0 + NT_RX_ACHUNK);
      // The chunk's first batch of logits and mask in flight while its
      // rows stage; each later batch loaded before any of it is used.
      float v[NT_RX_AROWS], mk[NT_RX_AROWS];
      if (valid)
        nt_rx_load_rows<FM>(logits, mask, ((size_t)b * p.K + k0) * N + n,
                            grp, k1 - k0, N, v, mk);
      __syncthreads();  // the previous chunk (or tile) is read
      for (int r = threadIdx.x; r < k1 - k0; r += NT_RX_THREADS) {
        const size_t bk = (size_t)b * p.K + k0 + r;
        const float2 st = __ldcg(p.stats_in + bk);
        const float4 ra = __ldcg(p.res_active + bk);
        sm.u.rows[r].m = st.x;
        sm.u.rows[r].inv = __frcp_rn(st.y);
        sm.u.rows[r].a[0] = ra.x;
        sm.u.rows[r].a[1] = ra.y;
        sm.u.rows[r].a[2] = ra.z;
        sm.u.rows[r].a[3] = ra.w;
        sm.u.rows[r].a[4] = __ldcg(p.bw_active + bk);
        sm.u.rows[r].a[5] = __ldcg(p.ports_active + bk);
      }
      __syncthreads();
      if (!valid) continue;
      for (int r0 = grp; r0 < k1 - k0; r0 += NT_RX_GROUPS * NT_RX_AROWS) {
        if (r0 != grp)
          nt_rx_load_rows<FM>(logits, mask, ((size_t)b * p.K + k0) * N + n,
                              r0, k1 - k0, N, v, mk);
#pragma unroll
        for (int r = 0; r < NT_RX_AROWS; ++r) {
          const int rr = r0 + NT_RX_GROUPS * r;
          if (rr >= k1 - k0) break;
          const NtRxRow& t = sm.u.rows[rr];
          const double xd = __fmul_rn(
              expf(__fsub_rn(nt_rx_apply(v[r], mk[r]), t.m)), t.inv);
#pragma unroll
          for (int j = 0; j < 6; ++j) acc[j] = fma(xd, t.a[j], acc[j]);
        }
      }
    }
  } else if (valid) {
#pragma unroll 4
    for (int k = first; k < k_hi; k += NT_RX_GROUPS)
      acc[0] += (double)__ldcg(x_p + ((size_t)b * p.K + k) * N + n);
  }
  constexpr int q = PH == NT_RX_A ? 6 : 1;
  if (PH == NT_RX_A) __syncthreads();  // the staged rows are read
#pragma unroll
  for (int j = 0; j < q; ++j) sm.u.red[warp][j][lane] = acc[j];
  __syncthreads();
  double a[6];
  if (grp == 0) {
#pragma unroll
    for (int j = 0; j < q; ++j) {
      a[j] = sm.u.red[strip][j][lane];
      for (int g = 1; g < NT_RX_GROUPS; ++g)
        a[j] += sm.u.red[strip + NT_RX_STRIPS * g][j][lane];
    }
  }
  unsigned int* cn = p.cnt + (size_t)p.B * (p.row_groups + 1) +
                     (size_t)b * p.cols + c;
  if (p.splits > 1) {
    // The span's sums, then the node tile's last span adds them all.
    const size_t at = (size_t)b * p.cols + c;
    const size_t step = (size_t)p.B * p.cols * 6 * NT_RX_COL;
    double* part = p.npart + at * 6 * NT_RX_COL;
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < q; ++j)
        part[split * step + j * NT_RX_COL + pos] = a[j];
    }
    if (!nt_rx_last(cn, (unsigned)p.splits)) return;
    if (grp == 0) {
#pragma unroll
      for (int j = 0; j < q; ++j) {
        a[j] = __ldcg(part + j * NT_RX_COL + pos);
        for (int sp = 1; sp < p.splits; ++sp)
          a[j] += __ldcg(part + sp * step + j * NT_RX_COL + pos);
      }
    }
  }
  if (PH == NT_RX_A) {
    if (grp == 0 && valid) {
      const size_t bn = bN + n, plane = (size_t)p.B * N;
      const float4 d = nd, f = nf;
      const float e0 = __fadd_rn(f.x, __fdiv_rn((float)a[0], d.x));
      const float e1 = __fadd_rn(f.y, __fdiv_rn((float)a[1], d.y));
      const float e2 = __fadd_rn(f.z, __fdiv_rn((float)a[2], d.z));
      const float e3 = __fadd_rn(f.w, __fdiv_rn((float)a[3], d.w));
      const float tot = __fdiv_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(e0, e1), e2), e3), 4.0f);
      const float pack = __fmul_rn(NT_PACK_REWARD / 4.0f, tot);
      const float two_op = 2.0f * NT_OVER_PENALTY;
      const float t0 = __fdiv_rn(
          __fsub_rn(pack, __fmul_rn(two_op, fmaxf(__fsub_rn(e0, 1.f), 0.f))),
          d.x);
      const float t1 = __fdiv_rn(
          __fsub_rn(pack, __fmul_rn(two_op, fmaxf(__fsub_rn(e1, 1.f), 0.f))),
          d.y);
      const float t2 = __fdiv_rn(
          __fsub_rn(pack, __fmul_rn(two_op, fmaxf(__fsub_rn(e2, 1.f), 0.f))),
          d.z);
      const float t3 = __fdiv_rn(
          __fsub_rn(pack, __fmul_rn(two_op, fmaxf(__fsub_rn(e3, 1.f), 0.f))),
          d.w);
      const float bwd = nbwd;
      const float obw = fmaxf(
          __fsub_rn(__fadd_rn(nbbf, __fdiv_rn((float)a[4], bwd)), 1.0f),
          0.0f);
      const float pd = npd;
      const float opo =
          fmaxf(__fsub_rn(__fdiv_rn((float)a[5], pd), 1.0f), 0.0f);
      float* tm = sg.terms + bn;
      tm[0] = t0;
      tm[plane] = t1;
      tm[2 * plane] = t2;
      tm[3 * plane] = t3;
      tm[4 * plane] = __fdiv_rn(obw, bwd);
      tm[5 * plane] = __fdiv_rn(opo, pd);
    }
  } else {
    // y, and the node tile's max of y.
    float mx = -INFINITY;
    if (grp == 0) {
      const float y = (float)a[0];
      if (valid) sg.y[bN + n] = y;
      mx = nt_rx_warp_max(valid ? y : -INFINITY);
      if (lane == 0) sm.wmax[strip] = mx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = sm.wmax[0];
      for (int w = 1; w < NT_RX_STRIPS; ++w) v = fmaxf(v, sm.wmax[w]);
      p.ypart[(size_t)b * p.cols + c] = v;
    }
  }
  if (p.splits > 1) nt_rx_release(cn);
  if (PH == NT_RX_A) {
    __syncthreads();  // the shared sums are read before the next tile
    return;
  }
  // The eval's y maximum, by its last column tile.
  unsigned int* cb = p.cnt + (size_t)p.B * p.row_groups + b;
  if (!nt_rx_last(cb, (unsigned)p.cols)) return;
  float mx = -INFINITY;
  for (int j = threadIdx.x; j < p.cols; j += NT_RX_THREADS)
    mx = fmaxf(mx, __ldcg(p.ypart + (size_t)b * p.cols + j));
  mx = nt_rx_warp_max(mx);
  if (lane == 0) sm.wmax[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float v = sm.wmax[0];
    for (int w = 1; w < NT_RX_WARPS; ++w) v = fmaxf(v, sm.wmax[w]);
    p.ymax_out[b] = v;
  }
  nt_rx_release(cb);
}

// ------------------------------------------------------------- kernel

template <bool FM, int PH>
__device__ __forceinline__ void nt_rx_rows(const NtRxArgs& p, NtRxSmem& sm) {
  const int n = p.B * p.row_groups * p.pieces;
  for (int t = blockIdx.x; t < n; t += gridDim.x)
    nt_rx_row_tile<FM, PH>(p, sm, t);
}

template <bool FM, int PH>
__device__ __forceinline__ void nt_rx_cols(const NtRxArgs& p, NtRxSmem& sm) {
  const int n = p.B * p.cols * p.splits;
  for (int t = blockIdx.x; t < n; t += gridDim.x)
    nt_rx_col_tile<FM, PH>(p, sm, t);
}

// phase NT_RX_ALL: the whole solve, a cooperative launch (every block
// resident: the grid barrier waits for all of them). Otherwise one
// phase, an ordinary launch (a shard's launch on its own card).
template <bool FM>
__global__ void __launch_bounds__(NT_RX_THREADS, 2)
    nt_relax_kernel(const __grid_constant__ NtRxArgs p) {
  __shared__ NtRxSmem sm;
  const int ph = p.phase;
  const bool all = ph == NT_RX_ALL;
  if (all || ph == NT_RX_PRO) nt_rx_rows<FM, NT_RX_PRO>(p, sm);
  if (all) {
    nt_rx_grid_sync(p.bar);
    for (int it = 0; it < p.iters; ++it) {
      nt_rx_cols<FM, NT_RX_A>(p, sm);
      nt_rx_grid_sync(p.bar);
      nt_rx_rows<FM, NT_RX_B>(p, sm);
      nt_rx_grid_sync(p.bar);
    }
    if (p.mode == NT_RX_LOOP) return;
  } else if (ph == NT_RX_A) {
    nt_rx_cols<FM, NT_RX_A>(p, sm);
  } else if (ph == NT_RX_B) {
    nt_rx_rows<FM, NT_RX_B>(p, sm);
  }
  if (all || ph == NT_RX_X) nt_rx_rows<FM, NT_RX_X>(p, sm);
  if (all) {
    if (p.mode != NT_RX_PLACE) return;
    nt_rx_grid_sync(p.bar);
  }
  if (all || ph == NT_RX_Y) nt_rx_cols<FM, NT_RX_Y>(p, sm);
  if (all) nt_rx_grid_sync(p.bar);
  if (all || ph == NT_RX_P) nt_rx_rows<FM, NT_RX_P>(p, sm);
}

// The segments' statistics [W, count] (m_s, s_s) folded in shard order
// into [count] (mode 0), or their maxima [W, count] into [count] (mode
// 1): a card's launch ends there (nt_rx_fold_stats), shards on distinct
// cards here.
__global__ void nt_relax_combine_kernel(int W, int count, int mode,
                                        const float* __restrict__ part,
                                        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  if (mode == 0) {
    const float2* seg = (const float2*)part;
    float m = seg[i].x;
    for (int s = 1; s < W; ++s) m = fmaxf(m, seg[(size_t)s * count + i].x);
    float2 acc = make_float2(m, 0.0f);
    for (int s = 0; s < W; ++s)
      acc = nt_rx_cross(acc, seg[(size_t)s * count + i], m);
    ((float2*)out)[i] = acc;
  } else {
    float m = part[i];
    for (int s = 1; s < W; ++s) m = fmaxf(m, part[(size_t)s * count + i]);
    out[i] = m;
  }
}
