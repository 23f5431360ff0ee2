// K7: all-K gang placement of one gang over the node-topology tensor
// (ops/gang.py _member_units, _group_capacity and
// gang_placement_program, in the JAX package).
//
// Bound on the card: the chain of K dependent argmaxes over N nodes, as
// K1's; the units pass and the group sums run once a launch. Design:
// K1's cluster scan (csrc/cluster.cuh). One gang, one thread-block
// cluster of up to 16 CTAs: CTA r owns nodes [r N / c, (r+1) N / c),
// and thread t of it owns nodes t, t + T, ... for the whole launch.
// Resident form: each CTA keeps its slice's rows (capacity, sched,
// util, bw_avail, bw_used, ports_free, feas_row, job_count,
// dh_presence, topo_ids, placed: 77 bytes a node) in shared memory,
// loaded by bulk copies and written back by the owners at the end;
// streamed where they do not fit (ops/scan.py gang_plan). Four phases:
//
// 1. Group capacity (slice and spread modes; free and affinity read
//    none). Each CTA computes its slice's member units (csrc/gang.cuh
//    nt_member_units) and adds each whole one to its group's sum by an
//    atomic on rank 0's copy of the sums (distributed shared memory, or
//    the group_cap scratch past the budget): whole numbers >= 0 sum
//    exactly in any order while every sum stays under 2^24, so the sums
//    are then the plain index_add_'s bits. Rank 0 checks that afterwards
//    (no fraction anywhere, every sum under 2^24: rounding is monotone,
//    so an inexact partial shows in its total); otherwise (the 1e9
//    units of a zero ask) its warp 0 sums the units again in node order
//    (the CTAs left them in the units scratch): 32 nodes a step,
//    __match_any_sync gathering the lanes of a group, whose lowest lane
//    folds them in lane order, as K10b's ordered walk
//    (csrc/group_capacity.cu).
// 2. Slice mode: rank 0 takes the tightest covering group, the argmax
//    of -capacity + group noise over the groups whose capacity covers
//    the active members (lowest id on ties); with none, the sentinel
//    g_pad + 1 matches no node. Spread mode: the cap ceil(k_actual /
//    max(groups with capacity >= 1, 1)). Every CTA reads rank 0's match
//    and cap from its shared memory after a cluster barrier.
// 3. The K member steps, one key exchange a step (nt_cluster_argmax).
//    A gang's members are one ask, so each node's fit - penalty x
//    (job_count + placed), with the parts of its mask that change only
//    when the node takes a member (the ask's fit, the feasibility row,
//    the slice match, distinct_hosts), is kept in shared memory and
//    recomputed only for the node its owner updated last; a step adds
//    only the group-dependent terms (the spread cap's test, affinity's
//    5 a member already in the node's group) and the member's noise
//    (K0's [K, N] tensor, each row's slice staged ahead by a bulk copy)
//    — the plain version's operations on the same values. The owner of
//    the winner updates its rows and placed[] and writes the choice and
//    score (score - noise); rank 0 writes a step with no winner. Each
//    CTA keeps its own copy of the group member counts (shared memory,
//    or its row of the members scratch past the budget) and adds the
//    winner's +1 to it itself (topo_ids is static: one thread reads the
//    winner's id), so no step waits on another CTA's write; in spread
//    and affinity mode, where a step reads the counts, a block barrier
//    follows the add. Free and slice mode keep rank 0's copy only.
// 4. All-K, after a cluster barrier: unless every active member was
//    placed, rank 0 rewrites every choice to -1 and every score to 0,
//    and slice_group to -1 (else the chosen group); it writes its copy
//    of the member counts to group_members.
//
// Segments (SEG; K10e on the shards of one card, parallel/shard.py):
// the node axis as W segments, each a shard's own rows, noise window,
// ``placed`` and copy of the member counts, from global row ``lo``. CTA
// r takes part r mod cps of segment r / cps; the keys and the units
// scratch use global indices, the winner's topology id is read through
// its segment. The counts load from segment 0's copy, and rank 0
// writes them back to every segment's, as the plain version updates
// every shard's replica. The ordered walk sums each segment's units in
// node order into a partial (the ``walk`` scratch), and folds the
// partials in segment order: K10b's order (each shard's partial in node
// order, the partials in shard order). K7 is the one-segment case (SEG
// false), whose walk covers the whole axis as before.
//
// Every + - * / is a round-to-nearest intrinsic (csrc/common.cuh), so
// choices, the slice group and the carry equal the plain version's and
// K10e's (csrc/sharded_gang.cu) bit for bit.
#include "cluster.cuh"
#include "gang.cuh"

// The mbarriers at the start of shared memory: the resident rows, the
// noise stages, the keys (by step parity).
enum { NT_G_ROWS = 0, NT_G_NOISE = 1, NT_G_KEYS = 1 + NT_SCAN_STAGES,
       NT_G_COUNT = NT_G_KEYS + 2 };

// Resident rows.
enum { NT_GR_CAP, NT_GR_SCHED, NT_GR_UTIL, NT_GR_BWA, NT_GR_BWU,
       NT_GR_PORTS, NT_GR_FEAS, NT_GR_JC, NT_GR_DHP, NT_GR_TOPO,
       NT_GR_PLACED, NT_GR_ROWS };

// Rank 0's control words: the slice match, the spread cap's bits, the
// chosen group, and a flag some CTA sets when a unit is not whole.
enum { NT_C_MATCH, NT_C_CAP, NT_C_CHOSEN, NT_C_FRACT, NT_C_WORDS };

// Byte offsets in a CTA's dynamic shared memory (ops/scan.py
// gang_layout): the mbarriers, the profile's counters and the control
// words, the keys' slots by step parity, the score cache, the noise
// stages, the resident rows, then the group member counts and (slice
// and spread mode: ``capg``) rank 0's group capacities, where ``groups``.
struct NtGangLayout {
  size_t ctl, slots, cache, noise[NT_SCAN_STAGES], rows[NT_GR_ROWS],
      members, gcap, total;
};

__host__ __device__ inline NtGangLayout nt_gang_layout(
    int nc, int warps, int L, int g_pad, int resident, int stage_noise,
    int cache, int groups, int capg) {
  NtGangLayout o = {};
  size_t at = 8 * NT_G_COUNT + 8 * NT_P_PARTS;
  o.ctl = at;
  at = nt_r16(at + 4 * NT_C_WORDS);
  o.slots = at;  // CTA keys [2][nc], then warp keys [2][warps]
  at += nt_r16((size_t)16 * (nc + warps));
  o.cache = at;
  if (cache) at += nt_r16((size_t)4 * L);
  if (stage_noise)
    for (int x = 0; x < NT_SCAN_STAGES; ++x) {
      o.noise[x] = at;
      at += nt_stage_len((size_t)4 * L);
    }
  if (resident) {
    const size_t per[NT_GR_ROWS] = {16, 16, 16, 4, 4, 4, 1, 4, 4, 4, 4};
    for (int r = 0; r < NT_GR_ROWS; ++r) {
      o.rows[r] = at;
      at += nt_stage_len(per[r] * L);
    }
  }
  if (groups) {
    o.members = at;
    at += nt_r16((size_t)4 * g_pad);
    if (capg) {
      o.gcap = at;
      at += nt_r16((size_t)4 * g_pad);
    }
  }
  o.total = at;
  return o;
}

// One segment of the node axis: a shard's n rows of the GangState from
// global row lo (the whole axis for K7), its noise window [K,n], its
// ``placed`` [n] and its copy of the member counts [g_pad].
struct NtGangSeg {
  long long lo, n;
  const float4* capacity;
  const float4* sched;
  float4* util;
  const float* bw_avail;
  float* bw_used;
  float* ports_free;
  const unsigned char* feas_row;
  const int* job_count;
  const int* dh_presence;
  const int* topo_ids;
  const float* noise;
  int* placed;
  float* group_members;
};
#define NT_GANG_SEG_PTRS 13

// K7's arguments (its one segment: the rows at capacity .. topo_ids,
// noise, placed, group_members, N of them), then the segment table of
// K10e's launches (W segments of cps CTAs; those row fields unused).
// K7 reads its rows from these fields, as before the table (its forms
// then compile to the same registers and spills: PERF.md §6).
struct NtGangArgs {
  int N, K, g_pad, mode, dh, L, stage_noise, cache, groups;
  float penalty;
  const float4* capacity;
  const float4* sched;
  float4* util;
  const float* bw_avail;
  float* bw_used;
  float* ports_free;
  const unsigned char* feas_row;
  const int* job_count;
  const int* dh_presence;
  const int* topo_ids;
  const float4* ask_res;
  const float* ask_bw;
  const float* ask_ports;
  const unsigned char* active;
  const float* noise;
  const float* group_noise;
  int* placed;
  float* group_members;
  int* choices;
  float* scores;
  int* slice_group;
  float* group_cap;     // [g_pad]: the sums past the budget
  float* members_rows;  // [ctas, g_pad]: CTA r's counts past the budget
  float* units;         // [N]: the member units, for the ordered walk
  long long* prof;
  int W, cps;
  float* walk;          // [g_pad]: a segment's partial (SEG, W > 1)
  NtGangSeg seg[NT_SCAN_CLUSTER_MAX];
};

// K7's one segment, from its fields.
__device__ __forceinline__ NtGangSeg nt_gang_one(const NtGangArgs& p) {
  return NtGangSeg{0,          p.N,         p.capacity,    p.sched,
                   p.util,     p.bw_avail,  p.bw_used,     p.ports_free,
                   p.feas_row, p.job_count, p.dh_presence, p.topo_ids,
                   p.noise,    p.placed,    p.group_members};
}

// The group sums again in node order, by one warp (K10b's ordered walk
// over the whole node axis): ``sums`` zeroed; units and ids in global
// memory, written by the cluster's CTAs before a cluster barrier.
__device__ __forceinline__ void nt_gang_walk(int N, int g_pad,
                                             const float* units,
                                             const int* ids, float* sums,
                                             bool global) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < N; b += 32) {
    const int i = b + lane;
    const int id = i < N ? ids[i] : -1;
    const float u = i < N ? __ldcg(units + i) : 0.0f;
    const bool valid = id >= 0 && id < g_pad && u != 0.0f;
    const unsigned mask = __match_any_sync(full, valid ? id : -1 - lane);
    const bool lead = valid && lane == __ffs(mask) - 1;
    float acc = lead ? (global ? __ldcg(sums + id) : sums[id]) : 0.0f;
    if (__any_sync(full, valid && (mask & (mask - 1)))) {
      // Some group has several lanes: fold them in lane order.
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const float v = __shfl_sync(full, u, k);
        if ((mask >> k) & 1u) acc = __fadd_rn(acc, v);
      }
    } else {
      acc = __fadd_rn(acc, u);
    }
    if (lead) sums[id] = acc;
    __syncwarp();
  }
}

// RES: the resident form, else streamed; TIMED: the step parts are
// timed into p.prof; SEG: the CTAs over p.W segments, p.cps a segment
// (else segment 0 over the whole cluster).
template <bool RES, bool TIMED, bool SEG>
__global__ void __launch_bounds__(NT_SCAN_THREADS, 1)
    nt_gang_cluster_kernel(const __grid_constant__ NtGangArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = (uint64_t*)smem;
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int T = blockDim.x, W = T >> 5;
  const int t = threadIdx.x;
  const int K = p.K, g_pad = p.g_pad, mode = p.mode;
  const bool dhb = p.dh != 0;
  const bool capg = mode == NT_GANG_SLICE || mode == NT_GANG_SPREAD;
  // A step reads the group member counts (every CTA keeps its copy).
  const bool counts = mode == NT_GANG_SPREAD || mode == NT_GANG_AFFINITY;
  const NtGangLayout lay = nt_gang_layout(nc, W, p.L, g_pad, RES,
                                          p.stage_noise, p.cache, p.groups,
                                          capg);
  const NtExchange x =
      nt_exchange(smem, lay.slots, bar + NT_G_KEYS, nc, rank, W);
  // This CTA's slice: part ``pj`` of segment ``si`` (a part may be
  // empty; its CTA still meets every barrier), local rows [lo, lo +
  // cnt), global rows from ``glo``.
  const int cps = SEG ? p.cps : nc;
  const int si = SEG ? rank / cps : 0;
  const int pj = rank - si * cps;
  // SEG: the segment's row from shared memory, read where it is used
  // (its pointers held in registers across the steps spill).
  NtGangSeg one = {};
  const NtGangSeg* row = &one;
  if constexpr (SEG) {
    __shared__ NtGangSeg seg_row;
    if (t == 0) seg_row = p.seg[si];
    __syncthreads();
    row = &seg_row;
  } else {
    one = nt_gang_one(p);
  }
  const NtGangSeg& sg = *row;
  const int n_s = (int)sg.n;
  const int lo = (int)((long long)pj * n_s / cps);
  const int cnt = (int)((long long)(pj + 1) * n_s / cps) - lo;
  const int glo = SEG ? (int)sg.lo + lo : lo;  // one segment: at 0
  int* ctl = (int*)(smem + lay.ctl);
  float* cache = (float*)(smem + lay.cache);
  float* members = p.groups ? (float*)(smem + lay.members)
                            : p.members_rows + (size_t)rank * g_pad;
  long long* prof_acc = (long long*)(smem + 8 * NT_G_COUNT);
  NtClock<TIMED> clock = {rank == 0 && t == (T > 32 ? 32 : 0), 0, prof_acc};
  if (TIMED && clock.on) {
    for (int i = 0; i < NT_P_PARTS; ++i) prof_acc[i] = 0;
    clock.clk = clock64();
  }

  // The slice's rows in global memory.
  const float4* gcap = sg.capacity + lo;
  const float4* gsched = sg.sched + lo;
  float4* gutil = sg.util + lo;
  const float* gbwa = sg.bw_avail + lo;
  float* gbwu = sg.bw_used + lo;
  float* gports = sg.ports_free + lo;
  const unsigned char* gfeas = sg.feas_row + lo;
  const int* gjc = sg.job_count + lo;
  const int* gdhp = sg.dh_presence + lo;
  const int* gtopo = sg.topo_ids + lo;
  int* gplaced = sg.placed + lo;
  auto gnoise = [&](int k) { return sg.noise + (size_t)k * n_s + lo; };
  auto issue_noise = [&](int k) {
    const float* src = gnoise(k);
    uint64_t* b = &bar[NT_G_NOISE + k % NT_SCAN_STAGES];
    nt_expect_bulk(b, nt_superset(src, (size_t)4 * cnt));
    nt_bulk(smem + lay.noise[k % NT_SCAN_STAGES], src, (size_t)4 * cnt, b);
  };

  // This CTA's copy of the member counts (carried in; segment 0's).
  const float* members0 = SEG ? p.seg[0].group_members : p.group_members;
  if (counts || rank == 0)
    for (int g = t; g < g_pad; g += T) members[g] = members0[g];
  if (t == 0) {
    for (int i = 0; i < NT_G_COUNT; ++i) nt_mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 && i < K; ++i) nt_expect_keys(x, i);
    ctl[NT_C_MATCH] = -1;
    ctl[NT_C_CAP] = __float_as_int((float)K);
    ctl[NT_C_CHOSEN] = -1;
    ctl[NT_C_FRACT] = 0;
  }
  // Every CTA of the cluster has started and sees its mbarriers
  // initialised, its counts loaded and rank 0's control words set.
  nt_cluster_arrive_wait();
  if (t == 0) {
    if (RES) {
      const void* src[NT_GR_ROWS] = {gcap, gsched, gutil, gbwa, gbwu, gports,
                                     gfeas, gjc, gdhp, gtopo, gplaced};
      const size_t per[NT_GR_ROWS] = {16, 16, 16, 4, 4, 4, 1, 4, 4, 4, 4};
      unsigned tx = 0;
      for (int r = 0; r < NT_GR_ROWS; ++r)
        tx += nt_superset(src[r], per[r] * cnt);
      nt_expect_bulk(&bar[NT_G_ROWS], tx);
      for (int r = 0; r < NT_GR_ROWS; ++r)
        nt_bulk(smem + lay.rows[r], src[r], per[r] * cnt, &bar[NT_G_ROWS]);
    }
    if (p.stage_noise)
      for (int i = 0; i < NT_SCAN_STAGES && i < K; ++i) issue_noise(i);
  }
  if (RES) nt_mbar_wait(&bar[NT_G_ROWS], 0);
  // The rows this thread reads: shared memory (resident) or global.
  const float4* cap =
      RES ? nt_staged(smem + lay.rows[NT_GR_CAP], gcap) : gcap;
  const float4* sched =
      RES ? nt_staged(smem + lay.rows[NT_GR_SCHED], gsched) : gsched;
  float4* util = RES ? nt_staged(smem + lay.rows[NT_GR_UTIL], gutil) : gutil;
  const float* bwa = RES ? nt_staged(smem + lay.rows[NT_GR_BWA], gbwa) : gbwa;
  float* bwu = RES ? nt_staged(smem + lay.rows[NT_GR_BWU], gbwu) : gbwu;
  float* ports =
      RES ? nt_staged(smem + lay.rows[NT_GR_PORTS], gports) : gports;
  const unsigned char* feas =
      RES ? nt_staged(smem + lay.rows[NT_GR_FEAS], gfeas) : gfeas;
  const int* jc = RES ? nt_staged(smem + lay.rows[NT_GR_JC], gjc) : gjc;
  const int* dhp = RES ? nt_staged(smem + lay.rows[NT_GR_DHP], gdhp) : gdhp;
  const int* topo =
      RES ? nt_staged(smem + lay.rows[NT_GR_TOPO], gtopo) : gtopo;
  int* placed =
      RES ? nt_staged(smem + lay.rows[NT_GR_PLACED], gplaced) : gplaced;
  const float4 a = p.ask_res[0];
  const float abw = p.ask_bw[0];
  const float aports = p.ask_ports[0];

  // ---- 1-2. group capacity; slice choice or spread cap (rank 0)
  if (capg) {
    float* capv = p.groups ? cl.map_shared_rank((float*)(smem + lay.gcap), 0)
                           : p.group_cap;
    if (rank == 0)
      for (int g = t; g < g_pad; g += T) capv[g] = 0.0f;
    nt_cluster_arrive_wait();  // the sums are zero before any CTA adds
    bool fract = false;
    for (int i = t; i < cnt; i += T) {
      const float u = nt_member_units(i, mode, dhb, cap, util, bwa, bwu,
                                      ports, feas, dhp, topo, a, abw, aports);
      p.units[glo + i] = u;
      const int id = topo[i];
      if (id < 0 || id >= g_pad || u == 0.0f) continue;
      if (u >= 0.0f && u == truncf(u))
        atomicAdd(capv + id, u);
      else
        fract = true;
    }
    if (__syncthreads_or(fract) && t == 0)
      atomicOr(cl.map_shared_rank(ctl + NT_C_FRACT, 0), 1);
    nt_cluster_arrive_wait();  // every CTA's adds and units are in
    if (rank == 0) {
      auto sum = [&](int g) {
        return p.groups ? capv[g] : __ldcg(capv + g);
      };
      bool past = ctl[NT_C_FRACT] != 0;
      for (int g = t; g < g_pad; g += T) past = past || !(sum(g) < 16777216.0f);
      if (__syncthreads_or(past)) {
        for (int g = t; g < g_pad; g += T) capv[g] = 0.0f;
        __syncthreads();
        if (!SEG || p.W == 1) {
          if (t < 32)  // rank 0's segment is segment 0
            nt_gang_walk(n_s, g_pad, p.units, sg.topo_ids, capv, !p.groups);
          __syncthreads();
        } else {
          // Each segment's partial in node order, then added in segment
          // order.
          for (int s = 0; s < p.W; ++s) {
            for (int g = t; g < g_pad; g += T) p.walk[g] = 0.0f;
            __syncthreads();
            if (t < 32)
              nt_gang_walk((int)p.seg[s].n, g_pad, p.units + p.seg[s].lo,
                           p.seg[s].topo_ids, p.walk, true);
            __syncthreads();
            for (int g = t; g < g_pad; g += T)
              capv[g] = __fadd_rn(sum(g), __ldcg(p.walk + g));
            __syncthreads();
          }
        }
      }
      int active = 0;  // k_actual: the active members, an exact count
      for (int b = 0; b < K; b += T)
        active += __syncthreads_count(b + t < K && p.active[b + t] != 0);
      const float k_actual = (float)active;
      if (mode == NT_GANG_SLICE) {
        unsigned long long best = 0ull;
        for (int g = t; g < g_pad; g += T) {
          const float c = sum(g);
          const float s =
              c >= k_actual ? __fadd_rn(-c, p.group_noise[g]) : NT_NEG_INF;
          const unsigned long long key = nt_pack(s, g);
          best = key > best ? key : best;
        }
        best = nt_block_max(best, x.wkeys);
        if (t == 0) {
          const int chosen =
              nt_unpack_score(best) > NT_NEG_INF / 2 ? nt_unpack_index(best)
                                                     : -1;
          ctl[NT_C_CHOSEN] = chosen;
          ctl[NT_C_MATCH] = chosen >= 0 ? chosen : g_pad + 1;
        }
      } else {
        int eligible = 0;
        for (int b = 0; b < g_pad; b += T)
          eligible += __syncthreads_count(b + t < g_pad && sum(b + t) >= 1.0f);
        if (t == 0)
          ctl[NT_C_CAP] = __float_as_int(
              ceilf(__fdiv_rn(k_actual, fmaxf((float)eligible, 1.0f))));
      }
    }
    nt_cluster_arrive_wait();  // rank 0's match and cap are set
  }
  const int* ctl0 = cl.map_shared_rank(ctl, 0);
  const int match = ctl0[NT_C_MATCH];
  const float spread_cap = __int_as_float(ctl0[NT_C_CAP]);

  // ---- 3. the K member steps
  bool reuse = false;  // the cached scores hold (all but ``updated``)
  int updated = -1;    // the node of this thread's last row update
  bool missing = false;
  for (int k = 0; k < K; ++k) {
    const float* snz = gnoise(k);
    if (p.stage_noise) {
      nt_mbar_wait(&bar[NT_G_NOISE + k % NT_SCAN_STAGES],
                   (unsigned)((k / NT_SCAN_STAGES) & 1));
      snz = nt_staged(smem + lay.noise[k % NT_SCAN_STAGES], snz);
    }
    clock.tick(NT_P_WAIT);
    const bool act = p.active[k] != 0;
    clock.tick(NT_P_ASK);
    unsigned bh = 0;
    int bi = -1;
    float bs = 0.0f, bn = 0.0f;
    for (int i = t; i < cnt; i += T) {
      float base;
      if (reuse && i != updated) {
        base = cache[i];
      } else {
        const int pl = placed[i];
        bool ok = feas[i] != 0;
        if (mode == NT_GANG_SLICE) ok = ok && topo[i] == match;
        if (dhb) ok = ok && pl == 0 && dhp[i] == 0;
        base = nt_fit_of(util[i], cap[i], sched[i], bwu[i], bwa[i], ports[i],
                         ok, jc[i] + pl, false, p.penalty, a, abw, aports);
        if (p.cache) cache[i] = base;
      }
      float v = NT_NEG_INF;
      const float n_i = snz[i];
      if (base != -INFINITY) {
        bool fits = true;
        float s = base;
        if (counts) {
          const int tid = topo[i];
          const float gc = members[min(max(tid >= 0 ? tid : g_pad, 0),
                                       g_pad - 1)];
          if (mode == NT_GANG_SPREAD)
            fits = tid < 0 || gc < spread_cap;
          else
            s = __fadd_rn(s, __fmul_rn(NT_GANG_AFFINITY_BONUS,
                                       tid >= 0 ? gc : 0.0f));
        }
        if (fits) v = __fadd_rn(s, n_i);
      }
      const unsigned h = nt_score_word(v);
      if (h > bh) {  // i rises per thread: strict > keeps the lowest index
        bh = h;
        bi = i;
        bs = v;
        bn = n_i;
      }
    }
    const unsigned bl = bi >= 0 ? 0xffffffffu - (unsigned)(glo + bi) : 0u;
    clock.tick(NT_P_SCORE);
    const unsigned long long win = nt_cluster_argmax(
        ((unsigned long long)bh << 32) | bl, x, k, clock, [] {});
    // The cluster's keys of step k are in, so every warp of this CTA has
    // scored it: its noise stage takes step k + 4's row, and the key
    // phase of step k + 2 is posted.
    if (t == 0) {
      if (k + 2 < K) nt_expect_keys(x, k + 2);
      if (p.stage_noise && k + NT_SCAN_STAGES < K)
        issue_noise(k + NT_SCAN_STAGES);
    }
    const unsigned gh = (unsigned)(win >> 32), gl = (unsigned)win;
    const bool valid =
        gh != 0 && nt_unpack_score(win) > NT_NEG_INF / 2 && act;
    updated = -1;
    if (valid && bh == gh && bl == gl) {  // this thread owns the winner
      p.choices[k] = glo + bi;
      p.scores[k] = __fsub_rn(bs, bn);
      const float4 u = util[bi];
      util[bi] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                             __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
      bwu[bi] = __fadd_rn(bwu[bi], abw);
      ports[bi] = __fadd_rn(ports[bi], -aports);
      placed[bi] = placed[bi] + 1;
      updated = bi;
    } else if (!valid && rank == 0 && t == 0) {
      p.choices[k] = -1;
      p.scores[k] = 0.0f;
    }
    missing = missing || (act && !valid);
    if (valid && t == 0 && (counts || rank == 0)) {
      // The winner's topology id, read through its segment.
      const int wi = (int)(0xffffffffu - gl);
      int gid;
      if constexpr (SEG) {
        int ws = 0;
        while (ws + 1 < p.W && wi >= p.seg[ws + 1].lo) ++ws;
        gid = __ldg(p.seg[ws].topo_ids + (wi - p.seg[ws].lo));
      } else {
        gid = __ldg(p.topo_ids + wi);
      }
      if (gid >= 0 && gid < g_pad)
        members[gid] = __fadd_rn(members[gid], 1.0f);
    }
    if (counts) __syncthreads();  // the counts' add before the next step
    reuse = p.cache;
    clock.tick(NT_P_WIN);
  }
  if (RES)
    for (int i = t; i < cnt; i += T) {
      gutil[i] = util[i];
      gbwu[i] = bwu[i];
      gports[i] = ports[i];
      gplaced[i] = placed[i];
    }
  if (TIMED && clock.on)
    for (int i = 0; i < NT_P_PARTS; ++i) p.prof[i] = prof_acc[i];
  // Every owner's choices are written, and no CTA reads another's shared
  // memory after this.
  nt_cluster_arrive_wait();

  // ---- 4. all-K: a partial gang never leaves the device
  if (rank == 0) {
    if (missing)
      for (int k = t; k < K; k += T) {
        p.choices[k] = -1;
        p.scores[k] = 0.0f;
      }
    for (int s = 0; s < (SEG ? p.W : 1); ++s) {
      float* gm = SEG ? p.seg[s].group_members : p.group_members;
      for (int g = t; g < g_pad; g += T) gm[g] = members[g];
    }
    if (t == 0) p.slice_group[0] = missing ? -1 : ctl[NT_C_CHOSEN];
  }
}

static std::atomic<int> nt_gang_ready[NT_SCAN_DEVICES];

// The gang kernel for a form, timed or not; over segments (``seg``,
// untimed) or one.
static void (*nt_gang_kernel(int resident, bool timed,
                             bool seg))(const NtGangArgs) {
  if (seg)
    return resident ? nt_gang_cluster_kernel<true, false, true>
                    : nt_gang_cluster_kernel<false, false, true>;
  if (resident)
    return timed ? nt_gang_cluster_kernel<true, true, false>
                 : nt_gang_cluster_kernel<true, false, false>;
  return timed ? nt_gang_cluster_kernel<false, true, false>
               : nt_gang_cluster_kernel<false, false, false>;
}

// The kernels' attributes on the current device, once a device.
static int nt_gang_setup() {
  return nt_once_a_device(nt_gang_ready, [] {
    for (int r = 0; r < 2; ++r)
      for (int form = 0; form < 3; ++form) {  // untimed, timed, segments
        const int err = nt_scan_attrs(
            (const void*)nt_gang_kernel(r, form == 1, form == 2), form == 2);
        if (err) return err;
      }
    return 0;
  });
}

// A segment from its rows' pointers, in NtGangSeg's order.
static NtGangSeg nt_gang_seg(long long lo, long long n,
                             const void* const* q) {
  NtGangSeg sg;
  sg.lo = lo;
  sg.n = n;
  sg.capacity = (const float4*)q[0];
  sg.sched = (const float4*)q[1];
  sg.util = (float4*)q[2];
  sg.bw_avail = (const float*)q[3];
  sg.bw_used = (float*)q[4];
  sg.ports_free = (float*)q[5];
  sg.feas_row = (const unsigned char*)q[6];
  sg.job_count = (const int*)q[7];
  sg.dh_presence = (const int*)q[8];
  sg.topo_ids = (const int*)q[9];
  sg.noise = (const float*)q[10];
  sg.placed = (int*)q[11];
  sg.group_members = (float*)q[12];
  return sg;
}

// Checks the plan against ``p`` (its gang, segments and scratch set),
// sets the slice length and launches: p.W segments of p.cps CTAs each
// (``seg``) or one segment over the cluster of ``ctas``.
static int nt_gang_run(NtGangArgs& p, int ctas, int threads, int resident,
                       bool seg, long long smem, void* stream) {
  const int mode = p.mode;
  const bool capg = mode == NT_GANG_SLICE || mode == NT_GANG_SPREAD;
  if (p.g_pad < 1 || mode < 0 || mode > 3 ||
      !nt_scan_shape_ok(ctas, threads) || p.W < 1 || p.cps < 1 ||
      p.W * p.cps != ctas || (!seg && p.W != 1) ||
      (seg && p.prof != nullptr) ||
      (capg && (p.units == nullptr || (!p.groups && p.group_cap == nullptr) ||
                (p.W > 1 && p.walk == nullptr))) ||
      (!p.groups && p.members_rows == nullptr))
    return (int)cudaErrorInvalidValue;
  int L = 0;
  for (int s = 0; s < p.W; ++s) {
    const long long n = p.seg[s].n;
    if (n < 0 || (s > 0 && p.seg[s].lo != p.seg[s - 1].lo + p.seg[s - 1].n))
      return (int)cudaErrorInvalidValue;
    const int part = (int)((n + p.cps - 1) / p.cps);
    L = part > L ? part : L;
  }
  p.L = L;
  const NtGangLayout lay =
      nt_gang_layout(ctas, threads / 32, L, p.g_pad, resident, p.stage_noise,
                     p.cache, p.groups, capg);
  if ((long long)lay.total != smem ||
      lay.total > NT_SCAN_SMEM_MAX - (seg ? NT_SCAN_SEG_SMEM : 0))
    return (int)cudaErrorInvalidValue;
  int err = nt_gang_setup();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = nt_scan_cfg(1, ctas, threads, lay.total,
                                             (cudaStream_t)stream, attr);
  return (int)cudaLaunchKernelEx(
      &cfg, nt_gang_kernel(resident, p.prof != nullptr, seg), p);
}

// The gang's arguments common to both entries.
static void nt_gang_common(NtGangArgs& p, int K, int g_pad, int mode, int dh,
                           float penalty, int stage_noise, int cache,
                           int groups, const void* ask_res,
                           const void* ask_bw, const void* ask_ports,
                           const void* active, const void* group_noise,
                           void* choices, void* scores, void* slice_group,
                           void* group_cap, void* members_rows,
                           void* units) {
  p.K = K;
  p.g_pad = g_pad;
  p.mode = mode;
  p.dh = dh;
  p.stage_noise = stage_noise;
  p.cache = cache;
  p.groups = groups;
  p.penalty = penalty;
  p.ask_res = (const float4*)ask_res;
  p.ask_bw = (const float*)ask_bw;
  p.ask_ports = (const float*)ask_ports;
  p.active = (const unsigned char*)active;
  p.group_noise = (const float*)group_noise;
  p.choices = (int*)choices;
  p.scores = (float*)scores;
  p.slice_group = (int*)slice_group;
  p.group_cap = (float*)group_cap;
  p.members_rows = (float*)members_rows;
  p.units = (float*)units;
}

// Shapes: capacity/sched/util [N,4] f32; bw_avail/bw_used/ports_free [N]
// f32; feas_row [N] u8; job_count/dh_presence/topo_ids [N] i32;
// ask_res [4] f32, ask_bw/ask_ports [] f32; active [K] u8; noise [K,N]
// f32; group_noise [g_pad] f32; placed [N] i32 and group_members
// [g_pad] f32 (carried); util/bw_used/ports_free carried in place; out
// choices [K] i32, scores [K] f32, slice_group [] i32. mode: 0 free, 1
// slice, 2 spread, 3 affinity; any g_pad >= 1. Scratch: group_cap
// [g_pad] f32 (slice and spread mode without ``groups``), members_rows
// [ctas, g_pad] f32 (without ``groups``), units [N] f32 (slice and
// spread mode). The launch's plan (ops/scan.py GangPlan): ctas, threads,
// resident, stage_noise, cache, groups (the counts and sums in shared
// memory) and the shared memory it computes, which must equal this
// file's layout. prof: null, or NT_P_PARTS i64 (the step parts' clock
// cycles on one thread of rank 0).
NT_API int nt_gang_scan(int N, int K, int g_pad, int mode, int dh,
                        float penalty, int ctas, int threads, int resident,
                        int stage_noise, int cache, int groups,
                        long long smem, const void* capacity,
                        const void* sched, void* util, const void* bw_avail,
                        void* bw_used, void* ports_free, const void* feas_row,
                        const void* job_count, const void* dh_presence,
                        const void* topo_ids, const void* ask_res,
                        const void* ask_bw, const void* ask_ports,
                        const void* active, const void* noise,
                        const void* group_noise, void* placed,
                        void* group_members, void* choices, void* scores,
                        void* slice_group, void* group_cap,
                        void* members_rows, void* units, void* prof,
                        void* stream) {
  if (K <= 0) return 0;
  if (N < 0) return (int)cudaErrorInvalidValue;
  NtGangArgs p = {};
  nt_gang_common(p, K, g_pad, mode, dh, penalty, stage_noise, cache, groups,
                 ask_res, ask_bw, ask_ports, active, group_noise, choices,
                 scores, slice_group, group_cap, members_rows, units);
  p.W = 1;
  p.cps = ctas;
  p.prof = (long long*)prof;
  const void* rows[NT_GANG_SEG_PTRS] = {
      capacity, sched, util, bw_avail, bw_used, ports_free, feas_row,
      job_count, dh_presence, topo_ids, noise, placed, group_members};
  p.seg[0] = nt_gang_seg(0, N, rows);  // for nt_gang_run's checks
  const NtGangSeg& sg = p.seg[0];  // the kernel's own fields
  p.N = N;
  p.capacity = sg.capacity;
  p.sched = sg.sched;
  p.util = sg.util;
  p.bw_avail = sg.bw_avail;
  p.bw_used = sg.bw_used;
  p.ports_free = sg.ports_free;
  p.feas_row = sg.feas_row;
  p.job_count = sg.job_count;
  p.dh_presence = sg.dh_presence;
  p.topo_ids = sg.topo_ids;
  p.noise = sg.noise;
  p.placed = sg.placed;
  p.group_members = sg.group_members;
  return nt_gang_run(p, ctas, threads, resident, false, smem, stream);
}

// K10e on the shards of one card: the gang over W <= 16 segments, cps
// CTAs each (a cluster of cps x W), in node order. seg_dims [W,2] i64
// (global lo, rows) and seg_ptrs [W,13] (capacity, sched, util,
// bw_avail, bw_used, ports_free, feas_row, job_count, dh_presence,
// topo_ids, noise [K,n], placed [n], group_members [g_pad]: a shard's
// rows and carry, as nt_gang_scan's over the segment) are host arrays;
// every segment's group_members is written with the gang's counts
// (read from segment 0's). The ask, active, group_noise, the outputs,
// the plan and the scratch as nt_gang_scan's (units over all the
// segments' rows), and walk [g_pad] f32 (slice and spread mode, W > 1):
// a segment's partial in the ordered walk.
NT_API int nt_gang_segments(int K, int g_pad, int mode, int dh,
                            float penalty, int W, int cps, int threads,
                            int resident, int stage_noise, int cache,
                            int groups, long long smem,
                            const long long* seg_dims,
                            const void* const* seg_ptrs, const void* ask_res,
                            const void* ask_bw, const void* ask_ports,
                            const void* active, const void* group_noise,
                            void* choices, void* scores, void* slice_group,
                            void* group_cap, void* members_rows, void* units,
                            void* walk, void* stream) {
  if (K <= 0) return 0;
  if (W < 1 || W > NT_SCAN_CLUSTER_MAX || cps < 1)
    return (int)cudaErrorInvalidValue;
  NtGangArgs p = {};
  nt_gang_common(p, K, g_pad, mode, dh, penalty, stage_noise, cache, groups,
                 ask_res, ask_bw, ask_ports, active, group_noise, choices,
                 scores, slice_group, group_cap, members_rows, units);
  p.W = W;
  p.cps = cps;
  p.walk = (float*)walk;
  for (int s = 0; s < W; ++s)
    p.seg[s] = nt_gang_seg(seg_dims[2 * s], seg_dims[2 * s + 1],
                           seg_ptrs + (size_t)s * NT_GANG_SEG_PTRS);
  return nt_gang_run(p, cps * W, threads, resident, true, smem, stream);
}

// The clusters of ``ctas`` CTAs of ``threads`` threads and ``smem``
// bytes of shared memory in the given form that the card holds at once,
// written to *clusters (0: the card refuses such a cluster); no kernel
// runs.
NT_API int nt_gang_occupancy(int ctas, int threads, long long smem,
                             int resident, int* clusters) {
  *clusters = 0;
  if (!nt_scan_shape_ok(ctas, threads) || smem < 0 ||
      smem > NT_SCAN_SMEM_MAX)
    return 0;
  int err = nt_gang_setup();
  if (err) return err;
  nt_cluster_occupancy((const void*)nt_gang_kernel(resident, false, false),
                       ctas, threads, (size_t)smem, clusters);
  return 0;
}
