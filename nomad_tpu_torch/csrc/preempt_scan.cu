// K6: the dense preemption pass — K dependent place-or-preempt steps
// for one eval (ops/preempt.py _preempt_step, scanned by
// preempt_placement_program, in the JAX package).
//
// Step k, for ask k, over every node n:
// - the normal masked BestFit-v3 score (csrc/common.cuh nt_fit_of and
//   nt_group_fits, K1's);
// - if n does not fit normally but is eligible (feasible, ready,
//   distinct_hosts clear), a walk over its V = 8 priority-ascending
//   victim slots keeping the running freed sums: the first slot k* that
//   is live, whose prefix holds only live victims below the eval's
//   priority (consumed and padding slots do not break the prefix), and
//   after whose eviction the ask fits, gives the post-eviction score
//   BestFit(util + ask - freed) - penalty * job_count - 2 * n_victims +
//   noise, with NO zero-sched-capacity guard (the JAX program has none).
// A normal fit anywhere wins (preemption is masked out while any node
// fits normally). Ties go to the lowest node index in both argmaxes,
// as jnp.argmax; k* is the first fitting slot. The winner's row takes
// the ask less what its evictions freed, one more alloc of the job and
// of the task group, and slots 0..k* dead. Inactive (padding) asks skip
// the pass.
//
// Bound on the card: the chain of K dependent argmaxes over N nodes, as
// K1's. On one SM (the design before this one) each step walked all N
// nodes and the victim slots of those that do not fit (232 bytes a
// node), ~16.5 us a step at N = 10,240. Design: K1's cluster scan
// (csrc/cluster.cuh), as K7 took it (csrc/gang_scan.cu):
//
// - One eval, one thread-block cluster of up to 16 CTAs: CTA r owns
//   nodes [r N / c, (r+1) N / c), and thread t of it owns nodes t, t +
//   T, ... for the whole launch. Only a node's owner reads or writes
//   its rows, so no step needs a block barrier for them.
// - Resident form: each CTA keeps its slice in shared memory, loaded by
//   bulk copies (cp.async.bulk on an mbarrier) and written back by the
//   owners at the end: the node rows (capacity, sched, util, bw_avail,
//   bw_used, ports_free, node_ok), job_count, tg_count and feasible,
//   and the victim slots' footprints (res, bw, ports: 192 bytes a
//   node). The slots' liveness (v_ok, 8 bytes a node) and whether each
//   is below the eval's priority (v_prio < prio_e, fixed for the
//   launch; 32 bytes a node) are kept as two bit masks a node, built by
//   the owners at load time. Streamed form, where a slice does not fit
//   (larger N or G): the same kernel reads and updates the rows in
//   global memory (ops/scan.py preempt_plan picks the cluster, the
//   threads and the form).
// - The score cache: between two steps only the winner's row and its
//   slots change, and one job's asks are alike. Each node keeps in
//   shared memory its normal part before the noise and before its task
//   group's part of the mask (nt_fit_of), and its preemption part
//   before the noise (fitness(util + ask - freed[k*]) - penalty x
//   job_count - 2 x nv, or -inf: no fitting prefix). Both are
//   recomputed only for the node its owner updated last, and for every
//   node when the ask differs from the last scored one; each step
//   applies the group-dependent eligibility (nt_group_fits; feasible[n,
//   tg] & node_ok, job_count == 0 under the job's distinct_hosts,
//   tg_count == 0 under the group's) and adds the step's noise: the
//   same rounded operations on the same values, so the same bits.
// - Two keys a step: each thread keeps its best normal fit and its
//   best preemption; one exchange carries both (two st.async a CTA to
//   every CTA, the key mbarrier's transaction count doubled). The winner
//   is the cluster's best normal key if any CTA has one, else its best
//   preemption key. The owner of the winner recovers k* by walking the
//   slots again, updates its rows and writes the choice, score - noise
//   and n_victims; rank 0 writes the steps with no winner and the
//   inactive asks, which skip the pass and the exchange uniformly.
// - The noise: K0's [K, N] tensor, each step's row slice staged four
//   steps ahead by a bulk copy (NT_SCAN_STAGES).
//
// Every + - * / is a round-to-nearest intrinsic (csrc/common.cuh), in
// the plain version's order, so choices, n_victims, the carry and the
// consumed-victim mask equal ops/preempt.py preempt_scan_plain's bit
// for bit.
#include "cluster.cuh"

#define NT_PREEMPT_V 8
#define NT_PREEMPT_VICTIM_PENALTY 2.0f
// Steps ahead whose asks are prefetched into L1 (K1's NT_SCAN_ASK_AHEAD).
#define NT_PREEMPT_ASK_AHEAD 8

// The mbarriers at the start of shared memory: the resident rows, the
// noise stages, the keys (by exchange parity).
enum { NT_PB_ROWS = 0, NT_PB_NOISE = 1, NT_PB_KEYS = 1 + NT_SCAN_STAGES,
       NT_PB_COUNT = NT_PB_KEYS + 2 };

// Resident rows staged by bulk copies (ops/scan.py preempt_rows).
enum { NT_PR_CAP, NT_PR_SCHED, NT_PR_UTIL, NT_PR_BWA, NT_PR_BWU,
       NT_PR_PORTS, NT_PR_OK, NT_PR_JC, NT_PR_TGC, NT_PR_FEAS, NT_PR_VRES,
       NT_PR_VBW, NT_PR_VPORTS, NT_PR_ROWS };

// Byte offsets in a CTA's dynamic shared memory (ops/scan.py
// preempt_layout): the mbarriers and the profile's counters, the key
// pairs' slots by exchange parity, the score cache (the normal parts,
// then the preemption parts), the noise stages, then in the resident
// form the rows and the two slot masks a node (live, outranked).
struct NtPreemptLayout {
  size_t slots, cache, noise[NT_SCAN_STAGES], rows[NT_PR_ROWS], masks,
      total;
};

__host__ __device__ inline NtPreemptLayout nt_preempt_layout(
    int nc, int warps, int L, int G, int resident, int stage_noise,
    int cache) {
  NtPreemptLayout o = {};
  size_t at = nt_r16(8 * NT_PB_COUNT + 8 * NT_P_PARTS);
  o.slots = at;  // CTA key pairs [2][nc], then warp key pairs [2][warps]
  at += nt_r16((size_t)32 * (nc + warps));
  o.cache = at;
  if (cache) at += nt_r16((size_t)8 * L);
  if (stage_noise)
    for (int x = 0; x < NT_SCAN_STAGES; ++x) {
      o.noise[x] = at;
      at += nt_stage_len((size_t)4 * L);
    }
  if (resident) {
    const size_t per[NT_PR_ROWS] = {16, 16, 16, 4, 4, 4, 1, 4, (size_t)4 * G,
                                    (size_t)G, 16 * NT_PREEMPT_V,
                                    4 * NT_PREEMPT_V, 4 * NT_PREEMPT_V};
    for (int r = 0; r < NT_PR_ROWS; ++r) {
      o.rows[r] = at;
      at += nt_stage_len(per[r] * L);
    }
    o.masks = at;
    at += nt_r16((size_t)2 * L);
  }
  o.total = at;
  return o;
}

struct NtPreemptArgs {
  int N, G, K, L, stage_noise, cache;
  float penalty, prio_e;
  const float4* capacity;
  const float4* sched;
  float4* util;
  const float* bw_avail;
  float* bw_used;
  float* ports_free;
  int* job_count;
  int* tg_count;
  const unsigned char* feasible;
  const unsigned char* node_ok;
  const float4* v_res;
  const float* v_bw;
  const float* v_ports;
  const float* v_prio;
  unsigned char* v_ok;
  const float4* ask_res;
  const float* ask_bw;
  const float* ask_ports;
  const int* tg_index;
  const unsigned char* active;
  const unsigned char* job_dh;
  const unsigned char* tg_dh;
  const float* noise;
  int* choices;
  float* scores;
  int* n_victims;
  long long* prof;
};

// One node's victim slots: their footprints and, as bit masks, the
// live slots and the slots below the eval's priority.
struct NtSlots {
  const float4* res;
  const float* bw;
  const float* ports;
  unsigned live, out;
};

struct NtVictimWalk {
  int k;         // first fitting slot, -1 when none
  float4 freed;  // resources freed by slots 0..k
  float fbw;
  float fports;
  float nv;      // live victims among slots 0..k
};

// The first fitting prefix of a node's victims for an ask that brings
// the node to util nu, bandwidth bwn (bw_used + ask) and leaves it
// ports_free pf; the sums run in slot order, as the JAX cumsum.
__device__ __forceinline__ NtVictimWalk nt_victim_walk(
    const NtSlots& v, float4 nu, float bwn, float pf, float4 cap, float bwa,
    float aports) {
  NtVictimWalk w;
  w.k = -1;
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f, fb = 0.0f, fp = 0.0f;
  float live = 0.0f;
  for (int s = 0; s < NT_PREEMPT_V; ++s) {
    // Dead slots add nothing (the JAX sums multiply them by 0).
    if (!((v.live >> s) & 1u)) continue;
    if (!((v.out >> s) & 1u)) break;  // the prefix ends here
    const float4 r = v.res[s];
    f0 = __fadd_rn(f0, r.x);
    f1 = __fadd_rn(f1, r.y);
    f2 = __fadd_rn(f2, r.z);
    f3 = __fadd_rn(f3, r.w);
    fb = __fadd_rn(fb, v.bw[s]);
    fp = __fadd_rn(fp, v.ports[s]);
    live = __fadd_rn(live, 1.0f);
    const bool fits = (__fsub_rn(nu.x, f0) <= cap.x) &&
                      (__fsub_rn(nu.y, f1) <= cap.y) &&
                      (__fsub_rn(nu.z, f2) <= cap.z) &&
                      (__fsub_rn(nu.w, f3) <= cap.w) &&
                      (__fsub_rn(bwn, fb) <= bwa) &&
                      (__fadd_rn(pf, fp) >= aports);
    if (fits) {
      w.k = s;
      w.freed = make_float4(f0, f1, f2, f3);
      w.fbw = fb;
      w.fports = fp;
      w.nv = live;
      return w;
    }
  }
  return w;
}

__device__ __forceinline__ float4 nt_add4(float4 u, float4 a) {
  return make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                     __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
}

// A node's preemption part before the noise: the post-eviction
// BestFit-v3 fitness less penalty x job_count and the victims' penalty
// (the plain version's order of rounded operations), or -inf where no
// prefix of its victims makes the ask fit.
__device__ __forceinline__ float nt_preempt_part(
    const NtSlots& v, float4 u, float4 cap, float4 sc, float bwu, float bwa,
    float pf, int jc, float penalty, float4 a, float abw, float aports) {
  const float4 nu = nt_add4(u, a);
  const NtVictimWalk w =
      nt_victim_walk(v, nu, __fadd_rn(bwu, abw), pf, cap, bwa, aports);
  if (w.k < 0) return -INFINITY;
  const float f0 = __fsub_rn(
      1.0f, __fdiv_rn(__fsub_rn(nu.x, w.freed.x), fmaxf(sc.x, 1.0f)));
  const float f1 = __fsub_rn(
      1.0f, __fdiv_rn(__fsub_rn(nu.y, w.freed.y), fmaxf(sc.y, 1.0f)));
  float fit = __fsub_rn(20.0f, __fadd_rn(powf(10.0f, f0), powf(10.0f, f1)));
  fit = fminf(fmaxf(fit, 0.0f), 18.0f);
  return __fsub_rn(__fsub_rn(fit, __fmul_rn(penalty, (float)jc)),
                   __fmul_rn(NT_PREEMPT_VICTIM_PENALTY, w.nv));
}

// One step's ask.
struct NtPreemptAsk {
  float4 a;
  float bw, ports;
  int tg;
  bool act;
};

__device__ __forceinline__ NtPreemptAsk nt_preempt_ask(
    const NtPreemptArgs& p, int k) {
  return NtPreemptAsk{p.ask_res[k], p.ask_bw[k], p.ask_ports[k],
                      p.tg_index[k], p.active[k] != 0};
}

__device__ __forceinline__ void nt_prefetch_l1(const void* q) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(q));
}

// Whether two asks give every unchanged node the same cached parts.
__device__ __forceinline__ bool nt_preempt_same_ask(const NtPreemptAsk& x,
                                                    const NtPreemptAsk& y) {
  return x.a.x == y.a.x && x.a.y == y.a.y && x.a.z == y.a.z &&
         x.a.w == y.a.w && x.bw == y.bw && x.ports == y.ports;
}

// The key pairs' exchange (csrc/cluster.cuh nt_cluster_argmax with two
// keys a thread): its CTA's warp key pairs [2][W][2], the cluster's CTA
// key pairs [2][nc][2] and key mbarriers [2] (by exchange parity), and
// for lane r < nc the shared::cluster addresses of CTA r's pairs and
// key mbarriers.
struct NtPairExchange {
  unsigned long long* wkeys;
  unsigned long long* keys;
  uint64_t* kbar;
  uint32_t peer_keys, peer_kbar;
  int nc, rank, warps;
};

__device__ __forceinline__ NtPairExchange nt_pair_exchange(
    unsigned char* smem, size_t slots, uint64_t* kbar, int nc, int rank,
    int warps) {
  const int lane = threadIdx.x & 31;
  NtPairExchange x;
  x.keys = (unsigned long long*)(smem + slots);
  x.wkeys = x.keys + 4 * nc;
  x.kbar = kbar;
  x.peer_keys = nt_mapa(nt_saddr(x.keys), lane < nc ? lane : 0);
  x.peer_kbar = nt_mapa(nt_saddr(x.kbar), lane < nc ? lane : 0);
  x.nc = nc;
  x.rank = rank;
  x.warps = warps;
  return x;
}

// Post exchange s's key pairs (nc x 16 bytes), two exchanges ahead.
__device__ __forceinline__ void nt_expect_pairs(const NtPairExchange& x,
                                                int s) {
  nt_expect(&x.kbar[s & 1], (unsigned)(16 * x.nc));
}

// The cluster's two winners of exchange s from each thread's best keys
// (0: no node): each warp's largest pair into the CTA's warp slots, one
// block barrier, warp 0's largest of those sent to every CTA's slot for
// this CTA (two st.async, completing on that CTA's key mbarrier), the
// wait for the cluster's pairs, then the largest of each in every
// thread.
template <bool TIMED>
__device__ __forceinline__ void nt_pair_argmax(
    unsigned long long kn, unsigned long long kp, const NtPairExchange& x,
    int s, NtClock<TIMED>& clock, unsigned long long& wn,
    unsigned long long& wp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int par = s & 1;
  const unsigned long long a = nt_warp_max(kn);
  const unsigned long long b = nt_warp_max(kp);
  unsigned long long* wk = x.wkeys + 2 * (size_t)par * x.warps;
  if (lane == 0) {
    wk[2 * warp] = a;
    wk[2 * warp + 1] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const unsigned long long ca =
        nt_warp_max(lane < x.warps ? wk[2 * lane] : 0ull);
    const unsigned long long cb =
        nt_warp_max(lane < x.warps ? wk[2 * lane + 1] : 0ull);
    if (lane < x.nc) {
      const uint32_t dst =
          x.peer_keys + (uint32_t)(16 * (par * x.nc + x.rank));
      const uint32_t bar = x.peer_kbar + (uint32_t)(8 * par);
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 "
          "[%0], %1, [%2];\n" ::"r"(dst),
          "l"(ca), "r"(bar)
          : "memory");
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 "
          "[%0], %1, [%2];\n" ::"r"(dst + 8u),
          "l"(cb), "r"(bar)
          : "memory");
    }
  }
  clock.tick(NT_P_BLOCK);
  clock.tick(NT_P_DRAW);
  nt_mbar_wait(&x.kbar[par], (unsigned)((s >> 1) & 1));
  clock.tick(NT_P_EXCH);
  const unsigned long long* ck = x.keys + 2 * (size_t)par * x.nc;
  wn = nt_warp_max(lane < x.nc ? ck[2 * lane] : 0ull);
  wp = nt_warp_max(lane < x.nc ? ck[2 * lane + 1] : 0ull);
}

// RES: the resident form, else streamed; TIMED: the step parts are
// timed into p.prof.
template <bool RES, bool TIMED>
__global__ void __launch_bounds__(NT_SCAN_THREADS, 1)
    nt_preempt_cluster_kernel(const __grid_constant__ NtPreemptArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = (uint64_t*)smem;
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int T = blockDim.x, W = T >> 5;
  const int t = threadIdx.x;
  const int G = p.G, K = p.K, L = p.L;
  const NtPreemptLayout lay = nt_preempt_layout(nc, W, L, G, RES,
                                                p.stage_noise, p.cache);
  const NtPairExchange x =
      nt_pair_exchange(smem, lay.slots, bar + NT_PB_KEYS, nc, rank, W);
  // This CTA's slice: nodes [lo, lo + cnt) (may be empty; its CTA still
  // meets every barrier).
  const int lo = (int)((long long)rank * p.N / nc);
  const int cnt = (int)((long long)(rank + 1) * p.N / nc) - lo;
  float* cache_n = (float*)(smem + lay.cache);
  float* cache_p = cache_n + L;
  long long* prof_acc = (long long*)(smem + 8 * NT_PB_COUNT);
  NtClock<TIMED> clock = {rank == 0 && t == (T > 32 ? 32 : 0), 0, prof_acc};
  if (TIMED && clock.on) {
    for (int i = 0; i < NT_P_PARTS; ++i) prof_acc[i] = 0;
    clock.clk = clock64();
  }

  // The slice's rows in global memory.
  const float4* gcap = p.capacity + lo;
  const float4* gsched = p.sched + lo;
  float4* gutil = p.util + lo;
  const float* gbwa = p.bw_avail + lo;
  float* gbwu = p.bw_used + lo;
  float* gports = p.ports_free + lo;
  const unsigned char* gok = p.node_ok + lo;
  int* gjc = p.job_count + lo;
  int* gtgc = p.tg_count + (size_t)lo * G;
  const unsigned char* gfeas = p.feasible + (size_t)lo * G;
  const float4* gvres = p.v_res + (size_t)lo * NT_PREEMPT_V;
  const float* gvbw = p.v_bw + (size_t)lo * NT_PREEMPT_V;
  const float* gvports = p.v_ports + (size_t)lo * NT_PREEMPT_V;
  const float* gvprio = p.v_prio + (size_t)lo * NT_PREEMPT_V;
  unsigned char* gvok = p.v_ok + (size_t)lo * NT_PREEMPT_V;
  auto gnoise = [&](int k) { return p.noise + (size_t)k * p.N + lo; };
  auto issue_noise = [&](int k) {
    const float* src = gnoise(k);
    uint64_t* b = &bar[NT_PB_NOISE + k % NT_SCAN_STAGES];
    nt_expect_bulk(b, nt_superset(src, (size_t)4 * cnt));
    nt_bulk(smem + lay.noise[k % NT_SCAN_STAGES], src, (size_t)4 * cnt, b);
  };

  // The exchanges: one an active ask, counted by every thread.
  int exchanges = 0;
  for (int b = 0; b < K; b += T)
    exchanges += __syncthreads_count(b + t < K && p.active[b + t] != 0);
  const bool jdh = p.job_dh[0] != 0;
  if (t == 0) {
    for (int i = 0; i < NT_PB_COUNT; ++i) nt_mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 && i < exchanges; ++i) nt_expect_pairs(x, i);
  }
  // Every CTA of the cluster has started (its slots exist) and sees its
  // mbarriers initialised and the first key pairs posted.
  nt_cluster_arrive_wait();
  if (t == 0) {
    if (RES) {
      const void* src[NT_PR_ROWS] = {gcap, gsched, gutil, gbwa, gbwu,
                                     gports, gok, gjc, gtgc, gfeas,
                                     gvres, gvbw, gvports};
      const size_t per[NT_PR_ROWS] = {
          16, 16, 16, 4, 4, 4, 1, 4, (size_t)4 * G, (size_t)G,
          16 * NT_PREEMPT_V, 4 * NT_PREEMPT_V, 4 * NT_PREEMPT_V};
      unsigned tx = 0;
      for (int r = 0; r < NT_PR_ROWS; ++r)
        tx += nt_superset(src[r], per[r] * cnt);
      nt_expect_bulk(&bar[NT_PB_ROWS], tx);
      for (int r = 0; r < NT_PR_ROWS; ++r)
        nt_bulk(smem + lay.rows[r], src[r], per[r] * cnt, &bar[NT_PB_ROWS]);
    }
    if (p.stage_noise)
      for (int i = 0; i < NT_SCAN_STAGES && i < K; ++i) issue_noise(i);
  }
  // The slot masks of this thread's nodes (resident), from global
  // memory while the rows land.
  unsigned char* live_m = smem + lay.masks;
  unsigned char* out_m = live_m + L;
  auto masks_of = [&](int i, unsigned& live, unsigned& out) {
    live = 0;
    out = 0;
    for (int s = 0; s < NT_PREEMPT_V; ++s) {
      const size_t at = (size_t)i * NT_PREEMPT_V + s;
      live |= (gvok[at] != 0 ? 1u : 0u) << s;
      out |= (gvprio[at] < p.prio_e ? 1u : 0u) << s;
    }
  };
  if (RES) {
    for (int i = t; i < cnt; i += T) {
      unsigned live, out;
      masks_of(i, live, out);
      live_m[i] = (unsigned char)live;
      out_m[i] = (unsigned char)out;
    }
    nt_mbar_wait(&bar[NT_PB_ROWS], 0);
  }
  // The rows this thread reads: shared memory (resident) or global.
  const float4* cap =
      RES ? nt_staged(smem + lay.rows[NT_PR_CAP], gcap) : gcap;
  const float4* sched =
      RES ? nt_staged(smem + lay.rows[NT_PR_SCHED], gsched) : gsched;
  float4* util = RES ? nt_staged(smem + lay.rows[NT_PR_UTIL], gutil) : gutil;
  const float* bwa = RES ? nt_staged(smem + lay.rows[NT_PR_BWA], gbwa) : gbwa;
  float* bwu = RES ? nt_staged(smem + lay.rows[NT_PR_BWU], gbwu) : gbwu;
  float* ports =
      RES ? nt_staged(smem + lay.rows[NT_PR_PORTS], gports) : gports;
  const unsigned char* ok =
      RES ? nt_staged(smem + lay.rows[NT_PR_OK], gok) : gok;
  int* jc = RES ? nt_staged(smem + lay.rows[NT_PR_JC], gjc) : gjc;
  int* tgc = RES ? nt_staged(smem + lay.rows[NT_PR_TGC], gtgc) : gtgc;
  const unsigned char* feas =
      RES ? nt_staged(smem + lay.rows[NT_PR_FEAS], gfeas) : gfeas;
  const float4* vres =
      RES ? nt_staged(smem + lay.rows[NT_PR_VRES], gvres) : gvres;
  const float* vbw = RES ? nt_staged(smem + lay.rows[NT_PR_VBW], gvbw) : gvbw;
  const float* vports =
      RES ? nt_staged(smem + lay.rows[NT_PR_VPORTS], gvports) : gvports;
  // Node i's slots, and slots 0..k set dead.
  auto slots = [&](int i) {
    NtSlots v;
    v.res = vres + (size_t)i * NT_PREEMPT_V;
    v.bw = vbw + (size_t)i * NT_PREEMPT_V;
    v.ports = vports + (size_t)i * NT_PREEMPT_V;
    if constexpr (RES) {
      v.live = live_m[i];
      v.out = out_m[i];
    } else {
      masks_of(i, v.live, v.out);
    }
    return v;
  };
  auto consume = [&](int i, int k) {
    if constexpr (RES) {
      live_m[i] = (unsigned char)(live_m[i] & ~((2u << k) - 1u));
    } else {
      for (int s = 0; s <= k; ++s) gvok[(size_t)i * NT_PREEMPT_V + s] = 0;
    }
  };

  NtPreemptAsk last = {};  // the last ask scored
  bool scored = false;      // some ask has been scored (the cache holds)
  int updated = -1;         // the node of this thread's last row update
  int xs = 0;               // exchanges so far
  for (int k = 0; k < K; ++k) {
    const float* snz = gnoise(k);
    if (p.stage_noise) {
      nt_mbar_wait(&bar[NT_PB_NOISE + k % NT_SCAN_STAGES],
                   (unsigned)((k / NT_SCAN_STAGES) & 1));
      snz = nt_staged(smem + lay.noise[k % NT_SCAN_STAGES], snz);
    }
    clock.tick(NT_P_WAIT);
    if (t == T - 1 && k + NT_PREEMPT_ASK_AHEAD < K) {
      const int ah = k + NT_PREEMPT_ASK_AHEAD;
      nt_prefetch_l1(p.ask_res + ah);
      nt_prefetch_l1(p.ask_bw + ah);
      nt_prefetch_l1(p.ask_ports + ah);
      nt_prefetch_l1(p.tg_index + ah);
      nt_prefetch_l1(p.active + ah);
    }
    const NtPreemptAsk cur = nt_preempt_ask(p, k);
    if (!cur.act) {  // uniform over the cluster: no pass, no exchange
      if (rank == 0 && t == 0) {
        p.choices[k] = -1;
        p.scores[k] = 0.0f;
        p.n_victims[k] = 0;
      }
      // Every thread has waited on this step's stage (its last read of
      // the buffer came before an earlier step's barrier) before the
      // stage takes step k + 4's row and its mbarrier a new phase.
      if (p.stage_noise) {
        __syncthreads();
        if (t == 0 && k + NT_SCAN_STAGES < K) issue_noise(k + NT_SCAN_STAGES);
      }
      continue;
    }
    const float4 a = cur.a;
    const float abw = cur.bw, aports = cur.ports;
    const int tg = cur.tg;
    const bool tdh = p.tg_dh[tg] != 0;
    const bool reuse = p.cache && scored && nt_preempt_same_ask(cur, last);
    clock.tick(NT_P_ASK);
    unsigned long long kn = 0ull, kp = 0ull;
    float nn = 0.0f, np = 0.0f;  // the noise of each best node
    for (int i = t; i < cnt; i += T) {
      float base, pbase;
      if (reuse && i != updated) {
        base = cache_n[i];
        pbase = cache_p[i];
      } else {
        const float4 u = util[i];
        const bool oki = ok[i] != 0;
        const int jci = jc[i];
        base = nt_fit_of(u, cap[i], sched[i], bwu[i], bwa[i], ports[i], oki,
                         jci, jdh, p.penalty, a, abw, aports);
        pbase = -INFINITY;
        if (base == -INFINITY && oki && (!jdh || jci == 0))
          pbase = nt_preempt_part(slots(i), u, cap[i], sched[i], bwu[i],
                                  bwa[i], ports[i], jci, p.penalty, a, abw,
                                  aports);
        if (p.cache) {
          cache_n[i] = base;
          cache_p[i] = pbase;
        }
      }
      if (base == -INFINITY && pbase == -INFINITY) continue;
      const size_t cell = (size_t)i * G + tg;
      const bool fe = feas[cell] != 0;
      const int tc = tdh ? tgc[cell] : 0;
      const float n_i = snz[i];
      if (base != -INFINITY) {
        // A normal fit; where its group's part fails, so does the
        // eligibility to preempt.
        if (nt_group_fits(fe, tdh, tc)) {
          const unsigned long long key =
              nt_pack(__fadd_rn(base, n_i), lo + i);
          if (key > kn) {
            kn = key;
            nn = n_i;
          }
        }
      } else {
        bool elig = fe && ok[i] != 0;
        if (jdh) elig = elig && jc[i] == 0;
        if (tdh) elig = elig && tc == 0;
        if (elig) {
          const unsigned long long key =
              nt_pack(__fadd_rn(pbase, n_i), lo + i);
          if (key > kp) {
            kp = key;
            np = n_i;
          }
        }
      }
    }
    clock.tick(NT_P_SCORE);
    unsigned long long wn, wp;
    nt_pair_argmax(kn, kp, x, xs, clock, wn, wp);
    // The cluster's pairs of exchange xs are in, so every warp of this
    // CTA has scored step k: its noise stage takes step k + 4's row,
    // and the pairs of exchange xs + 2 are posted.
    if (t == 0) {
      if (xs + 2 < exchanges) nt_expect_pairs(x, xs + 2);
      if (p.stage_noise && k + NT_SCAN_STAGES < K)
        issue_noise(k + NT_SCAN_STAGES);
    }
    const bool normal = wn != 0ull && nt_unpack_score(wn) > NT_NEG_INF / 2;
    const bool pre =
        !normal && wp != 0ull && nt_unpack_score(wp) > NT_NEG_INF / 2;
    updated = -1;
    if ((normal && kn == wn) || (pre && kp == wp)) {
      // This thread owns the winner (the key holds its index).
      const int c = nt_unpack_index(normal ? wn : wp) - lo;
      const float4 u = util[c];
      float4 d = a;
      float dbw = abw;
      float dports = -aports;
      int nv = 0;
      if (pre) {
        const NtVictimWalk w =
            nt_victim_walk(slots(c), nt_add4(u, a), __fadd_rn(bwu[c], abw),
                           ports[c], cap[c], bwa[c], aports);
        d = make_float4(__fsub_rn(a.x, w.freed.x), __fsub_rn(a.y, w.freed.y),
                        __fsub_rn(a.z, w.freed.z), __fsub_rn(a.w, w.freed.w));
        dbw = __fsub_rn(abw, w.fbw);
        dports = __fsub_rn(w.fports, aports);
        nv = (int)w.nv;
        if (w.k >= 0) consume(c, w.k);
      }
      p.choices[k] = lo + c;
      p.scores[k] = __fsub_rn(nt_unpack_score(normal ? wn : wp),
                              normal ? nn : np);
      p.n_victims[k] = nv;
      util[c] = nt_add4(u, d);
      bwu[c] = __fadd_rn(bwu[c], dbw);
      ports[c] = __fadd_rn(ports[c], dports);
      jc[c] = jc[c] + 1;
      const size_t cell = (size_t)c * G + tg;
      tgc[cell] = tgc[cell] + 1;
      updated = c;
    } else if (!normal && !pre && rank == 0 && t == 0) {
      p.choices[k] = -1;
      p.scores[k] = 0.0f;
      p.n_victims[k] = 0;
    }
    last = cur;
    scored = true;
    ++xs;
    clock.tick(NT_P_WIN);
  }
  if (RES)
    for (int i = t; i < cnt; i += T) {
      gutil[i] = util[i];
      gbwu[i] = bwu[i];
      gports[i] = ports[i];
      gjc[i] = jc[i];
      for (int g = 0; g < G; ++g)
        gtgc[(size_t)i * G + g] = tgc[(size_t)i * G + g];
      const unsigned live = live_m[i];
      for (int s = 0; s < NT_PREEMPT_V; ++s)
        gvok[(size_t)i * NT_PREEMPT_V + s] = (unsigned char)((live >> s) & 1u);
    }
  if (TIMED && clock.on)
    for (int i = 0; i < NT_P_PARTS; ++i) p.prof[i] = prof_acc[i];
  // Keeps every CTA's shared memory alive until the cluster is done.
  nt_cluster_arrive_wait();
}

static std::atomic<int> nt_preempt_ready[NT_SCAN_DEVICES];

static void (*nt_preempt_kernel(int resident, bool timed))(
    const NtPreemptArgs) {
  if (resident)
    return timed ? nt_preempt_cluster_kernel<true, true>
                 : nt_preempt_cluster_kernel<true, false>;
  return timed ? nt_preempt_cluster_kernel<false, true>
               : nt_preempt_cluster_kernel<false, false>;
}

// The kernels' attributes on the current device, once a device.
static int nt_preempt_setup() {
  return nt_once_a_device(nt_preempt_ready, [] {
    for (int r = 0; r < 2; ++r)
      for (int timed = 0; timed < 2; ++timed) {
        const int err =
            nt_scan_attrs((const void*)nt_preempt_kernel(r, timed != 0));
        if (err) return err;
      }
    return 0;
  });
}

static bool nt_aligned16(const void* q) { return ((uintptr_t)q & 15) == 0; }

// Shapes: capacity/sched/util [N,4] f32, bw_avail/bw_used/ports_free
// [N] f32, job_count [N] i32, tg_count [N,G] i32, feasible [N,G] u8,
// node_ok [N] u8 (ops/binpack.py NodeState's order; util, bw_used,
// ports_free, job_count and tg_count carried, updated in place); v_res
// [N,8,4] f32, v_bw/v_ports/v_prio [N,8] f32, v_ok [N,8] u8 (carried);
// ask_res [K,4] f32, ask_bw/ask_ports [K] f32, tg_index [K] i32, active
// [K] u8, job_dh [] u8, tg_dh [G] u8; noise [K,N] f32 (K0's); out
// choices [K] i32, scores [K] f32, n_victims [K] i32. The launch's plan
// (ops/scan.py PreemptPlan): ctas, threads, resident, stage_noise,
// cache and the shared memory it computes, which must equal this file's
// layout. prof: null, or NT_P_PARTS i64 (the step parts' clock cycles
// on one thread of rank 0).
NT_API int nt_preempt_scan(
    int N, int G, int K, float penalty, float prio_e, int ctas, int threads,
    int resident, int stage_noise, int cache, long long smem,
    const void* capacity, const void* sched, void* util, const void* bw_avail,
    void* bw_used, void* ports_free, void* job_count, void* tg_count,
    const void* feasible, const void* node_ok, const void* v_res,
    const void* v_bw, const void* v_ports, const void* v_prio, void* v_ok,
    const void* ask_res, const void* ask_bw, const void* ask_ports,
    const void* tg_index, const void* active, const void* job_dh,
    const void* tg_dh, const void* noise, void* choices, void* scores,
    void* n_victims, void* prof, void* stream) {
  if (K <= 0) return 0;
  if (N < 0 || G < 1 || !nt_scan_shape_ok(ctas, threads) ||
      (N > 0 && ctas > N))
    return (int)cudaErrorInvalidValue;
  if (!nt_aligned16(capacity) || !nt_aligned16(sched) ||
      !nt_aligned16(util) || !nt_aligned16(v_res) || !nt_aligned16(ask_res))
    return (int)cudaErrorMisalignedAddress;
  NtPreemptArgs p = {};
  p.N = N;
  p.G = G;
  p.K = K;
  p.L = (N + ctas - 1) / ctas;
  p.stage_noise = stage_noise;
  p.cache = cache;
  p.penalty = penalty;
  p.prio_e = prio_e;
  const NtPreemptLayout lay = nt_preempt_layout(
      ctas, threads / 32, p.L, G, resident, stage_noise, cache);
  if ((long long)lay.total != smem || lay.total > NT_SCAN_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  p.capacity = (const float4*)capacity;
  p.sched = (const float4*)sched;
  p.util = (float4*)util;
  p.bw_avail = (const float*)bw_avail;
  p.bw_used = (float*)bw_used;
  p.ports_free = (float*)ports_free;
  p.job_count = (int*)job_count;
  p.tg_count = (int*)tg_count;
  p.feasible = (const unsigned char*)feasible;
  p.node_ok = (const unsigned char*)node_ok;
  p.v_res = (const float4*)v_res;
  p.v_bw = (const float*)v_bw;
  p.v_ports = (const float*)v_ports;
  p.v_prio = (const float*)v_prio;
  p.v_ok = (unsigned char*)v_ok;
  p.ask_res = (const float4*)ask_res;
  p.ask_bw = (const float*)ask_bw;
  p.ask_ports = (const float*)ask_ports;
  p.tg_index = (const int*)tg_index;
  p.active = (const unsigned char*)active;
  p.job_dh = (const unsigned char*)job_dh;
  p.tg_dh = (const unsigned char*)tg_dh;
  p.noise = (const float*)noise;
  p.choices = (int*)choices;
  p.scores = (float*)scores;
  p.n_victims = (int*)n_victims;
  p.prof = (long long*)prof;
  int err = nt_preempt_setup();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = nt_scan_cfg(1, ctas, threads, lay.total,
                                             (cudaStream_t)stream, attr);
  return (int)cudaLaunchKernelEx(
      &cfg, nt_preempt_kernel(resident, prof != nullptr), p);
}

// The clusters of ``ctas`` CTAs of ``threads`` threads and ``smem``
// bytes of shared memory in the given form that the card holds at once,
// written to *clusters (0: the card refuses such a cluster); no kernel
// runs.
NT_API int nt_preempt_occupancy(int ctas, int threads, long long smem,
                                int resident, int* clusters) {
  *clusters = 0;
  if (!nt_scan_shape_ok(ctas, threads) || smem < 0 ||
      smem > NT_SCAN_SMEM_MAX)
    return 0;
  int err = nt_preempt_setup();
  if (err) return err;
  nt_cluster_occupancy((const void*)nt_preempt_kernel(resident, false), ctas,
                       threads, (size_t)smem, clusters);
  return 0;
}
