// K1: the greedy placement scan — K dependent masked-argmax steps per
// eval (ops/binpack.py _score_and_mask + placement_step, scanned by
// placement_program, in the JAX package), under three batch layouts:
//
// - independent evals (vmap): a cluster per eval, each eval with its
//   own copy of the carried util, bw_used and ports_free;
// - sequential evals (seq = 1; the pre_resolve scan over the eval axis,
//   _overlay_seq and the pre_resolve branch of _compact_batch): ONE
//   cluster walks the B evals in order over one shared copy of util,
//   bw_used and ports_free, so eval b+1 scores against the capacity
//   evals 0..b claimed; job_count, tg_count, feasible, asks and the
//   noise's key stay per eval;
// - stacked states (stacked = 1; batched_placement_program): capacity,
//   sched, bw_avail and node_ok carry the batch axis too.
//
// Step k scores every node for ask k, takes the best (lowest index on
// ties, as jnp.argmax), and, when the ask is active and some node
// fits, adds the ask to that one row of the carried util, bw_used,
// ports_free, job_count and tg_count. Step k+1 reads the row step k
// wrote, so the K steps (B x K under seq) are a dependent chain.
//
// Bound on the card: the chain — K argmax reductions in sequence, each
// over N nodes of ~40 bytes. One SM walking the node axis took ~12 us
// a step at N = 10,240 against a 0.46 us block reduction. Design:
//
// - The node axis splits over a thread-block cluster of ``ctas`` CTAs
//   (cudaLaunchKernelEx with a cluster dimension; up to 16, the
//   non-portable maximum): CTA r owns nodes [r N / c, (r+1) N / c), and
//   within it thread t owns nodes t, t + T, t + 2T, ... for the whole
//   launch. Only a node's owner reads or writes its rows, so no step
//   needs a block barrier.
// - Resident form: each CTA keeps its slice's static rows (capacity,
//   sched, bw_avail, node_ok), carried rows (util, bw_used, ports_free)
//   and the eval's job_count, tg_count and feasible in shared memory,
//   loaded by bulk copies (cp.async.bulk on an mbarrier, each the
//   16-byte-aligned superset of its rows) and written back by the
//   owners: job_count and tg_count at the end of each eval, the shared
//   carried rows at the end of the launch. Under seq the next eval's
//   rows load into a second buffer while the current eval runs.
//   Streamed form, where a slice does not fit (small clusters at large
//   B, large G): the same kernel reads and updates the rows in global
//   memory. ops/scan.py scan_plan picks the cluster, the threads and
//   the form from B, N, G and the card's occupancy.
// - The score cache: between two steps only the winner's row changes,
//   and a job's asks are alike. Each node's score before the noise and
//   before its task group's part of the mask (fit - penalty x
//   job_count, or "does not fit": nt_fit_of) is kept in shared memory;
//   a step whose ask has the last one's resources, bandwidth and ports
//   (same eval) recomputes it only for the node its owner updated, and
//   every node applies the step's task-group part (nt_group_fits) and
//   adds the new noise — the same operations on the same values, so
//   the same bits.
// - The tie-break noise, in one of two modes the plan picks (DRAW):
//   drawn in the kernel, or read from K0's [B, K, N] tensor. Drawn, the
//   noise of step k of eval b at node i is K0's value (csrc/common.cuh
//   nt_noise_at) of the counter k x draw_total + draw_lo + i under
//   keys[b], the element the JAX package's [K, N] draw holds there, so
//   no [B, K, N] tensor is written or read. It does not depend on the
//   winner: each thread hashes step s + 1's values for its first
//   NT_DRAW_AHEAD nodes into registers after it has handed in its key
//   for step s and before the cluster's winner arrives, so the hash
//   fills the exchange's wait; nodes past those hash in the scoring
//   pass. The hash is ~80 integer instructions a node a step on the
//   launch's own SMs: it pays where a CTA's slice is short against the
//   nodes K0 hashes a step on each SM (B = 64 on 2 CTAs an eval), while
//   a launch on a few SMs (one cluster of 16: B = 1, the sequential
//   layout) is faster reading K0's tensor, which K0 draws on every SM
//   (ops/scan.py draws; PERF.md §6). Read, step s + 4's noise row
//   slice is staged by a bulk copy into one of four buffers while steps
//   s..s+3 run (where they fit). The asks of the steps ahead are
//   prefetched into L1 and the next step's loaded into registers a step
//   ahead.
// - One exchange a step (csrc/cluster.cuh nt_cluster_argmax): a key a
//   CTA sent to every CTA with st.async, the winner reduced in every
//   thread. The owner of the winning node (its own best key is the
//   winner) updates the node's rows and writes the choice and score;
//   rank 0 writes a step with no winner.
// - Segments (SEG): the node axis as W segments, each a node shard's
//   own rows from global row ``lo`` (K10c and K10g-b on the shards of
//   one card, parallel/shard.py). CTA r takes part r mod cps of segment
//   r / cps (cps CTAs a segment), with the segment's pointers and its
//   own row strides; the keys pack the global index, so ties still go
//   to the lowest global node (jnp.argmax's order, and the per-shard
//   route's shard order). K1 and K8b are the one-segment case (SEG
//   false: segment 0, cps = the cluster), whose forms compile as
//   before.
// - K8b (BIAS, the convex kernel's rounding scan: csrc/convex_round.cu)
//   is this kernel with the rounding bias added to each node's score,
//   biased = score + ROUND_BIAS x pref[k, n] - STRAND_BIAS x strand(n)
//   (csrc/common.cuh nt_round_bias, in the plain version's order of
//   rounded operations). Its noise is read (K0's tensor), and its pref
//   row, 4 bytes a node a step, is staged beside the noise row on the
//   same stage's mbarrier. The strand term depends only on the node's
//   carried util and the ask's resources, so it joins the score cache
//   (a second row of it). The owner of the winner reports score -
//   noise, without the bias; the bias cannot lift a node that does not
//   fit (NEG_INF plus a bounded bias rounds to NEG_INF), so validity is
//   K1's.
#include "cluster.cuh"

// A thread's nodes whose noise is drawn a step ahead, in registers
// (5: the most a thread owns at B = 64 on 2 CTAs; more spill).
#define NT_DRAW_AHEAD 5
// Steps ahead whose asks are prefetched into L1.
#define NT_SCAN_ASK_AHEAD 8

// One segment of the node axis: a shard's n rows from global row lo
// (the whole axis for K1 and K8b); row pointers not yet offset to the
// eval, strided by the segment's own n; its noise window [B,K,n] (read
// mode) and, for K8b's bias, its pref columns [B,K,n].
struct NtScanSeg {
  long long lo, n;
  const float4* capacity;
  const float4* sched;
  const float* bw_avail;
  const unsigned char* node_ok;
  float4* util;
  float* bw_used;
  float* ports_free;
  int* job_count;
  int* tg_count;
  const unsigned char* feasible;
  const float* noise;
  const float* pref;
};
#define NT_SCAN_SEG_PTRS 12

// The batch's arguments, then the segment table: K1 and K8b launch
// with one segment (seg[0], the whole node axis, N its rows), K10c and
// K10g-b with W of cps CTAs each.
struct NtScanArgs {
  int B, N, G, K, seq, stacked, stage_noise, eval_bufs, cache, L;
  float penalty, scale;
  long long draw_total, draw_lo;
  const float4* ask_res;
  const float* ask_bw;
  const float* ask_ports;
  const int* tg_index;
  const unsigned char* active;
  const unsigned char* job_dh;
  const unsigned char* tg_dh;
  const long long* keys;
  int* choices;
  float* scores;
  long long* prof;
  int W, cps;
  NtScanSeg seg[NT_SCAN_CLUSTER_MAX];
};

// The mbarriers at the start of shared memory.
enum { NT_B_ROWS = 0, NT_B_NOISE = 2, NT_B_KEYS = 2 + NT_SCAN_STAGES,
       NT_B_COUNT = NT_B_KEYS + 2 };

// Resident rows: the static and carried rows, then each eval's own.
enum { NT_S_CAP, NT_S_SCHED, NT_S_UTIL, NT_S_BWA, NT_S_BWU, NT_S_PORTS,
       NT_S_OK, NT_S_ROWS };
enum { NT_E_JC, NT_E_TGC, NT_E_FEAS, NT_E_ROWS };

// Byte offsets in a CTA's dynamic shared memory (ops/scan.py layout):
// the mbarriers (eval rows by eval parity, noise by stage, keys by step
// parity) and the profile's counters, the keys' slots by step parity,
// the score cache (with ``bias`` a second row: the strand terms), the
// noise stages (read mode; with ``bias`` the pref stages after them),
// then in the resident form the rows and ``eval_bufs`` sets of an eval's
// rows.
struct NtScanLayout {
  size_t slots, cache, noise[NT_SCAN_STAGES], pref[NT_SCAN_STAGES],
      rows[NT_S_ROWS], erows[2][NT_E_ROWS], total;
};

__host__ __device__ inline NtScanLayout nt_scan_layout(
    int nc, int warps, int L, int G, int resident, int stage_noise,
    int eval_bufs, int cache, int bias) {
  NtScanLayout o = {};
  size_t at = 8 * NT_B_COUNT + 8 * NT_P_PARTS;  // and the profile's counters
  at = nt_r16(at);
  o.slots = at;  // CTA keys [2][nc], then warp keys [2][warps]
  at += nt_r16((size_t)16 * (nc + warps));
  o.cache = at;
  if (cache) at += nt_r16((size_t)(bias ? 8 : 4) * L);
  if (stage_noise) {
    for (int x = 0; x < NT_SCAN_STAGES; ++x) {
      o.noise[x] = at;
      at += nt_stage_len((size_t)4 * L);
    }
    if (bias)
      for (int x = 0; x < NT_SCAN_STAGES; ++x) {
        o.pref[x] = at;
        at += nt_stage_len((size_t)4 * L);
      }
  }
  if (resident) {
    const size_t per[NT_S_ROWS] = {16, 16, 16, 4, 4, 4, 1};
    for (int r = 0; r < NT_S_ROWS; ++r) {
      o.rows[r] = at;
      at += nt_stage_len(per[r] * L);
    }
    const size_t eper[NT_E_ROWS] = {4, (size_t)4 * G, (size_t)G};
    for (int x = 0; x < eval_bufs; ++x)
      for (int r = 0; r < NT_E_ROWS; ++r) {
        o.erows[x][r] = at;
        at += nt_stage_len(eper[r] * L);
      }
  }
  o.total = at;
  return o;
}

// One step's ask.
struct NtAsk {
  float4 a;
  float bw, ports;
  int tg;
  bool act;
};

__device__ __forceinline__ NtAsk nt_ask(const NtScanArgs& p, size_t i) {
  return NtAsk{p.ask_res[i], p.ask_bw[i], p.ask_ports[i], p.tg_index[i],
               p.active[i] != 0};
}

// Whether two asks give every unchanged node the same nt_fit_of.
__device__ __forceinline__ bool nt_same_ask(const NtAsk& x, const NtAsk& y) {
  return x.a.x == y.a.x && x.a.y == y.a.y && x.a.z == y.a.z &&
         x.a.w == y.a.w && x.bw == y.bw && x.ports == y.ports;
}

__device__ __forceinline__ void nt_prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// RES: the resident form (the rows in shared memory), else streamed;
// TIMED: the step parts are timed into p.prof; DRAW: the noise drawn in
// the kernel, else read from the segment's noise (staged where
// p.stage_noise); BIAS: K8b, the rounding bias from the segment's pref
// added (the noise read); SEG: the CTAs over p.W segments, p.cps a
// segment (else segment 0 over the whole cluster).
template <bool RES, bool TIMED, bool DRAW, bool BIAS, bool SEG>
__global__ void __launch_bounds__(NT_SCAN_THREADS, 1)
    nt_greedy_cluster_kernel(const __grid_constant__ NtScanArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = (uint64_t*)smem;
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int T = blockDim.x, W = T >> 5;
  const int t = threadIdx.x;
  const int G = p.G, K = p.K;
  static_assert(!(DRAW && BIAS), "K8b reads its noise");
  const NtScanLayout lay = nt_scan_layout(nc, W, p.L, G, RES, p.stage_noise,
                                          p.eval_bufs, p.cache, BIAS);
  const NtExchange x =
      nt_exchange(smem, lay.slots, bar + NT_B_KEYS, nc, rank, W);
  // This CTA's slice: part ``pj`` of segment ``si`` (a part may be
  // empty; its CTA still meets every barrier), local rows [lo, lo +
  // cnt), global rows from ``glo``.
  const int cps = SEG ? p.cps : nc;
  const int si = SEG ? rank / cps : 0;
  const int pj = rank - si * cps;
  // SEG: the segment's row from shared memory, read where it is used
  // (its pointers held in registers across the steps spill); the one
  // segment from the parameters, as K1 and K8b always read them (their
  // forms compile as they did without the table: PERF.md §6).
  const NtScanSeg* row;
  if constexpr (SEG) {
    __shared__ NtScanSeg seg_row;
    if (t == 0) seg_row = p.seg[si];
    __syncthreads();
    row = &seg_row;
  } else {
    row = &p.seg[0];
  }
  const NtScanSeg& sg = *row;
  const int nrows = SEG ? (int)sg.n : p.N;
  const int lo = (int)((long long)pj * nrows / cps);
  const int cnt = (int)((long long)(pj + 1) * nrows / cps) - lo;
  const int glo = SEG ? (int)sg.lo + lo : lo;  // one segment: at 0
  const int first = p.seq ? 0 : (int)(blockIdx.x / nc);
  const int evals = p.seq ? p.B : 1;
  const int steps = evals * K;
  // Row strides and the carried rows' write-back pointers: SEG forms
  // them from the shared row where they are used (held across the
  // steps, they spill), the one segment once.
  const size_t nn0 = (size_t)nrows;
  auto nn = [&] { return SEG ? (size_t)sg.n : nn0; };
  const size_t sb = p.stacked ? first : 0;  // static rows of the eval
  const size_t cb = p.seq ? 0 : first;      // claimed capacity
  const size_t ask_end = (size_t)p.B * K - 1;
  float* cache = (float*)(smem + lay.cache);
  float* scache = cache + p.L;  // BIAS: the strand terms
  // The profile's counters follow the mbarriers; the timed thread
  // issues no bulk copies.
  long long* prof_acc = (long long*)(smem + 8 * NT_B_COUNT);
  NtClock<TIMED> clock = {rank == 0 && t == (T > 32 ? 32 : 0), 0, prof_acc};
  if (TIMED && clock.on) {
    for (int i = 0; i < NT_P_PARTS; ++i) prof_acc[i] = 0;
    clock.clk = clock64();
  }

  // The slice's rows in global memory; ``e`` the cluster's eval index.
  const float4* gcap = sg.capacity + sb * nn() + lo;
  const float4* gsched = sg.sched + sb * nn() + lo;
  const float* gbwa = sg.bw_avail + sb * nn() + lo;
  const unsigned char* gok = sg.node_ok + sb * nn() + lo;
  float4* const gutil0 = SEG ? nullptr : sg.util + cb * nn0 + lo;
  float* const gbwu0 = SEG ? nullptr : sg.bw_used + cb * nn0 + lo;
  float* const gports0 = SEG ? nullptr : sg.ports_free + cb * nn0 + lo;
  auto gutil = [&] { return SEG ? sg.util + cb * nn() + lo : gutil0; };
  auto gbwu = [&] { return SEG ? sg.bw_used + cb * nn() + lo : gbwu0; };
  auto gports = [&] {
    return SEG ? sg.ports_free + cb * nn() + lo : gports0;
  };
  auto gjc = [&](int e) {
    return sg.job_count + (size_t)(first + e) * nn() + lo;
  };
  auto gtgc = [&](int e) {
    return sg.tg_count + ((size_t)(first + e) * nn() + lo) * G;
  };
  auto gfeas = [&](int e) {
    return sg.feasible + ((size_t)(first + e) * nn() + lo) * G;
  };
  auto gnoise = [&](int s) {  // step s's noise row slice (read mode)
    return sg.noise + ((size_t)first * K + s) * nn() + lo;
  };
  auto gpref = [&](int s) {  // step s's pref row slice (BIAS)
    return sg.pref + ((size_t)first * K + s) * nn() + lo;
  };
  auto erow = [&](int e, int r) {
    return smem + lay.erows[e % p.eval_bufs][r];
  };

  // Eval e's rows (and with ``all`` the static and carried rows) onto
  // bar[e & 1]; step s's noise onto its stage's. By thread 0.
  auto issue_eval = [&](int e, bool all) {
    const void* src[NT_S_ROWS + NT_E_ROWS] = {
        gcap, gsched, gutil(), gbwa, gbwu(), gports(), gok, gjc(e), gtgc(e),
        gfeas(e)};
    const size_t len[NT_S_ROWS + NT_E_ROWS] = {
        (size_t)16 * cnt, (size_t)16 * cnt, (size_t)16 * cnt,
        (size_t)4 * cnt, (size_t)4 * cnt, (size_t)4 * cnt, (size_t)cnt,
        (size_t)4 * cnt, (size_t)4 * G * cnt, (size_t)G * cnt};
    unsigned char* dst[NT_S_ROWS + NT_E_ROWS];
    for (int r = 0; r < NT_S_ROWS; ++r) dst[r] = smem + lay.rows[r];
    for (int r = 0; r < NT_E_ROWS; ++r) dst[NT_S_ROWS + r] = erow(e, r);
    const int r0 = all ? 0 : NT_S_ROWS;
    uint64_t* b = &bar[NT_B_ROWS + (e & 1)];
    unsigned tx = 0;
    for (int r = r0; r < NT_S_ROWS + NT_E_ROWS; ++r)
      tx += nt_superset(src[r], len[r]);
    nt_expect_bulk(b, tx);
    for (int r = r0; r < NT_S_ROWS + NT_E_ROWS; ++r)
      nt_bulk(dst[r], src[r], len[r], b);
  };
  auto issue_noise = [&](int s) {  // with BIAS, the pref row beside it
    const float* src = gnoise(s);
    const float* psrc = BIAS ? gpref(s) : nullptr;
    const int x = s % NT_SCAN_STAGES;
    uint64_t* b = &bar[NT_B_NOISE + x];
    nt_expect_bulk(b, nt_superset(src, (size_t)4 * cnt) +
                          (BIAS ? nt_superset(psrc, (size_t)4 * cnt) : 0u));
    nt_bulk(smem + lay.noise[x], src, (size_t)4 * cnt, b);
    if (BIAS) nt_bulk(smem + lay.pref[x], psrc, (size_t)4 * cnt, b);
  };
  // Step s's draw: its eval's key words and the counter of this CTA's
  // first node (step k's row of the eval's [K, draw_total] draw), and
  // the values of this thread's first NT_DRAW_AHEAD nodes into ``nz``.
  uint32_t dk0 = 0, dk1 = 0;
  unsigned long long dbase = 0;
  float nz[NT_DRAW_AHEAD];
  auto draw = [&](int s) {
    const int e = s / K, k = s - e * K;
    dk0 = (uint32_t)p.keys[2 * (size_t)(first + e)];
    dk1 = (uint32_t)p.keys[2 * (size_t)(first + e) + 1];
    dbase = (unsigned long long)k * (unsigned long long)p.draw_total +
            (unsigned long long)(p.draw_lo + glo);
#pragma unroll
    for (int j = 0; j < NT_DRAW_AHEAD; ++j) {
      const int i = t + j * T;
      if (i < cnt)
        nz[j] = nt_noise_at(dk0, dk1, dbase + (unsigned)i, 0.0f, p.scale);
    }
  };

  if (t == 0) {
    for (int i = 0; i < NT_B_COUNT; ++i) nt_mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 && i < steps; ++i) nt_expect_keys(x, i);
  }
  // Every CTA of the cluster has started (its slots exist) and sees its
  // mbarriers initialised and the first keys posted.
  nt_cluster_arrive_wait();
  if (t == 0 && steps > 0) {
    if (RES) issue_eval(0, true);
    if (!DRAW && p.stage_noise)
      for (int i = 0; i < NT_SCAN_STAGES && i < steps; ++i) issue_noise(i);
  }
  if (DRAW && steps > 0) draw(0);

  // The rows this thread scores: shared memory (resident) or global.
  const float4* cap = RES ? nt_staged(smem + lay.rows[NT_S_CAP], gcap) : gcap;
  const float4* sched =
      RES ? nt_staged(smem + lay.rows[NT_S_SCHED], gsched) : gsched;
  float4* util =
      RES ? nt_staged(smem + lay.rows[NT_S_UTIL], gutil()) : gutil();
  const float* bwa = RES ? nt_staged(smem + lay.rows[NT_S_BWA], gbwa) : gbwa;
  float* bwu = RES ? nt_staged(smem + lay.rows[NT_S_BWU], gbwu()) : gbwu();
  float* ports =
      RES ? nt_staged(smem + lay.rows[NT_S_PORTS], gports()) : gports();
  const unsigned char* ok =
      RES ? nt_staged(smem + lay.rows[NT_S_OK], gok) : gok;
  int* jc = nullptr;
  int* tgc = nullptr;
  const unsigned char* feas = nullptr;
  bool jdh = false;

  NtAsk cur = steps > 0 ? nt_ask(p, (size_t)first * K) : NtAsk{};
  bool reuse = false;  // the scores before the noise still hold
  int updated = -1;    // the node of this thread's last row update
  for (int s = 0; s < steps; ++s) {
    const int e = s / K, k = s - e * K, b = first + e;
    const size_t ai = (size_t)b * K + k;
    if (k == 0) {
      if (RES) {
        nt_mbar_wait(&bar[NT_B_ROWS + (e & 1)], (unsigned)((e >> 1) & 1));
        jc = nt_staged(erow(e, NT_E_JC), gjc(e));
        tgc = nt_staged(erow(e, NT_E_TGC), gtgc(e));
        feas = nt_staged(erow(e, NT_E_FEAS), gfeas(e));
      } else {
        jc = gjc(e);
        tgc = gtgc(e);
        feas = gfeas(e);
      }
      jdh = p.job_dh[b] != 0;
    }
    const float* snz = nullptr;  // read mode: this step's noise row slice
    const float* spr = nullptr;  // BIAS: its pref row slice
    if constexpr (!DRAW) {
      snz = gnoise(s);
      if (BIAS) spr = gpref(s);
      if (p.stage_noise) {
        const int x = s % NT_SCAN_STAGES;
        nt_mbar_wait(&bar[NT_B_NOISE + x],
                     (unsigned)((s / NT_SCAN_STAGES) & 1));
        snz = nt_staged(smem + lay.noise[x], snz);
        if (BIAS) spr = nt_staged(smem + lay.pref[x], spr);
      }
    }
    clock.tick(NT_P_WAIT);
    if (t == T - 1) {
      const size_t ah =
          ai + NT_SCAN_ASK_AHEAD < ask_end ? ai + NT_SCAN_ASK_AHEAD : ask_end;
      nt_prefetch_l1(p.ask_res + ah);
      nt_prefetch_l1(p.ask_bw + ah);
      nt_prefetch_l1(p.ask_ports + ah);
      nt_prefetch_l1(p.tg_index + ah);
      nt_prefetch_l1(p.active + ah);
    }
    const NtAsk nxt = s + 1 < steps ? nt_ask(p, ai + 1) : cur;
    const bool tdh = p.tg_dh[(size_t)b * G + cur.tg] != 0;
    clock.tick(NT_P_ASK);
    unsigned bh = 0;
    int bi = -1;
    float bn = 0.0f;
    float bs = 0.0f;  // BIAS: the best node's score before the bias
    for (int i = t, j = 0; i < cnt; i += T, ++j) {
      // The node's noise: drawn ahead (the front of ``nz``, shifted
      // down a node, so every index stays a constant) or now, from this
      // step's key words and base (``draw`` set them a step ahead).
      float n_i;
      if constexpr (!DRAW) {
        n_i = snz[i];
      } else if (j < NT_DRAW_AHEAD) {
        n_i = nz[0];
#pragma unroll
        for (int y = 0; y + 1 < NT_DRAW_AHEAD; ++y) nz[y] = nz[y + 1];
      } else {
        n_i = nt_noise_at(dk0, dk1, dbase + (unsigned)i, 0.0f, p.scale);
      }
      float base, strand = 0.0f;
      if (reuse && i != updated) {
        base = cache[i];
        if (BIAS) strand = scache[i];
      } else {
        base = nt_fit_of(util[i], cap[i], sched[i], bwu[i], bwa[i], ports[i],
                         ok[i] != 0, jc[i], jdh, p.penalty, cur.a, cur.bw,
                         cur.ports);
        if (BIAS)
          strand = __fmul_rn(NT_STRAND_BIAS,
                             nt_strand_pen(i, cap, sched, util, cur.a));
        if (p.cache) {
          cache[i] = base;
          if (BIAS) scache[i] = strand;
        }
      }
      const size_t cell = (size_t)i * G + cur.tg;
      const bool fits = base != -INFINITY &&
                        nt_group_fits(feas[cell] != 0, tdh,
                                      tdh ? tgc[cell] : 0);
      const float v = fits ? __fadd_rn(base, n_i) : NT_NEG_INF;
      // K8b ranks score + bias (nt_round_bias's order of operations).
      const unsigned h = nt_score_word(
          BIAS ? __fadd_rn(v, __fsub_rn(__fmul_rn(NT_ROUND_BIAS, spr[i]),
                                        strand))
               : v);
      if (h > bh) {  // i rises per thread: strict > keeps the lowest index
        bh = h;
        bi = i;
        bn = n_i;
        if (BIAS) bs = v;
      }
    }
    const unsigned bl = bi >= 0 ? 0xffffffffu - (unsigned)(glo + bi) : 0u;
    clock.tick(NT_P_SCORE);
    // Step s + 1's noise is drawn while the cluster's keys of step s
    // are on their way.
    const unsigned long long win = nt_cluster_argmax(
        ((unsigned long long)bh << 32) | bl, x, s, clock, [&] {
          if constexpr (DRAW) {
            if (s + 1 < steps) draw(s + 1);
          }
        });
    // The cluster's keys of step s are in, so every warp of this CTA
    // has scored it: its noise stage takes step s + 4's row, the key
    // phase of step s + 2 is posted, and under seq eval e + 1's rows
    // load while e runs.
    if (t == 0) {
      if (s + 2 < steps) nt_expect_keys(x, s + 2);
      if (!DRAW && p.stage_noise && s + NT_SCAN_STAGES < steps)
        issue_noise(s + NT_SCAN_STAGES);
      if (RES && k == 0 && e + 1 < evals) issue_eval(e + 1, false);
    }
    const unsigned gh = (unsigned)(win >> 32), gl = (unsigned)win;
    const uint32_t bits = (gh & 0x80000000u) ? (gh & 0x7fffffffu) : ~gh;
    const float best = __uint_as_float(bits);
    const bool valid = gh != 0 && best > NT_NEG_INF / 2 && cur.act;
    updated = -1;
    if (valid && bh == gh && bl == gl) {  // this thread owns the winner
      const size_t cell = (size_t)bi * G + cur.tg;
      p.choices[ai] = glo + bi;
      p.scores[ai] = __fsub_rn(BIAS ? bs : best, bn);
      const float4 u = util[bi];
      util[bi] = make_float4(__fadd_rn(u.x, cur.a.x), __fadd_rn(u.y, cur.a.y),
                             __fadd_rn(u.z, cur.a.z), __fadd_rn(u.w, cur.a.w));
      bwu[bi] = __fadd_rn(bwu[bi], cur.bw);
      ports[bi] = __fadd_rn(ports[bi], -cur.ports);
      jc[bi] = jc[bi] + 1;
      tgc[cell] = tgc[cell] + 1;
      updated = bi;
    } else if (!valid && rank == 0 && t == 0) {
      p.choices[ai] = -1;
      p.scores[ai] = 0.0f;
    }
    if (RES && k == K - 1) {  // the eval's counts back to the caller
      int* gj = gjc(e);
      int* gt = gtgc(e);
      for (int i = t; i < cnt; i += T) {
        gj[i] = jc[i];
        for (int g = 0; g < G; ++g)
          gt[(size_t)i * G + g] = tgc[(size_t)i * G + g];
      }
    }
    // Uniform over the cluster: every CTA reuses or none does.
    reuse = p.cache && k + 1 < K && nt_same_ask(nxt, cur);
    cur = nxt;
    clock.tick(NT_P_WIN);
  }
  if (RES)
    for (int i = t; i < cnt; i += T) {
      gutil()[i] = util[i];
      gbwu()[i] = bwu[i];
      gports()[i] = ports[i];
    }
  if (TIMED && clock.on)
    for (int i = 0; i < NT_P_PARTS; ++i) p.prof[i] = prof_acc[i];
  // Keeps every CTA's shared memory alive until the cluster is done.
  nt_cluster_arrive_wait();
}

// The greedy scan's chain alone in its cluster form, for measuring it:
// K rounds of the scan's warp reduction and key exchange with no
// scoring; each thread's key depends on the last winner, as step k+1 of
// the scan depends on step k's row. Not on the placement path:
// chip_smoke.py times it beside nt_argmax_chain.
__global__ void __launch_bounds__(NT_SCAN_THREADS, 1)
    nt_argmax_chain_cluster_kernel(int K, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = (uint64_t*)smem;
  cg::cluster_group cl = cg::this_cluster();
  const int nc = (int)cl.num_blocks();
  const int rank = (int)cl.block_rank();
  const int W = blockDim.x >> 5;
  const NtExchange x =
      nt_exchange(smem, nt_scan_layout(nc, W, 0, 0, 0, 0, 0, 0, 0).slots,
                  bar + NT_B_KEYS, nc, rank, W);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NT_B_COUNT; ++i) nt_mbar_init(&bar[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < 2 && i < K; ++i) nt_expect_keys(x, i);
  }
  nt_cluster_arrive_wait();
  const int node = rank * blockDim.x + threadIdx.x;
  unsigned win = 0;
  NtClock<false> clock = {false, 0, nullptr};
  for (int k = 0; k < K; ++k) {
    const unsigned hi =
        1u + (((unsigned)node * 2654435761u + win) & 1023u);
    const unsigned long long key = nt_cluster_argmax(
        ((unsigned long long)hi << 32) | (0xffffffffu - (unsigned)node), x, k,
        clock, [] {});
    if (threadIdx.x == 0 && k + 2 < K) nt_expect_keys(x, k + 2);
    win = 0xffffffffu - (unsigned)key;
  }
  if (rank == 0 && threadIdx.x == 0) out[0] = (int)win;
  nt_cluster_arrive_wait();
}

static std::atomic<int> nt_scan_ready[NT_SCAN_DEVICES];

// The scan kernel for a form, timed or not, drawing or reading the
// noise, with K8b's bias (which reads it) or without; over segments
// (``seg``: read or biased, untimed) or one.
static void (*nt_scan_kernel(int resident, bool timed, bool draw, bool bias,
                             bool seg))(const NtScanArgs) {
#define NT_SCAN_FORMS(R, D, B)                                      \
  return timed ? nt_greedy_cluster_kernel<R, true, D, B, false>     \
               : nt_greedy_cluster_kernel<R, false, D, B, false>
  if (seg) {
    if (bias)
      return resident ? nt_greedy_cluster_kernel<true, false, false, true, true>
                      : nt_greedy_cluster_kernel<false, false, false, true,
                                                 true>;
    return resident ? nt_greedy_cluster_kernel<true, false, false, false, true>
                    : nt_greedy_cluster_kernel<false, false, false, false,
                                               true>;
  }
  if (bias) {
    if (resident) NT_SCAN_FORMS(true, false, true);
    NT_SCAN_FORMS(false, false, true);
  }
  if (draw) {
    if (resident) NT_SCAN_FORMS(true, true, false);
    NT_SCAN_FORMS(false, true, false);
  }
  if (resident) NT_SCAN_FORMS(true, false, false);
  NT_SCAN_FORMS(false, false, false);
#undef NT_SCAN_FORMS
}

// The kernels' attributes on the current device, once a device.
static int nt_scan_setup() {
  return nt_once_a_device(nt_scan_ready, [] {
    for (int r = 0; r < 2; ++r) {
      for (int timed = 0; timed < 2; ++timed)
        for (int mode = 0; mode < 3; ++mode) {  // read, drawn, K8b
          const int err = nt_scan_attrs((const void*)nt_scan_kernel(
              r, timed, mode == 1, mode == 2, false));
          if (err) return err;
        }
      for (int bias = 0; bias < 2; ++bias) {  // segments: read, K8b
        const int err = nt_scan_attrs(
            (const void*)nt_scan_kernel(r, false, false, bias, true), true);
        if (err) return err;
      }
    }
    return nt_scan_attrs((const void*)nt_argmax_chain_cluster_kernel);
  });
}

// Checks the plan against ``p`` (its batch, segments and pointers set),
// sets the slice length and launches: p.W segments of p.cps CTAs each
// (``seg``) or one segment over the cluster of ``ctas``.
static int nt_scan_run(NtScanArgs& p, int ctas, int threads, int resident,
                       int draw, bool bias, bool seg, long long smem,
                       void* stream) {
  // Resident under seq, eval e + 1's rows load while eval e reads its
  // own: two buffers, or the copy would overwrite rows still in use.
  if (!nt_scan_shape_ok(ctas, threads) || p.eval_bufs < 0 ||
      p.eval_bufs > 2 || (resident && p.eval_bufs < 1) ||
      (resident && p.seq && p.B > 1 && p.eval_bufs != 2) ||
      (draw && (p.keys == nullptr || p.stage_noise || bias || seg)) ||
      (seg && p.prof != nullptr) || p.W < 1 || p.cps < 1 ||
      p.W * p.cps != ctas || (!seg && p.W != 1))
    return (int)cudaErrorInvalidValue;
  int L = 0;
  for (int s = 0; s < p.W; ++s) {
    const NtScanSeg& sg = p.seg[s];
    if (sg.n < 0 || (!draw && sg.noise == nullptr) ||
        (bias != (sg.pref != nullptr)))
      return (int)cudaErrorInvalidValue;
    const int part = (int)((sg.n + p.cps - 1) / p.cps);
    L = part > L ? part : L;
  }
  p.L = L;
  const NtScanLayout lay =
      nt_scan_layout(ctas, threads / 32, L, p.G, resident, p.stage_noise,
                     p.eval_bufs, p.cache, bias);
  if ((long long)lay.total != smem ||
      lay.total > NT_SCAN_SMEM_MAX - (seg ? NT_SCAN_SEG_SMEM : 0))
    return (int)cudaErrorInvalidValue;
  int err = nt_scan_setup();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = nt_scan_cfg(
      p.seq ? 1 : p.B, ctas, threads, lay.total, (cudaStream_t)stream, attr);
  return (int)cudaLaunchKernelEx(
      &cfg, nt_scan_kernel(resident, p.prof != nullptr, draw, bias, seg), p);
}

// The batch's arguments common to both entries.
static void nt_scan_batch(NtScanArgs& p, int B, int G, int K, float penalty,
                          int seq, int stacked, int stage_noise,
                          int eval_bufs, int cache, const void* ask_res,
                          const void* ask_bw, const void* ask_ports,
                          const void* tg_index, const void* active,
                          const void* job_dh, const void* tg_dh,
                          void* choices, void* scores) {
  p.B = B;
  p.G = G;
  p.K = K;
  p.seq = seq;
  p.stacked = stacked;
  p.stage_noise = stage_noise;
  p.eval_bufs = eval_bufs;
  p.cache = cache;
  p.penalty = penalty;
  p.ask_res = (const float4*)ask_res;
  p.ask_bw = (const float*)ask_bw;
  p.ask_ports = (const float*)ask_ports;
  p.tg_index = (const int*)tg_index;
  p.active = (const unsigned char*)active;
  p.job_dh = (const unsigned char*)job_dh;
  p.tg_dh = (const unsigned char*)tg_dh;
  p.choices = (int*)choices;
  p.scores = (float*)scores;
}

// A segment from its rows' pointers, in NtScanSeg's order.
static NtScanSeg nt_scan_seg(long long lo, long long n,
                             const void* const* q) {
  NtScanSeg sg;
  sg.lo = lo;
  sg.n = n;
  sg.capacity = (const float4*)q[0];
  sg.sched = (const float4*)q[1];
  sg.bw_avail = (const float*)q[2];
  sg.node_ok = (const unsigned char*)q[3];
  sg.util = (float4*)q[4];
  sg.bw_used = (float*)q[5];
  sg.ports_free = (float*)q[6];
  sg.job_count = (int*)q[7];
  sg.tg_count = (int*)q[8];
  sg.feasible = (const unsigned char*)q[9];
  sg.noise = (const float*)q[10];
  sg.pref = (const float*)q[11];
  return sg;
}

// Shapes: capacity/sched [N,4] f32, bw_avail [N] f32, node_ok [N] u8
// (stacked: [B,N,...]); util [B,N,4] f32, bw_used/ports_free [B,N] f32
// (seq: [N,4] and [N], one shared copy); job_count [B,N] i32, tg_count
// [B,N,G] i32 (carried, updated in place); feasible [B,N,G] u8;
// ask_res [B,K,4] f32; ask_bw/ask_ports [B,K] f32; tg_index [B,K] i32;
// active [B,K] u8; job_dh [B] u8; tg_dh [B,G] u8; the noise: with draw
// set, keys [B,2] i64 (its uint32 key words), scale (its maxval),
// draw_total and draw_lo (node i's noise at step k is counter k x
// draw_total + draw_lo + i of the eval's draw), noise unused; else
// noise [B,K,N] f32 (K0's), staged where stage_noise; out choices [B,K]
// i32, scores [B,K] f32. The launch's plan (ops/scan.py ScanPlan): ctas
// a cluster, threads a CTA, resident, draw, stage_noise, eval_bufs,
// cache and the shared memory it computes, which must equal this
// file's layout. prof: null, or NT_P_PARTS i64 that one thread of rank
// 0 sets to the clock cycles of its steps' parts.
int nt_scan_launch(int B, int N, int G, int K, float penalty, int seq,
                   int stacked, int ctas, int threads, int resident,
                   int draw, int stage_noise, int eval_bufs, int cache,
                   long long smem, const void* capacity, const void* sched,
                   const void* bw_avail, const void* node_ok, void* util,
                   void* bw_used, void* ports_free, void* job_count,
                   void* tg_count, const void* feasible, const void* ask_res,
                   const void* ask_bw, const void* ask_ports,
                   const void* tg_index, const void* active,
                   const void* job_dh, const void* tg_dh, const void* keys,
                   float scale, long long draw_total, long long draw_lo,
                   const void* noise, const void* pref, void* choices,
                   void* scores, void* prof, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  NtScanArgs p = {};
  nt_scan_batch(p, B, G, K, penalty, seq, stacked, stage_noise, eval_bufs,
                cache, ask_res, ask_bw, ask_ports, tg_index, active, job_dh,
                tg_dh, choices, scores);
  p.W = 1;
  p.cps = ctas;
  p.scale = scale;
  p.draw_total = draw_total;
  p.draw_lo = draw_lo;
  p.keys = (const long long*)keys;
  p.prof = (long long*)prof;
  const void* rows[NT_SCAN_SEG_PTRS] = {
      capacity, sched, bw_avail, node_ok, util, bw_used, ports_free,
      job_count, tg_count, feasible, noise, pref};
  p.seg[0] = nt_scan_seg(0, N, rows);
  p.N = N;
  return nt_scan_run(p, ctas, threads, resident, draw, pref != nullptr,
                     false, smem, stream);
}

// K10c and K10g-b on the shards of one card: the scan over W <= 16
// segments, cps CTAs each (a cluster of cps x W). seg_dims [W,2] i64
// (global lo, rows) and seg_ptrs [W,12] (capacity, sched, bw_avail,
// node_ok, util, bw_used, ports_free, job_count, tg_count, feasible,
// noise, pref: shapes as nt_greedy_scan's over the segment's rows; the
// noise its window [B,K,n], always read; pref [B,K,n] with ``bias``,
// else null) are host arrays; the asks, job_dh and tg_dh as
// nt_greedy_scan's; choices [B,K] i32 (global node indices) and scores
// [B,K] f32 written. The plan's fields as nt_greedy_scan's (draw off),
// for slices of the longest segment's parts.
NT_API int nt_scan_segments(int B, int G, int K, int W, int cps,
                            float penalty, int seq, int stacked, int bias,
                            int threads, int resident, int stage_noise,
                            int eval_bufs, int cache, long long smem,
                            const long long* seg_dims,
                            const void* const* seg_ptrs, const void* ask_res,
                            const void* ask_bw, const void* ask_ports,
                            const void* tg_index, const void* active,
                            const void* job_dh, const void* tg_dh,
                            void* choices, void* scores, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (W < 1 || W > NT_SCAN_CLUSTER_MAX || cps < 1)
    return (int)cudaErrorInvalidValue;
  NtScanArgs p = {};
  nt_scan_batch(p, B, G, K, penalty, seq, stacked, stage_noise, eval_bufs,
                cache, ask_res, ask_bw, ask_ports, tg_index, active, job_dh,
                tg_dh, choices, scores);
  p.W = W;
  p.cps = cps;
  for (int s = 0; s < W; ++s)
    p.seg[s] = nt_scan_seg(seg_dims[2 * s], seg_dims[2 * s + 1],
                           seg_ptrs + (size_t)s * NT_SCAN_SEG_PTRS);
  return nt_scan_run(p, cps * W, threads, resident, 0, bias != 0, true, smem,
                     stream);
}

// K1's entry: nt_scan_launch without a pref.
NT_API int nt_greedy_scan(int B, int N, int G, int K, float penalty, int seq,
                          int stacked, int ctas, int threads, int resident,
                          int draw, int stage_noise, int eval_bufs, int cache,
                          long long smem, const void* capacity,
                          const void* sched, const void* bw_avail,
                          const void* node_ok, void* util, void* bw_used,
                          void* ports_free, void* job_count, void* tg_count,
                          const void* feasible, const void* ask_res,
                          const void* ask_bw, const void* ask_ports,
                          const void* tg_index, const void* active,
                          const void* job_dh, const void* tg_dh,
                          const void* keys, float scale, long long draw_total,
                          long long draw_lo, const void* noise, void* choices,
                          void* scores, void* prof, void* stream) {
  return nt_scan_launch(B, N, G, K, penalty, seq, stacked, ctas, threads,
                        resident, draw, stage_noise, eval_bufs, cache, smem,
                        capacity, sched, bw_avail, node_ok, util, bw_used,
                        ports_free, job_count, tg_count, feasible, ask_res,
                        ask_bw, ask_ports, tg_index, active, job_dh, tg_dh,
                        keys, scale, draw_total, draw_lo, noise, nullptr,
                        choices, scores, prof, stream);
}

// The clusters of ``ctas`` CTAs of ``threads`` threads and ``smem``
// bytes of shared memory in the given form that the card holds at
// once, written to *clusters (0: the card refuses such a cluster); no
// kernel runs.
NT_API int nt_greedy_occupancy(int ctas, int threads, long long smem,
                               int resident, int* clusters) {
  *clusters = 0;
  if (!nt_scan_shape_ok(ctas, threads) || smem < 0 ||
      smem > NT_SCAN_SMEM_MAX)
    return 0;
  int err = nt_scan_setup();
  if (err) return err;
  nt_cluster_occupancy((const void*)nt_scan_kernel(resident, false, true,
                                                   false, false),
                       ctas, threads, (size_t)smem, clusters);
  return 0;
}

// ctas CTAs of ``threads``, K rounds; out [1] i32 (the last winner).
NT_API int nt_argmax_chain_cluster(int K, int ctas, int threads, void* out,
                                   void* stream) {
  if (K <= 0) return 0;
  if (!nt_scan_shape_ok(ctas, threads)) return (int)cudaErrorInvalidValue;
  int err = nt_scan_setup();
  if (err) return err;
  cudaLaunchAttribute attr[1];
  const size_t smem =
      nt_scan_layout(ctas, threads / 32, 0, 0, 0, 0, 0, 0, 0).total;
  const cudaLaunchConfig_t cfg = nt_scan_cfg(1, ctas, threads, smem,
                                             (cudaStream_t)stream, attr);
  return (int)cudaLaunchKernelEx(&cfg, nt_argmax_chain_cluster_kernel, K,
                                 (int*)out);
}

// The greedy scan's dependent chain alone on one CTA, for measuring
// it: K rounds of a block-wide argmax (warp shuffle, shared memory,
// warp 0, two barriers) over 1024 threads with no node scoring. Each
// round's values depend on the previous round's winner, as step k+1 of
// the scan depends on the row step k chose, so no round can start
// early. Not on the placement path: chip_smoke.py times it beside the
// cluster form (the chain term of the one-SM design).
__global__ void __launch_bounds__(NT_SCAN_THREADS) nt_argmax_chain_kernel(
    int K, int* __restrict__ out) {
  __shared__ float s_best[NT_SCAN_THREADS / 32];
  __shared__ int i_best[NT_SCAN_THREADS / 32];
  __shared__ int s_win;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int win = 0;
  for (int k = 0; k < K; ++k) {
    float bs = (float)(((unsigned)threadIdx.x * 2654435761u + (unsigned)win) &
                       1023u);
    int bi = threadIdx.x;
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (nt_better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_best[warp] = bs;
      i_best[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < n_warps ? s_best[lane] : -INFINITY;
      bi = lane < n_warps ? i_best[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (nt_better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
      if (lane == 0) s_win = bi;
    }
    __syncthreads();
    win = s_win;
  }
  if (threadIdx.x == 0) out[0] = win;
}

// One block of 1024 threads, K rounds; out [1] i32 (the last winner).
NT_API int nt_argmax_chain(int K, void* out, void* stream) {
  if (K <= 0) return 0;
  nt_argmax_chain_kernel<<<1, NT_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      K, (int*)out);
  return (int)cudaGetLastError();
}
