// K2: the uniform distinct-hosts placement — one scoring pass and a
// top-k instead of K argmax steps (ops/binpack.py _uniform_topk_program
// in the JAX package). Every active ask is ask 0 of one task group, so
// the K best-scoring feasible nodes are the K choices. The batch
// layouts are K1's (csrc/greedy_scan.cu): independent evals; sequential
// evals (seq = 1, the pre_resolve scan of config 4's storm) over one
// shared copy of util, bw_used and ports_free; stacked states
// (stacked = 1), a per-eval base. The same kernel is K10d's one-launch
// path (parallel/shard.py): W <= 8 node shards of one card, each a
// segment with its own row pointers and global row offset.
//
// The tie-break noise is drawn where each node's score is formed: node
// i's (global row i) of eval b is K0's value (csrc/common.cuh
// nt_noise_at) of counter i under keys[b], the element the JAX
// package's [N] draw holds there, so no [B, N] noise tensor is written
// or read; the reported score (top - noise at the winner) recomputes
// the winner's value from the same counter.
//
// Each node's (score, index) packs into one 64-bit key (nt_pack,
// csrc/common.cuh): a larger key is a higher score and, on ties, a
// lower index — lax.top_k's order.
//
// Bound on the card: one pass over N nodes (~40 bytes a node), a few
// microseconds of bytes at N = 10,240; under seq the B evals form a
// dependent chain, one selection and one row update an eval. Design:
//
// - The node axis splits over a thread-block cluster of up to 8 CTAs
//   (the caller's CTAs a segment times W), launched with
//   cudaLaunchKernelEx and a cluster-dimension attribute: each CTA
//   scores a contiguous slice (slices at the shards' boundaries; the
//   wrappers give K2 8 CTAs and a shard 8 / W) and selects
//   from it (csrc/topk.cuh). Up to K = 32 each warp's register-list
//   top K goes to every CTA's inbox through distributed shared memory
//   before the one cluster barrier an eval, and warp 0 of every CTA
//   merges the cluster's lists after it; above K = 32 a radix select
//   reduces its histograms over the cluster the same way. The CTA that
//   owns a winner's row updates it (rows are distinct: no atomics) and
//   writes its choice and score; rank 0 writes the padding. Independent
//   and stacked evals take a cluster each (grid = B x 8); under seq one
//   cluster walks the B evals, a __syncthreads after each eval's row
//   updates ordering them before the next eval's scoring, the inboxes
//   double-buffered by eval parity.
// - Under seq each CTA keeps its slice's static rows (capacity, sched,
//   bw_avail, node_ok: 37 B a node) and the shared carried rows (util,
//   bw_used, ports_free: 24 B) in shared memory, loaded once by TMA
//   bulk copies (cp.async.bulk on an mbarrier) and written back once
//   after the last eval; warp 1 loads each eval's own rows (feasible,
//   job_count, tg_count: 4 + 5 G B a node) into one of two buffers
//   while the eval before runs. Where a slice's rows do not fit in
//   shared memory (89 B a node at G = 2), the same kernel reads them
//   from global memory instead (the layout nt_topk_layout computes).
// - No key buffer of N entries exists: the register lists hold K keys
//   a thread, the radix select at most 8 keys a thread in registers.
#include <atomic>

#include "topk.cuh"

// One segment of the node axis: a shard's rows (the whole axis for
// K2), starting at global row lo; row pointers as nt_node_score takes
// them, not yet offset to the eval.
struct NtSeg {
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
};
#define NT_SEG_PTRS 10

struct NtTopkArgs {
  int B, G, K, W, cps, n_total, seq, stacked, resident, L;
  float penalty, scale;
  const long long* keys;
  const float4* ask_res;
  const float* ask_bw;
  const float* ask_ports;
  const int* tg_index;
  const unsigned char* active;
  const unsigned char* job_dh;
  const unsigned char* tg_dh;
  int* choices;
  float* scores;
  NtSeg seg[NT_TOPK_CLUSTER];
};

// Resident rows: the static and shared carried rows, then each eval's
// own rows in two buffers.
enum { NT_CAP, NT_SCHED, NT_BWA, NT_OK, NT_UTIL, NT_BWU, NT_PORTS, NT_ROWS };
enum { NT_FEAS, NT_JC, NT_TGC, NT_EROWS };

// Byte offsets in a CTA's dynamic shared memory: the two mbarriers,
// NtTopkShared, then by eval parity the inboxes of the cluster's warps'
// lists (register lists) or this CTA's compacted keys (radix select,
// with the gathered selection after them), and with ``resident`` the
// rows (each region 16 bytes longer than its rows, so a copy keeps its
// source's alignment within 16 bytes).
struct NtLayout {
  size_t inbox, mine, sel, rows[NT_ROWS], erows[2][NT_EROWS], total;
};

__host__ __device__ inline NtLayout nt_topk_layout(int km, int K, int nc,
                                                   int L, int G,
                                                   int resident) {
  NtLayout o = {};
  size_t at = 16 + nt_r16(sizeof(NtTopkShared));
  o.inbox = at;
  at += km ? nt_r16((size_t)16 * nc * NT_TOPK_WARPS * K) : 0;
  o.mine = at;
  at += km ? 0 : nt_r16((size_t)16 * K);
  o.sel = at;
  at += km ? 0 : nt_r16((size_t)8 * K);
  if (resident) {
    const size_t per[NT_ROWS] = {16, 16, 4, 1, 16, 4, 4};
    for (int r = 0; r < NT_ROWS; ++r) {
      o.rows[r] = at;
      at += nt_r16(per[r] * L) + 16;
    }
    const size_t eper[NT_EROWS] = {(size_t)G, 4, (size_t)4 * G};
    for (int x = 0; x < 2; ++x)
      for (int r = 0; r < NT_EROWS; ++r) {
        o.erows[x][r] = at;
        at += nt_r16(eper[r] * L) + 16;
      }
  }
  o.total = at;
  return o;
}

// The 16-byte-aligned body of [src, src + len): bytes before it and
// its length (a multiple of 16, maybe 0).
__device__ __forceinline__ void nt_body(const void* src, size_t len,
                                        size_t* head, size_t* body) {
  const uintptr_t a = (uintptr_t)src, e = a + len;
  const uintptr_t b0 = (a + 15) & ~(uintptr_t)15, b1 = e & ~(uintptr_t)15;
  if (b1 <= b0) {
    *head = len;
    *body = 0;
  } else {
    *head = b0 - a;
    *body = b1 - b0;
  }
}

struct NtCopy {
  unsigned char* region;
  const void* src;
  size_t len;
};

// Stage the copies (M <= 32) into shared memory on ``bar``, by the 32
// lanes of one warp: lane m issues copy m's body as one bulk copy,
// after lane 0 has posted the bodies' bytes on the barrier; the lanes
// copy the unaligned heads and tails. The data is complete once the
// barrier's phase completes and a __syncthreads has passed.
template <int M>
__device__ __forceinline__ void nt_stage_warp(const NtCopy (&c)[M],
                                              uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  size_t head = 0, body = 0;
  if (lane < M) nt_body(c[lane].src, c[lane].len, &head, &body);
  unsigned tx = (unsigned)body;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) tx += __shfl_xor_sync(0xffffffffu, tx, o);
  if (lane == 0) {
    // The buffers were last read through the generic proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            nt_saddr(bar)),
        "r"(tx)
        : "memory");
  }
  __syncwarp();
  if (lane < M && body) {
    const unsigned char* src = (const unsigned char*)c[lane].src;
    unsigned char* dst = nt_staged(c[lane].region, src);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(nt_saddr(dst + head)),
        "l"(src + head), "r"((unsigned)body), "r"(nt_saddr(bar))
        : "memory");
  }
  for (int m = 0; m < M; ++m) {
    nt_body(c[m].src, c[m].len, &head, &body);
    const size_t tail = c[m].len - head - body;
    const unsigned char* src = (const unsigned char*)c[m].src;
    unsigned char* dst = nt_staged(c[m].region, src);
    for (size_t i = lane; i < head + tail; i += 32) {
      const size_t at = i < head ? i : head + body + (i - head);
      dst[at] = src[at];
    }
  }
}

// One eval's key of node i of this CTA's slice, its noise drawn from
// the eval's key words (k0, k1) at counter gbase + i; the pointers are
// the eval's views of the slice (shared or global memory).
struct NtScore {
  const float4* cap;
  const float4* sched;
  const float* bw_avail;
  const unsigned char* ok;
  const float4* util;
  const float* bw_used;
  const float* ports;
  const int* jc;
  const int* tgc;
  const unsigned char* feas;
  float4 a;
  float abw, aports, penalty, scale;
  uint32_t k0, k1;
  int G, tg, gbase;
  bool jdh, tdh;

  __device__ __forceinline__ unsigned long long operator()(int i) const {
    const float noise = nt_noise_at(
        k0, k1, (unsigned long long)(gbase + i), 0.0f, scale);
    return nt_pack(nt_node_score(i, G, tg, jdh, tdh, penalty, cap, sched,
                                 bw_avail, ok, util, bw_used, ports, jc, tgc,
                                 feas, a, abw, aports, noise),
                   gbase + i);
  }
};

// Position t of one eval's top K: the choice, score and row update, by
// the CTA owning the key's row (no other CTA writes the row); padding
// (key 0) by rank 0. Pointers are the eval's, offset to this CTA's
// slice; util, bwu, ports, jc, tgc its views (shared or global
// memory), jc_out and tgc_out the counts in global memory; the winner's
// noise drawn again from the eval's key words.
struct NtFinish {
  int* choices;
  float* scores;
  const unsigned char* active;
  float4* util;
  float* bwu;
  float* ports;
  const int* jc;
  const int* tgc;
  int* jc_out;
  int* tgc_out;
  float4 a;
  float abw, aports, scale;
  uint32_t k0, k1;
  int G, tg, gbase, cnt;
  bool rank0;

  __device__ __forceinline__ void operator()(int t,
                                             unsigned long long key) const {
    if (key == 0ull) {
      if (rank0) {
        choices[t] = -1;
        scores[t] = 0.0f;
      }
      return;
    }
    const int i = nt_unpack_index(key) - gbase;
    if (i < 0 || i >= cnt) return;  // another CTA's row
    const float sv = nt_unpack_score(key);
    if (!(sv > NT_NEG_INF / 2) || active[t] == 0) {
      choices[t] = -1;
      scores[t] = 0.0f;
      return;
    }
    choices[t] = gbase + i;
    const float noise =
        nt_noise_at(k0, k1, (unsigned long long)(gbase + i), 0.0f, scale);
    scores[t] = __fsub_rn(sv, noise);
    const float4 u = util[i];
    util[i] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                          __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
    bwu[i] = __fadd_rn(bwu[i], abw);
    ports[i] = __fadd_rn(ports[i], -aports);
    jc_out[i] = jc[i] + 1;
    tgc_out[(size_t)i * G + tg] = tgc[(size_t)i * G + tg] + 1;
  }
};

// The slice's rows of eval b in global memory (feasible, job_count,
// tg_count), and their copies into the eval's staging buffers.
__device__ __forceinline__ void nt_eval_rows(const NtSeg& sg, int lo_l, int G,
                                             int b, const void* (&g)[NT_EROWS]) {
  const size_t ns = (size_t)sg.n;
  g[NT_FEAS] = sg.feasible + ((size_t)b * ns + lo_l) * G;
  g[NT_JC] = sg.job_count + (size_t)b * ns + lo_l;
  g[NT_TGC] = sg.tg_count + ((size_t)b * ns + lo_l) * G;
}

__device__ __forceinline__ void nt_eval_copies(const NtSeg& sg, int lo_l,
                                               int cnt, int G, int b,
                                               unsigned char* smem,
                                               const NtLayout& lay,
                                               NtCopy* c) {
  const void* g[NT_EROWS];
  nt_eval_rows(sg, lo_l, G, b, g);
  const size_t per[NT_EROWS] = {(size_t)G, 4, (size_t)4 * G};
  for (int r = 0; r < NT_EROWS; ++r)
    c[r] = NtCopy{smem + lay.erows[b & 1][r], g[r], per[r] * cnt};
}

// KM: the register lists' length (8 or 32), or 0 for the radix select.
template <int KM>
__global__ void __launch_bounds__(NT_TOPK_THREADS, 1)
    nt_topk_cluster_kernel(const __grid_constant__ NtTopkArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = (uint64_t*)smem;
  NtTopkShared* sh = (NtTopkShared*)(smem + 16);
  const int nc = nt_group_size<true>();
  const int rank = (int)cg::this_cluster().block_rank();
  const NtLayout lay = nt_topk_layout(KM, p.K, nc, p.L, p.G, p.resident);
  unsigned long long* inbox = (unsigned long long*)(smem + lay.inbox);
  unsigned long long* mine = (unsigned long long*)(smem + lay.mine);
  unsigned long long* sel = (unsigned long long*)(smem + lay.sel);
  const int G = p.G, K = p.K;
  const int k_eff = K < p.n_total ? K : p.n_total;

  // This CTA's slice: part j of shard s (16-row multiples; a slice may
  // be empty, and its CTA still meets every cluster barrier).
  const int s = rank / p.cps, j = rank - s * p.cps;
  NtSeg sg = {};
  int lo_l = 0, cnt = 0;
  if (s < p.W) {
    sg = p.seg[s];
    const int part = (int)nt_r16((size_t)((sg.n + p.cps - 1) / p.cps));
    lo_l = min((int)sg.n, j * part);
    cnt = min((int)sg.n, lo_l + part) - lo_l;
  }
  const size_t ns = (size_t)sg.n;
  const int gbase = (int)(sg.lo + lo_l);
  const bool res = p.resident != 0;  // only under seq
  const int first = p.seq ? 0 : (int)(blockIdx.x / nc);
  const int last = p.seq ? p.B : first + 1;

  if (res) {
    if (threadIdx.x == 0) {
      nt_mbar_init(&bar[0]);
      nt_mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    // The static and carried rows and eval 0's, in one barrier phase.
    NtCopy c[NT_ROWS + NT_EROWS] = {
        {smem + lay.rows[NT_CAP], sg.capacity + lo_l, (size_t)16 * cnt},
        {smem + lay.rows[NT_SCHED], sg.sched + lo_l, (size_t)16 * cnt},
        {smem + lay.rows[NT_BWA], sg.bw_avail + lo_l, (size_t)4 * cnt},
        {smem + lay.rows[NT_OK], sg.node_ok + lo_l, (size_t)cnt},
        {smem + lay.rows[NT_UTIL], sg.util + lo_l, (size_t)16 * cnt},
        {smem + lay.rows[NT_BWU], sg.bw_used + lo_l, (size_t)4 * cnt},
        {smem + lay.rows[NT_PORTS], sg.ports_free + lo_l, (size_t)4 * cnt}};
    nt_eval_copies(sg, lo_l, cnt, G, 0, smem, lay, c + NT_ROWS);
    if ((threadIdx.x >> 5) == 1) nt_stage_warp(c, &bar[0]);
  }
  // Warp 1 stages eval b + 1's rows while eval b runs (its buffer's last
  // reader, eval b - 1, is done): in the register-list path after its
  // lists are out, so the copy overlaps the cluster barrier.
  auto stage_next = [&](int b) {
    if (res && b + 1 < last && (threadIdx.x >> 5) == 1) {
      NtCopy c[NT_EROWS];
      nt_eval_copies(sg, lo_l, cnt, G, b + 1, smem, lay, c);
      nt_stage_warp(c, &bar[(b + 1) & 1]);
    }
  };

  for (int b = first; b < last; ++b) {
    const int par = b & 1;
    const size_t sb = p.stacked ? b : 0, cb = p.seq ? 0 : b;
    const float4* cap = sg.capacity + sb * ns + lo_l;
    const float4* sched = sg.sched + sb * ns + lo_l;
    const float* bwa = sg.bw_avail + sb * ns + lo_l;
    const unsigned char* ok = sg.node_ok + sb * ns + lo_l;
    float4* util = sg.util + cb * ns + lo_l;
    float* bwu = sg.bw_used + cb * ns + lo_l;
    float* ports = sg.ports_free + cb * ns + lo_l;
    const void* g[NT_EROWS];
    nt_eval_rows(sg, lo_l, G, b, g);
    int* jc_out = (int*)g[NT_JC];
    int* tgc_out = (int*)g[NT_TGC];
    const unsigned char* feas = (const unsigned char*)g[NT_FEAS];
    const int* jc = jc_out;
    const int* tgc = tgc_out;
    if (res) {
      nt_mbar_wait(&bar[par], (unsigned)((b >> 1) & 1));
      __syncthreads();
      cap = nt_staged(smem + lay.rows[NT_CAP], cap);
      sched = nt_staged(smem + lay.rows[NT_SCHED], sched);
      bwa = nt_staged(smem + lay.rows[NT_BWA], bwa);
      ok = nt_staged(smem + lay.rows[NT_OK], ok);
      util = nt_staged(smem + lay.rows[NT_UTIL], util);
      bwu = nt_staged(smem + lay.rows[NT_BWU], bwu);
      ports = nt_staged(smem + lay.rows[NT_PORTS], ports);
      feas = nt_staged(smem + lay.erows[par][NT_FEAS], feas);
      jc = nt_staged(smem + lay.erows[par][NT_JC], jc);
      tgc = nt_staged(smem + lay.erows[par][NT_TGC], tgc);
    }
    const size_t a0 = (size_t)b * K;
    const int tg = p.tg_index[a0];
    const uint32_t k0 = (uint32_t)p.keys[2 * (size_t)b];
    const uint32_t k1 = (uint32_t)p.keys[2 * (size_t)b + 1];
    const NtScore sc{cap, sched, bwa, ok, util, bwu, ports, jc, tgc, feas,
                     p.ask_res[a0], p.ask_bw[a0], p.ask_ports[a0],
                     p.penalty, p.scale, k0, k1, G, tg, gbase,
                     p.job_dh[b] != 0, p.tg_dh[(size_t)b * G + tg] != 0};
    const NtFinish finish{p.choices + a0, p.scores + a0, p.active + a0,
                          util, bwu, ports, jc, tgc, jc_out, tgc_out,
                          sc.a, sc.abw, sc.aports, p.scale, k0, k1, G, tg,
                          gbase, cnt, rank == 0};
    if constexpr (KM > 0) {
      // Each warp's list goes to every CTA's inbox before the cluster
      // barrier; after it, warp 0 merges the cluster's nc x 8 lists.
      unsigned long long l[KM];
      nt_thread_list<KM>(sc, cnt, l);
      nt_warp_merge<KM>(l, 32);
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      unsigned long long* box = inbox + (size_t)par * nc * NT_TOPK_WARPS * K;
      if (lane < K) {
        const unsigned long long x = nt_list_at<KM>(l, lane);
        const int at = (rank * NT_TOPK_WARPS + warp) * K + lane;
        for (int r = 0; r < nc; ++r) nt_peer<true>(box, r)[at] = x;
      }
      stage_next(b);
      nt_group_sync<true>();
      if (warp == 0) {
        const int lists = nc * NT_TOPK_WARPS;
        const bool has = 2 * lane < lists;
        unsigned long long x[KM], y[KM];
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          x[j] = has && j < K ? box[(2 * lane) * K + j] : 0ull;
          y[j] = has && j < K ? box[(2 * lane + 1) * K + j] : 0ull;
        }
        nt_merge_top<KM>(x, y);
        nt_warp_merge<KM>(x, 32);  // every lane ends with the eval's top K
        if (lane < K) finish(lane, nt_list_at<KM>(x, lane));
      }
    } else if (k_eff > 0) {
      stage_next(b);
      nt_radix_select<true, NT_TOPK_RADIX_REGS>(
          sc, cnt, k_eff, sh, mine + (size_t)par * K, sh->pub[par], sel);
      nt_rank_own(sel, k_eff, sh, finish);
      if (rank == 0)
        for (int t = k_eff + threadIdx.x; t < K; t += NT_TOPK_THREADS)
          finish(t, 0ull);
    } else {
      stage_next(b);
      if (rank == 0)
        for (int t = threadIdx.x; t < K; t += NT_TOPK_THREADS) finish(t, 0ull);
    }
    // The next eval (seq) scores the rows updated here.
    __syncthreads();
  }
  if (res) {
    const float4* su = nt_staged(smem + lay.rows[NT_UTIL], sg.util + lo_l);
    const float* sbw = nt_staged(smem + lay.rows[NT_BWU], sg.bw_used + lo_l);
    const float* sp = nt_staged(smem + lay.rows[NT_PORTS], sg.ports_free + lo_l);
    for (int i = threadIdx.x; i < cnt; i += NT_TOPK_THREADS) {
      sg.util[lo_l + i] = su[i];
      sg.bw_used[lo_l + i] = sbw[i];
      sg.ports_free[lo_l + i] = sp[i];
    }
  }
  // Peers may still read this CTA's candidate lists.
  nt_group_sync<true>();
}

// Shared-memory bytes a CTA may take (227 KB on sm_90).
#define NT_TOPK_SMEM_MAX (227 * 1024)

// Launches p over nclusters clusters of ctas CTAs; with ``occupancy``
// set, launches nothing and writes the clusters the card holds at once.
template <int KM>
static int nt_topk_go(const NtTopkArgs& p, int nclusters, int ctas,
                      size_t smem, cudaStream_t stream, int* occupancy) {
  // The largest dynamic shared memory for which a cluster of each size
  // was found to fit (cudaOccupancyMaxActiveClusters > 0).
  static std::atomic<size_t> fits[NT_TOPK_CLUSTER + 1];
  void (*fn)(const NtTopkArgs) = nt_topk_cluster_kernel<KM>;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(nclusters * ctas), 1, 1);
  cfg.blockDim = dim3(NT_TOPK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (occupancy) {
    *occupancy = 0;
    return (int)cudaOccupancyMaxActiveClusters(occupancy, (const void*)fn, &cfg);
  }
  if (smem + 1 > fits[ctas].load()) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters <= 0) return (int)cudaErrorLaunchOutOfResources;
    size_t seen = fits[ctas].load();
    while (seen < smem + 1 && !fits[ctas].compare_exchange_weak(seen, smem + 1)) {
    }
  }
  return (int)cudaLaunchKernelEx(&cfg, fn, p);
}

// The slices' length, the rows' residency and the shared memory of p's
// launch (p's segments and cps set), then the launch (nt_topk_go).
static int nt_topk_plan(NtTopkArgs& p, int resident, cudaStream_t st,
                        int* occupancy) {
  const int ctas = p.cps * p.W;
  int L = 0;
  for (int s = 0; s < p.W; ++s) {
    const int part =
        (int)nt_r16((size_t)((p.seg[s].n + p.cps - 1) / p.cps));
    L = part > L ? part : L;
  }
  p.L = L;
  const int km = nt_topk_km(p.K);
  p.resident = 0;
  if (resident && p.seq &&
      nt_topk_layout(km, p.K, ctas, L, p.G, 1).total <= NT_TOPK_SMEM_MAX)
    p.resident = 1;
  const size_t smem = nt_topk_layout(km, p.K, ctas, L, p.G, p.resident).total;
  if (smem > NT_TOPK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int nclusters = p.seq ? 1 : p.B;
  if (km == 8) return nt_topk_go<8>(p, nclusters, ctas, smem, st, occupancy);
  if (km == 32) return nt_topk_go<32>(p, nclusters, ctas, smem, st, occupancy);
  return nt_topk_go<0>(p, nclusters, ctas, smem, st, occupancy);
}

// K2 over W segments of the node axis (W = 1 for K2 itself; K10d's
// one-launch path: W <= 8 shards of one card). seg_dims [W,2] i64 (lo,
// rows) and seg_ptrs [W,10] (capacity, sched, bw_avail, node_ok, util,
// bw_used, ports_free, job_count, tg_count, feasible: shapes as
// nt_greedy_scan's over the segment's rows) are host arrays; the asks
// [B,K] (ask 0 read), job_dh [B], tg_dh [B,G]; keys [B,2] i64 (the
// noise's uint32 key words) and scale (its maxval: node i's noise is
// counter i of the eval's draw); choices [B,K] i32 and scores [B,K] f32
// written. cps: CTAs a segment (a cluster of cps x W <= 8 CTAs);
// resident: keep seq's rows in shared memory where they fit.
NT_API int nt_uniform_topk(int B, int G, int K, int W, int n_total,
                           float penalty, int seq, int stacked, int cps,
                           int resident, const long long* seg_dims,
                           const void* const* seg_ptrs, const void* ask_res,
                           const void* ask_bw, const void* ask_ports,
                           const void* tg_index, const void* active,
                           const void* job_dh, const void* tg_dh,
                           const void* keys, float scale, void* choices,
                           void* scores, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (W < 1 || cps < 1 || cps * W > NT_TOPK_CLUSTER)
    return (int)cudaErrorInvalidValue;
  NtTopkArgs p = {};
  p.B = B;
  p.G = G;
  p.K = K;
  p.W = W;
  p.cps = cps;
  p.n_total = n_total;
  p.seq = seq;
  p.stacked = stacked;
  p.penalty = penalty;
  p.scale = scale;
  p.keys = (const long long*)keys;
  p.ask_res = (const float4*)ask_res;
  p.ask_bw = (const float*)ask_bw;
  p.ask_ports = (const float*)ask_ports;
  p.tg_index = (const int*)tg_index;
  p.active = (const unsigned char*)active;
  p.job_dh = (const unsigned char*)job_dh;
  p.tg_dh = (const unsigned char*)tg_dh;
  p.choices = (int*)choices;
  p.scores = (float*)scores;
  for (int s = 0; s < W; ++s) {
    NtSeg& sg = p.seg[s];
    const void* const* q = seg_ptrs + (size_t)s * NT_SEG_PTRS;
    sg.lo = seg_dims[2 * s];
    sg.n = seg_dims[2 * s + 1];
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
  }
  return nt_topk_plan(p, resident, (cudaStream_t)stream, nullptr);
}

// The clusters the card holds at once for nt_uniform_topk's launch over
// one segment of n rows with these B, G, K, seq and cps (rows resident
// where they fit), written to *clusters; no kernel runs.
NT_API int nt_uniform_topk_occupancy(int B, int G, int K, int n, int seq,
                                     int cps, int* clusters) {
  if (B <= 0 || K <= 0 || cps < 1 || cps > NT_TOPK_CLUSTER)
    return (int)cudaErrorInvalidValue;
  NtTopkArgs p = {};
  p.B = B;
  p.G = G;
  p.K = K;
  p.W = 1;
  p.cps = cps;
  p.n_total = n;
  p.seq = seq;
  p.seg[0].n = n;
  return nt_topk_plan(p, 1, nullptr, clusters);
}
