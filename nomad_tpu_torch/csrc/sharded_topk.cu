// K10d: the uniform distinct-hosts placement over node shards (the
// uniform dispatch, ops/binpack.py _uniform_topk_program, over a
// node-sharded base in the JAX package: GSPMD runs K2's scoring pass
// node-local and gathers the keys for its top_k), independent and
// under pre_resolve.
//
// Shards of one card, W <= 8, take one launch a call: K2's cluster
// kernel (csrc/uniform_topk.cu) with the CTAs' slices at the shards'
// boundaries. This file is the per-shard path, for shards on distinct
// cards or W > 8: two kernels, W + 1 launches an eval under seq (one
// layout-wide launch of each for independent evals):
//
// 1. nt_shard_topk, once per shard on the shard's device. Prologue
//    (seq: the previous eval's; independent: the final pass): the
//    merged winners (win[], global indices or -1) update their rows of
//    the carry on the shard that owns them; the rows are distinct, so
//    no atomics. Then K2's selection on the slice (csrc/topk.cuh: every
//    local node's (score, GLOBAL index) key, register lists up to K =
//    32, a radix select above): the slice's top K keys (0 past its N)
//    and their scores without the noise (the noise window is the
//    shard's) are the shard's candidates.
// 2. nt_shard_merge, on the combining device: the same selection over
//    the W x K candidates; the first min(K, N_total) are K2's choices
//    in K2's order: higher score first, lower global index on ties;
//    surplus and inactive asks -1. The global top K lies in the union
//    of the shards' top K; each winner finds its candidate slot by a
//    binary search of the sorted winners.
//
// The choices and scores are K2's bit for bit, for the reasons K10c's
// are K1's (csrc/sharded_scan.cu).
//
// Bound on the card: one scoring pass over the slice and its selection,
// then a selection of W x K keys; a few launches of a few microseconds
// each, issued from the host.
#include "topk.cuh"

// Shared memory of a single-CTA selection: NtTopkShared, the warps'
// lists (register-list selection) or this CTA's compacted keys (radix),
// the selected keys, and the merge's candidate slots.
struct NtShardLayout {
  size_t wl, mine, top, slot, total;
};

static __host__ __device__ inline NtShardLayout nt_shard_layout(int km, int K,
                                                                int k_pad) {
  NtShardLayout o;
  size_t at = nt_r16(sizeof(NtTopkShared));
  o.wl = at;
  at += km ? nt_r16((size_t)8 * NT_TOPK_WARPS * K) : 0;
  o.mine = at;
  at += km ? 0 : nt_r16((size_t)16 * K);
  o.top = at;
  at += nt_r16((size_t)8 * (km ? K : k_pad));
  o.slot = at;
  at += nt_r16((size_t)4 * K);
  o.total = at;
  return o;
}

// This CTA's top K of key(0..count) (k_eff = min(K, real keys)) into
// the layout's top[], descending and 0-padded. Closes with a barrier.
template <int KM, class KeyFn>
__device__ __forceinline__ unsigned long long* nt_select_alone(
    const KeyFn& key, int count, int K, int k_eff, int k_pad,
    unsigned char* smem, const NtShardLayout& lay) {
  NtTopkShared* sh = (NtTopkShared*)smem;
  unsigned long long* top = (unsigned long long*)(smem + lay.top);
  if constexpr (KM > 0) {
    nt_cta_topk_small<KM>(key, count, K,
                          (unsigned long long*)(smem + lay.wl), top);
  } else if (k_eff > 0) {
    nt_radix_topk<false, NT_TOPK_RADIX_REGS>(key, count, k_eff, k_pad, sh,
                         (unsigned long long*)(smem + lay.mine), sh->pub[0],
                         top);
  } else {
    for (int t = threadIdx.x; t < k_pad; t += NT_TOPK_THREADS) top[t] = 0ull;
    __syncthreads();
  }
  return top;
}

struct NtShardScore {
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
  const float* noise;
  float4 a;
  float abw, aports, penalty;
  int G, tg, lo;
  bool jdh, tdh;

  __device__ __forceinline__ unsigned long long operator()(int n) const {
    return nt_pack(nt_node_score(n, G, tg, jdh, tdh, penalty, cap, sched,
                                 bw_avail, ok, util, bw_used, ports, jc, tgc,
                                 feas, a, abw, aports, noise[n]),
                   lo + n);
  }
};

template <int KM>
__global__ void __launch_bounds__(NT_TOPK_THREADS, 1)
nt_shard_topk_kernel(
    int B, int N, int G, int K, int lo, int k_pad, float penalty, int seq,
    int stacked, int e_seq, int pe_seq, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok, float4* util, float* bw_used,
    float* ports_free, int* job_count, int* tg_count,
    const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ job_dh,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, const int* __restrict__ win,
    unsigned long long* __restrict__ part_key,
    float* __restrict__ part_score) {
  extern __shared__ __align__(16) unsigned char s_topk[];
  // Independent: e_seq / pe_seq >= 0 only say "score" / "apply", and
  // block b does both for eval b.
  const int e = seq ? e_seq : (e_seq >= 0 ? (int)blockIdx.x : -1);
  const int pe = seq ? pe_seq : (pe_seq >= 0 ? (int)blockIdx.x : -1);
  if (pe >= 0) {
    const size_t cb = seq ? 0 : pe;
    const float4 a = ask_res[(size_t)pe * K];
    const float abw = ask_bw[(size_t)pe * K];
    const float aports = ask_ports[(size_t)pe * K];
    const int tg = tg_index[(size_t)pe * K];
    for (int t = threadIdx.x; t < K; t += blockDim.x) {
      const int r = win[(size_t)pe * K + t] - lo;
      if (r < 0 || r >= N) continue;  // -1, or another shard's row
      float4* u = util + cb * N + r;
      *u = make_float4(__fadd_rn(u->x, a.x), __fadd_rn(u->y, a.y),
                       __fadd_rn(u->z, a.z), __fadd_rn(u->w, a.w));
      bw_used[cb * N + r] = __fadd_rn(bw_used[cb * N + r], abw);
      ports_free[cb * N + r] = __fadd_rn(ports_free[cb * N + r], -aports);
      job_count[(size_t)pe * N + r] += 1;
      tg_count[((size_t)pe * N + r) * G + tg] += 1;
    }
  }
  if (e < 0) return;
  __syncthreads();

  const size_t cb = seq ? 0 : e;
  const size_t sb = stacked ? e : 0;  // static rows: per eval or shared
  const int tg = tg_index[(size_t)e * K];
  const float* nz = noise + (size_t)e * N;
  const NtShardScore sc{capacity + sb * N, sched + sb * N, bw_avail + sb * N,
                        node_ok + sb * N, util + cb * N, bw_used + cb * N,
                        ports_free + cb * N, job_count + (size_t)e * N,
                        tg_count + (size_t)e * N * G,
                        feasible + (size_t)e * N * G, nz,
                        ask_res[(size_t)e * K], ask_bw[(size_t)e * K],
                        ask_ports[(size_t)e * K], penalty, G, tg, lo,
                        job_dh[e] != 0, tg_dh[(size_t)e * G + tg] != 0};
  const NtShardLayout lay = nt_shard_layout(KM, K, k_pad);
  const unsigned long long* top = nt_select_alone<KM>(
      sc, N, K, K < N ? K : N, k_pad, s_topk, lay);
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    const unsigned long long key = top[t];
    part_key[(size_t)e * K + t] = key;
    part_score[(size_t)e * K + t] =
        key != 0ull ? __fsub_rn(nt_unpack_score(key),
                                nz[nt_unpack_index(key) - lo])
                    : 0.0f;
  }
}

// The W x K candidates of eval e: part_key [W,B,K] in shard order.
struct NtCandKey {
  const unsigned long long* part_key;
  int B, K, e;

  __device__ __forceinline__ unsigned long long operator()(int i) const {
    const int s = i / K;
    return part_key[((size_t)s * B + e) * K + (i - s * K)];
  }
};

template <int KM>
__global__ void __launch_bounds__(NT_TOPK_THREADS, 1)
nt_shard_merge_kernel(int W, int B, int K, int n_total, int k_pad, int seq,
                      int e_seq, const unsigned long long* __restrict__ part_key,
                      const float* __restrict__ part_score,
                      const unsigned char* __restrict__ active,
                      int* __restrict__ choices, float* __restrict__ scores,
                      int* __restrict__ win) {
  extern __shared__ __align__(16) unsigned char s_merge[];
  const int e = seq ? e_seq : blockIdx.x;
  const int m = W * K;
  const int k_eff = K < n_total ? K : n_total;
  const NtCandKey key{part_key, B, K, e};
  const NtShardLayout lay = nt_shard_layout(KM, K, k_pad);
  const unsigned long long* top =
      nt_select_alone<KM>(key, m, K, k_eff, k_pad, s_merge, lay);
  int* slot = (int*)(s_merge + lay.slot);
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const unsigned long long x = key(i);
    if (x == 0ull) continue;
    const int t = nt_find_desc(top, k_eff, x);
    if (t >= 0) slot[t] = i;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    bool valid = false;
    int idx = -1;
    float sc = 0.0f;
    if (t < k_eff) {
      const unsigned long long x = top[t];
      valid = x != 0ull && nt_unpack_score(x) > NT_NEG_INF / 2 &&
              active[(size_t)e * K + t] != 0;
      if (valid) {
        const int s = slot[t] / K, ts = slot[t] - s * K;
        idx = nt_unpack_index(x);
        sc = part_score[((size_t)s * B + e) * K + ts];
      }
    }
    choices[(size_t)e * K + t] = valid ? idx : -1;
    scores[(size_t)e * K + t] = sc;
    win[(size_t)e * K + t] = valid ? idx : -1;
  }
}

#define NT_SHARD_SMEM_MAX (227 * 1024)

static int nt_smem_attr(const void* fn, size_t smem) {
  if (smem > NT_SHARD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

static int nt_pow2(int K) {
  int k_pad = 1;
  while (k_pad < K) k_pad <<= 1;
  return k_pad;
}

// One shard's pass: apply eval pe's winners (pe >= 0), then score and
// select eval e (e >= 0). Shapes as nt_shard_step (csrc/sharded_scan.cu)
// except noise [B,N] f32 (the shard's window); win [B,K] i32; part_key
// [B,K] u64 and part_score [B,K] f32 out (this shard's candidates).
NT_API int nt_shard_topk(int B, int N, int G, int K, int lo, float penalty,
                         int seq, int stacked, int e, int pe,
                         const void* capacity, const void* sched,
                         const void* bw_avail, const void* node_ok,
                         void* util, void* bw_used, void* ports_free,
                         void* job_count, void* tg_count,
                         const void* feasible, const void* ask_res,
                         const void* ask_bw, const void* ask_ports,
                         const void* tg_index, const void* job_dh,
                         const void* tg_dh, const void* noise,
                         const void* win, void* part_key, void* part_score,
                         void* stream) {
  if (B <= 0 || K <= 0 || N <= 0) return 0;
  const int km = nt_topk_km(K), k_pad = nt_pow2(K);
  const size_t smem = nt_shard_layout(km, K, k_pad).total;
  auto fn = &nt_shard_topk_kernel<0>;
  if (km == 8) fn = &nt_shard_topk_kernel<8>;
  if (km == 32) fn = &nt_shard_topk_kernel<32>;
  const int err = nt_smem_attr((const void*)fn, smem);
  if (err) return err;
  fn<<<seq ? 1 : B, NT_TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      B, N, G, K, lo, k_pad, penalty, seq, stacked, e, pe,
      (const float4*)capacity, (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (float4*)util, (float*)bw_used,
      (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)job_dh, (const unsigned char*)tg_dh,
      (const float*)noise, (const int*)win, (unsigned long long*)part_key,
      (float*)part_score);
  return (int)cudaGetLastError();
}

// Merge of eval e's (seq) or every eval's W x K candidates: part_key
// [W,B,K] u64 and part_score [W,B,K] f32 in shard order; active [B,K]
// u8; n_total the global node count; choices [B,K] i32, scores [B,K]
// f32 and win [B,K] i32 written.
NT_API int nt_shard_merge(int W, int B, int K, int n_total, int seq, int e,
                          const void* part_key, const void* part_score,
                          const void* active, void* choices, void* scores,
                          void* win, void* stream) {
  if (B <= 0 || K <= 0 || W <= 0) return 0;
  const int km = nt_topk_km(K), k_pad = nt_pow2(K);
  const size_t smem = nt_shard_layout(km, K, k_pad).total;
  auto fn = &nt_shard_merge_kernel<0>;
  if (km == 8) fn = &nt_shard_merge_kernel<8>;
  if (km == 32) fn = &nt_shard_merge_kernel<32>;
  const int err = nt_smem_attr((const void*)fn, smem);
  if (err) return err;
  fn<<<seq ? 1 : B, NT_TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      W, B, K, n_total, k_pad, seq, e, (const unsigned long long*)part_key,
      (const float*)part_score, (const unsigned char*)active, (int*)choices,
      (float*)scores, (int*)win);
  return (int)cudaGetLastError();
}
