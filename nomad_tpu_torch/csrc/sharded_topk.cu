// K10d: the uniform distinct-hosts placement over node shards (the
// uniform dispatch, ops/binpack.py _uniform_topk_program, over a
// node-sharded base in the JAX package: GSPMD runs K2's scoring pass
// node-local and gathers the keys for its top_k), independent and
// under pre_resolve.
//
// Two kernels, W + 1 launches an eval under seq (one layout-wide
// launch of each for independent evals):
//
// 1. nt_shard_topk, once per shard on the shard's device. Prologue
//    (seq: the previous eval's; independent: the final pass): the
//    merged winners (win[], global indices or -1) update their rows of
//    the carry on the shard that owns them; the rows are distinct, so
//    no atomics. Then K2's body on the slice: every local node's
//    (score, GLOBAL index) packs into a key (nt_pack), a block-wide
//    bitonic sort (csrc/common.cuh nt_bitonic_desc) orders them in
//    shared memory (global scratch past the limit), and the first K
//    keys (0 past the slice's N) and their scores without the noise
//    (the noise window is the shard's) are the shard's candidates.
// 2. nt_shard_merge, on the combining device: the W x K candidates
//    sorted again (each key keeps its slot), and the first min(K,
//    N_total) are K2's choices in K2's order: higher score first,
//    lower global index on ties; surplus and inactive asks -1. The
//    global top K lies in the union of the shards' top K.
//
// The choices and scores are K2's bit for bit, for the reasons K10c's
// are K1's (csrc/sharded_scan.cu).
//
// Bound on the card: one scoring pass over the slice and a sort of its
// keys (log^2 of the slice's power of two in dependent stages), then a
// sort of W x K keys; a few launches of a few microseconds each.
#include "common.cuh"

#define NT_SHARD_TOPK_THREADS 1024
#define NT_SHARD_SMEM_MAX (227 * 1024)

__global__ void __launch_bounds__(NT_SHARD_TOPK_THREADS)
nt_shard_topk_kernel(
    int B, int N, int n_pad, int G, int K, int lo, float penalty, int seq,
    int stacked, int e_seq, int pe_seq, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok, float4* util, float* bw_used,
    float* ports_free, int* job_count, int* tg_count,
    const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ job_dh,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, unsigned long long* scratch,
    const int* __restrict__ win, unsigned long long* __restrict__ part_key,
    float* __restrict__ part_score) {
  extern __shared__ unsigned long long s_keys[];
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

  unsigned long long* keys =
      scratch ? scratch + (size_t)(seq ? 0 : e) * n_pad : s_keys;
  const size_t cb = seq ? 0 : e;
  const size_t sb = stacked ? e : 0;  // static rows: per eval or shared
  capacity += sb * N;
  sched += sb * N;
  bw_avail += sb * N;
  node_ok += sb * N;
  const float4 a = ask_res[(size_t)e * K];
  const float abw = ask_bw[(size_t)e * K];
  const float aports = ask_ports[(size_t)e * K];
  const int tg = tg_index[(size_t)e * K];
  const bool jdh = job_dh[e] != 0;
  const bool tdh = tg_dh[(size_t)e * G + tg] != 0;
  const float* nz = noise + (size_t)e * N;
  for (int n = threadIdx.x; n < n_pad; n += blockDim.x) {
    keys[n] = n < N ? nt_pack(nt_node_score(
                                  n, G, tg, jdh, tdh, penalty, capacity,
                                  sched, bw_avail, node_ok, util + cb * N,
                                  bw_used + cb * N, ports_free + cb * N,
                                  job_count + (size_t)e * N,
                                  tg_count + (size_t)e * N * G,
                                  feasible + (size_t)e * N * G, a, abw,
                                  aports, nz[n]),
                              lo + n)
                    : 0ull;
  }
  nt_bitonic_desc(keys, nullptr, n_pad);
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    const unsigned long long key = t < N ? keys[t] : 0ull;
    part_key[(size_t)e * K + t] = key;
    part_score[(size_t)e * K + t] =
        t < N ? __fsub_rn(nt_unpack_score(key),
                          nz[nt_unpack_index(key) - lo])
              : 0.0f;
  }
}

__global__ void __launch_bounds__(NT_SHARD_TOPK_THREADS)
nt_shard_merge_kernel(int W, int B, int K, int n_total, int m_pad, int seq,
                      int e_seq, const unsigned long long* __restrict__ part_key,
                      const float* __restrict__ part_score,
                      const unsigned char* __restrict__ active,
                      unsigned long long* scratch_keys, int* scratch_slot,
                      int* __restrict__ choices, float* __restrict__ scores,
                      int* __restrict__ win) {
  extern __shared__ unsigned long long s_merge[];
  const int e = seq ? e_seq : blockIdx.x;
  const size_t row = seq ? 0 : e;
  unsigned long long* keys =
      scratch_keys ? scratch_keys + row * m_pad : s_merge;
  int* slot = scratch_slot ? scratch_slot + row * m_pad
                           : (int*)(s_merge + m_pad);
  const int m = W * K;
  for (int i = threadIdx.x; i < m_pad; i += blockDim.x) {
    if (i < m) {
      const int s = i / K, t = i - s * K;
      keys[i] = part_key[((size_t)s * B + e) * K + t];
      slot[i] = i;
    } else {
      keys[i] = 0ull;
      slot[i] = -1;
    }
  }
  nt_bitonic_desc(keys, slot, m_pad);
  const int k_eff = K < n_total ? K : n_total;
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    bool valid = false;
    int idx = -1;
    float sc = 0.0f;
    if (t < k_eff) {
      const unsigned long long key = keys[t];
      valid = nt_unpack_score(key) > NT_NEG_INF / 2 &&
              active[(size_t)e * K + t] != 0;
      if (valid) {
        const int s = slot[t] / K, ts = slot[t] - (slot[t] / K) * K;
        idx = nt_unpack_index(key);
        sc = part_score[((size_t)s * B + e) * K + ts];
      }
    }
    choices[(size_t)e * K + t] = valid ? idx : -1;
    scores[(size_t)e * K + t] = sc;
    win[(size_t)e * K + t] = valid ? idx : -1;
  }
}

static int nt_smem_attr(const void* fn, size_t smem) {
  if (smem > NT_SHARD_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// One shard's pass: apply eval pe's winners (pe >= 0), then score and
// sort eval e (e >= 0). Shapes as nt_shard_step (csrc/sharded_scan.cu)
// except noise [B,N] f32 (the shard's window); n_pad the power of two
// >= N; scratch NULL when n_pad keys fit in shared memory, else u64
// [B or 1 under seq, n_pad]; win [B,K] i32; part_key [B,K] u64 and
// part_score [B,K] f32 out (this shard's candidates).
NT_API int nt_shard_topk(int B, int N, int n_pad, int G, int K, int lo,
                         float penalty, int seq, int stacked, int e, int pe,
                         const void* capacity, const void* sched,
                         const void* bw_avail, const void* node_ok,
                         void* util, void* bw_used, void* ports_free,
                         void* job_count, void* tg_count,
                         const void* feasible, const void* ask_res,
                         const void* ask_bw, const void* ask_ports,
                         const void* tg_index, const void* job_dh,
                         const void* tg_dh, const void* noise, void* scratch,
                         const void* win, void* part_key, void* part_score,
                         void* stream) {
  if (B <= 0 || K <= 0 || N <= 0) return 0;
  const size_t smem =
      (scratch || e < 0) ? 0 : (size_t)n_pad * sizeof(unsigned long long);
  const int err = nt_smem_attr((const void*)nt_shard_topk_kernel, smem);
  if (err) return err;
  nt_shard_topk_kernel<<<seq ? 1 : B, NT_SHARD_TOPK_THREADS, smem,
                         (cudaStream_t)stream>>>(
      B, N, n_pad, G, K, lo, penalty, seq, stacked, e, pe,
      (const float4*)capacity,
      (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (float4*)util, (float*)bw_used,
      (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)job_dh, (const unsigned char*)tg_dh,
      (const float*)noise, (unsigned long long*)scratch, (const int*)win,
      (unsigned long long*)part_key, (float*)part_score);
  return (int)cudaGetLastError();
}

// Merge of eval e's (seq) or every eval's W x K candidates: part_key
// [W,B,K] u64 and part_score [W,B,K] f32 in shard order; active [B,K]
// u8; n_total the global node count; m_pad the power of two >= W x K;
// scratch_keys / scratch_slot NULL when m_pad x 12 bytes fit in shared
// memory, else u64 / i32 [B or 1, m_pad]; choices [B,K] i32, scores
// [B,K] f32 and win [B,K] i32 written.
NT_API int nt_shard_merge(int W, int B, int K, int n_total, int m_pad,
                          int seq, int e, const void* part_key,
                          const void* part_score, const void* active,
                          void* scratch_keys, void* scratch_slot,
                          void* choices, void* scores, void* win,
                          void* stream) {
  if (B <= 0 || K <= 0 || W <= 0) return 0;
  const size_t smem =
      scratch_keys ? 0 : (size_t)m_pad * (sizeof(unsigned long long) + 4);
  const int err = nt_smem_attr((const void*)nt_shard_merge_kernel, smem);
  if (err) return err;
  nt_shard_merge_kernel<<<seq ? 1 : B, NT_SHARD_TOPK_THREADS, smem,
                          (cudaStream_t)stream>>>(
      W, B, K, n_total, m_pad, seq, e, (const unsigned long long*)part_key,
      (const float*)part_score, (const unsigned char*)active,
      (unsigned long long*)scratch_keys, (int*)scratch_slot, (int*)choices,
      (float*)scores, (int*)win);
  return (int)cudaGetLastError();
}
