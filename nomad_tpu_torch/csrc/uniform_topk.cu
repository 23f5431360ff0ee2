// K2: the uniform distinct-hosts placement — one scoring pass and a
// top-k instead of K argmax steps (ops/binpack.py _uniform_topk_program
// in the JAX package). Every active ask is ask 0 of one task group, so
// the K best-scoring feasible nodes are the K choices. The batch
// layouts are K1's (csrc/greedy_scan.cu): independent evals, one block
// each; sequential evals (seq = 1, the pre_resolve scan of config 4's
// storm), one block walking the B evals in order over one shared copy
// of util, bw_used and ports_free; stacked states (stacked = 1), a
// per-eval base.
//
// Each node's (score, index) packs into one 64-bit key (nt_pack,
// csrc/common.cuh): a larger key is a higher score and, on ties, a
// lower index — lax.top_k's order. Padding keys are 0, below every
// real key.
//
// Bound on the card: one pass over N nodes (~40 bytes a node) and a
// sort of N keys; at N = 10,240 both are a few hundred KB, so the
// bound is the sort's log^2 N dependent stages, not bytes. Design: one
// block per eval (grid = B), or one in all under seq; the keys sit in
// dynamic shared memory (16,384 keys x 8 B = 128 KB at N = 10,240) or,
// past the shared-memory limit, in a global scratch row the wrapper
// allocates; a block-wide bitonic sort (descending) orders them; the
// first min(K, N) keys are the choices, the rest pad to -1; each valid
// choice updates its own row of the carried state (rows are distinct,
// so no atomics). Under seq a barrier after each eval's row updates
// orders them before the next eval's scoring pass, which also reuses
// the key buffer; B evals cost B sorts in sequence (~0.3 ms each on an
// H100 at N = 10,240, PERF.md).
#include "common.cuh"

#define NT_TOPK_THREADS 1024

// One eval's scoring pass, sort and row updates; every pointer is
// already offset to the eval.
__device__ __forceinline__ void nt_topk_eval(
    int N, int n_pad, int G, int K, float penalty, bool jdh,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok,
    float4* util, float* bw_used, float* ports_free, int* job_count,
    int* tg_count, const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, unsigned long long* keys,
    int* __restrict__ choices, float* __restrict__ scores) {
  const float4 a = ask_res[0];
  const float abw = ask_bw[0];
  const float aports = ask_ports[0];
  const int tg = tg_index[0];
  const bool tdh = tg_dh[tg] != 0;

  for (int n = threadIdx.x; n < n_pad; n += blockDim.x) {
    keys[n] = n < N ? nt_pack(nt_node_score(n, G, tg, jdh, tdh, penalty,
                                            capacity, sched, bw_avail,
                                            node_ok, util, bw_used,
                                            ports_free, job_count, tg_count,
                                            feasible, a, abw, aports,
                                            noise[n]),
                              n)
                    : 0ull;
  }
  nt_bitonic_desc(keys, nullptr, n_pad);
  const int k_eff = K < N ? K : N;
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    bool valid = false;
    float s = 0.0f;
    int i = 0;
    if (t < k_eff) {
      const unsigned long long key = keys[t];
      s = nt_unpack_score(key);
      i = nt_unpack_index(key);
      valid = (s > NT_NEG_INF / 2) && active[t] != 0;
    }
    if (valid) {
      choices[t] = i;
      scores[t] = __fsub_rn(s, noise[i]);
      const float4 u = util[i];
      util[i] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                            __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
      bw_used[i] = __fadd_rn(bw_used[i], abw);
      ports_free[i] = __fadd_rn(ports_free[i], -aports);
      job_count[i] = job_count[i] + 1;
      tg_count[(size_t)i * G + tg] = tg_count[(size_t)i * G + tg] + 1;
    } else {
      choices[t] = -1;
      scores[t] = 0.0f;
    }
  }
  // The next eval (seq) reads these rows and rewrites the keys.
  __syncthreads();
}

__global__ void __launch_bounds__(NT_TOPK_THREADS) nt_uniform_topk_kernel(
    int B, int N, int n_pad, int G, int K, float penalty, int seq,
    int stacked, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok,
    float4* util, float* bw_used, float* ports_free, int* job_count,
    int* tg_count, const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ job_dh,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, unsigned long long* scratch,
    int* __restrict__ choices, float* __restrict__ scores) {
  extern __shared__ unsigned long long s_keys[];
  unsigned long long* keys =
      scratch ? scratch + (size_t)blockIdx.x * n_pad : s_keys;
  const int first = seq ? 0 : blockIdx.x;
  const int last = seq ? B : first + 1;
  for (int b = first; b < last; ++b) {
    const size_t sb = stacked ? b : 0;  // static rows: per eval or shared
    const size_t cb = seq ? 0 : b;      // claimed capacity: shared under seq
    nt_topk_eval(N, n_pad, G, K, penalty, job_dh[b] != 0, capacity + sb * N,
                 sched + sb * N, bw_avail + sb * N, node_ok + sb * N,
                 util + cb * N, bw_used + cb * N, ports_free + cb * N,
                 job_count + (size_t)b * N, tg_count + (size_t)b * N * G,
                 feasible + (size_t)b * N * G, ask_res + (size_t)b * K,
                 ask_bw + (size_t)b * K, ask_ports + (size_t)b * K,
                 tg_index + (size_t)b * K, active + (size_t)b * K,
                 tg_dh + (size_t)b * G, noise + (size_t)b * N, keys,
                 choices + (size_t)b * K, scores + (size_t)b * K);
  }
}

// Shared-memory bytes a block may take (227 KB on sm_90).
#define NT_TOPK_SMEM_MAX (227 * 1024)

// Shapes as nt_greedy_scan, except noise [B,N] f32; n_pad is the
// power of two >= N; scratch is NULL when n_pad * 8 bytes fit in shared
// memory, else a u64 buffer of one n_pad row per block (B rows, or one
// under seq).
NT_API int nt_uniform_topk(int B, int N, int n_pad, int G, int K,
                           float penalty, int seq, int stacked,
                           const void* capacity,
                           const void* sched, const void* bw_avail,
                           const void* node_ok, void* util, void* bw_used,
                           void* ports_free, void* job_count, void* tg_count,
                           const void* feasible, const void* ask_res,
                           const void* ask_bw, const void* ask_ports,
                           const void* tg_index, const void* active,
                           const void* job_dh, const void* tg_dh,
                           const void* noise, void* scratch, void* choices,
                           void* scores, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  size_t smem = scratch ? 0 : (size_t)n_pad * sizeof(unsigned long long);
  if (smem > NT_TOPK_SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nt_uniform_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nt_uniform_topk_kernel<<<seq ? 1 : B, NT_TOPK_THREADS, smem,
                           (cudaStream_t)stream>>>(
      B, N, n_pad, G, K, penalty, seq, stacked, (const float4*)capacity,
      (const float4*)sched,
      (const float*)bw_avail, (const unsigned char*)node_ok, (float4*)util,
      (float*)bw_used, (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)active, (const unsigned char*)job_dh,
      (const unsigned char*)tg_dh, (const float*)noise,
      (unsigned long long*)scratch, (int*)choices, (float*)scores);
  return (int)cudaGetLastError();
}
