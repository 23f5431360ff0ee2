// K2: the uniform distinct-hosts placement — one scoring pass and a
// top-k instead of K argmax steps (ops/binpack.py _uniform_topk_program
// in the JAX package). Every active ask is ask 0 of one task group, so
// the K best-scoring feasible nodes are the K choices.
//
// Each node's (score, index) packs into one 64-bit key: the high word
// is the score's bits mapped so unsigned order is float order, the low
// word is 0xffffffff - index, so a larger key is a higher score and,
// on ties, a lower index — lax.top_k's order. Padding keys are 0,
// below every real key.
//
// Bound on the card: one pass over N nodes (~40 bytes a node) and a
// sort of N keys; at N = 10,240 both are a few hundred KB, so the
// bound is the sort's log^2 N dependent stages, not bytes. Design: one
// block per eval (grid = B); the keys sit in dynamic shared memory
// (16,384 keys x 8 B = 128 KB at N = 10,240) or, past the shared-memory
// limit, in a global scratch row the wrapper allocates; a block-wide
// bitonic sort (descending) orders them; the first min(K, N) keys are
// the choices, the rest pad to -1; each valid choice updates its own
// row of the eval's carried state (rows are distinct, so no atomics).
#include "common.cuh"

#define NT_TOPK_THREADS 1024

__device__ __forceinline__ unsigned long long nt_pack(float s, int i) {
  uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);  // -0 ranks as +0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(0xffffffffu - (uint32_t)i);
}

__device__ __forceinline__ float nt_unpack_score(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int nt_unpack_index(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

__global__ void __launch_bounds__(NT_TOPK_THREADS) nt_uniform_topk_kernel(
    int N, int n_pad, int G, int K, float penalty,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
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
  const size_t b = blockIdx.x;
  util += b * N;
  bw_used += b * N;
  ports_free += b * N;
  job_count += b * N;
  tg_count += b * N * G;
  feasible += b * N * G;
  ask_res += b * K;
  ask_bw += b * K;
  ask_ports += b * K;
  tg_index += b * K;
  active += b * K;
  tg_dh += b * G;
  noise += b * N;
  choices += b * K;
  scores += b * K;
  unsigned long long* keys = scratch ? scratch + b * n_pad : s_keys;

  const float4 a = ask_res[0];
  const float abw = ask_bw[0];
  const float aports = ask_ports[0];
  const int tg = tg_index[0];
  const bool jdh = job_dh[b] != 0;
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
  // Bitonic sort, descending.
  const int half = n_pad >> 1;
  for (int size = 2; size <= n_pad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int lo = 2 * stride * (t / stride) + (t % stride);
        const int hi = lo + stride;
        const unsigned long long x = keys[lo];
        const unsigned long long y = keys[hi];
        const bool desc = (lo & size) == 0;
        if (desc ? (x < y) : (x > y)) {
          keys[lo] = y;
          keys[hi] = x;
        }
      }
    }
  }
  __syncthreads();
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
}

// Shared-memory bytes a block may take (227 KB on sm_90).
#define NT_TOPK_SMEM_MAX (227 * 1024)

// Shapes as nt_greedy_scan, except noise [B,N] f32; n_pad is the
// power of two >= N; scratch is NULL when n_pad * 8 bytes fit in shared
// memory, else a u64 [B, n_pad] buffer.
NT_API int nt_uniform_topk(int B, int N, int n_pad, int G, int K,
                           float penalty, const void* capacity,
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
  nt_uniform_topk_kernel<<<B, NT_TOPK_THREADS, smem, (cudaStream_t)stream>>>(
      N, n_pad, G, K, penalty, (const float4*)capacity, (const float4*)sched,
      (const float*)bw_avail, (const unsigned char*)node_ok, (float4*)util,
      (float*)bw_used, (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)active, (const unsigned char*)job_dh,
      (const unsigned char*)tg_dh, (const float*)noise,
      (unsigned long long*)scratch, (int*)choices, (float*)scores);
  return (int)cudaGetLastError();
}
