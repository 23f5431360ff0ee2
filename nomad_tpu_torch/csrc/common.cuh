// Shared pieces of the placement kernels: the C ABI, the masked
// score of one node for one ask (ops/binpack.py _score_and_mask in the
// JAX package), and the (score, index) order every argmax and top-k
// here uses: higher score first, lower node index first on ties, the
// order jnp.argmax and lax.top_k give.
//
// Numerics: every + - * / of the score is an explicit round-to-nearest
// intrinsic (__fadd_rn, ...), which the compiler never contracts into a
// fused multiply-add, so each rounds once as the plain PyTorch
// version's separate tensor ops do. 10^x is powf, the function
// torch.pow calls for float32 on the card, built with nvcc's default
// flags as PyTorch's own kernels are.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NT_API extern "C" __attribute__((visibility("default")))

#define NT_NEG_INF (-1e30f)

// One ask's feasibility mask and BestFit-v3 score on node n. The
// arguments are the eval's rows (already offset by the batch index).
__device__ __forceinline__ float nt_node_score(
    int n, int G, int tg, bool jdh, bool tdh, float penalty,
    const float4* __restrict__ capacity,
    const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok,
    const float4* util, const float* bw_used, const float* ports_free,
    const int* job_count, const int* tg_count,
    const unsigned char* __restrict__ feasible,
    float4 a, float abw, float aports, float noise) {
  const float4 u = util[n];
  const float4 cap = capacity[n];
  const float4 sc = sched[n];
  const float nu0 = __fadd_rn(u.x, a.x);
  const float nu1 = __fadd_rn(u.y, a.y);
  const float nu2 = __fadd_rn(u.z, a.z);
  const float nu3 = __fadd_rn(u.w, a.w);
  bool fits = (nu0 <= cap.x) && (nu1 <= cap.y) && (nu2 <= cap.z) &&
              (nu3 <= cap.w);
  fits = fits && (__fadd_rn(bw_used[n], abw) <= bw_avail[n]);
  fits = fits && (ports_free[n] >= aports);
  fits = fits && feasible[(size_t)n * G + tg] && node_ok[n];
  const int jc = job_count[n];
  if (jdh) fits = fits && (jc == 0);
  if (tdh) fits = fits && (tg_count[(size_t)n * G + tg] == 0);
  const float f0 = __fsub_rn(1.0f, __fdiv_rn(nu0, fmaxf(sc.x, 1.0f)));
  const float f1 = __fsub_rn(1.0f, __fdiv_rn(nu1, fmaxf(sc.y, 1.0f)));
  float fit = __fsub_rn(20.0f, __fadd_rn(powf(10.0f, f0), powf(10.0f, f1)));
  fit = fminf(fmaxf(fit, 0.0f), 18.0f);
  if (sc.x <= 0.0f || sc.y <= 0.0f) fit = 0.0f;
  const float s = __fadd_rn(__fsub_rn(fit, __fmul_rn(penalty, (float)jc)),
                            noise);
  return fits ? s : NT_NEG_INF;
}

// The convex kernel's rounding bias (kernels/convex.py ROUND_BIAS and
// STRAND_BIAS): ROUND_BIAS x the relaxation's preference, minus
// STRAND_BIAS x the strand penalty of nt_strand_pen.
#define NT_ROUND_BIAS 8.0f
#define NT_STRAND_BIAS 12.0f

// The strand penalty of placing ask a on node n at the carried state:
// the post-placement headroom over the dimensions the ask uses,
// normalized by schedulable capacity, 0 where another such ask still
// fits (csrc/convex_round.cu K8b, csrc/sharded_scan.cu K10g-b).
__device__ __forceinline__ float nt_strand_pen(
    int n, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float4* util, float4 a) {
  const float4 c = capacity[n];
  const float4 u = util[n];
  const float4 sc = sched[n];
  const float h0 = __fsub_rn(__fsub_rn(c.x, u.x), a.x);
  const float h1 = __fsub_rn(__fsub_rn(c.y, u.y), a.y);
  const float h2 = __fsub_rn(__fsub_rn(c.z, u.z), a.z);
  const float h3 = __fsub_rn(__fsub_rn(c.w, u.w), a.w);
  if (h0 >= a.x && h1 >= a.y && h2 >= a.z && h3 >= a.w) return 0.0f;
  const float u0 = a.x > 0.0f ? 1.0f : 0.0f, u1 = a.y > 0.0f ? 1.0f : 0.0f;
  const float u2 = a.z > 0.0f ? 1.0f : 0.0f, u3 = a.w > 0.0f ? 1.0f : 0.0f;
  const float w0 = __fdiv_rn(fmaxf(h0, 0.0f), fmaxf(sc.x, 1.0f));
  const float w1 = __fdiv_rn(fmaxf(h1, 0.0f), fmaxf(sc.y, 1.0f));
  const float w2 = __fdiv_rn(fmaxf(h2, 0.0f), fmaxf(sc.z, 1.0f));
  const float w3 = __fdiv_rn(fmaxf(h3, 0.0f), fmaxf(sc.w, 1.0f));
  const float sum = __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(w0, u0), __fmul_rn(w1, u1)),
                __fmul_rn(w2, u2)),
      __fmul_rn(w3, u3));
  const float used = __fadd_rn(__fadd_rn(__fadd_rn(u0, u1), u2), u3);
  return __fdiv_rn(sum, fmaxf(used, 1.0f));
}

// The rounding bias of node n: ROUND_BIAS x pref - STRAND_BIAS x
// strand penalty, in the plain version's order of rounded operations.
__device__ __forceinline__ float nt_round_bias(
    int n, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float4* util, float4 a,
    float pref) {
  return __fsub_rn(__fmul_rn(NT_ROUND_BIAS, pref),
                   __fmul_rn(NT_STRAND_BIAS,
                             nt_strand_pen(n, capacity, sched, util, a)));
}

// (s, i) ranks before (bs, bi).
__device__ __forceinline__ bool nt_better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}

// (score, node index) packed into one 64-bit key whose unsigned order
// is nt_better's: the high word is the score's bits mapped so unsigned
// order is float order (-0 ranks as +0), the low word 0xffffffff -
// index, so a larger key is a higher score and, on ties, a lower
// index. Key 0 is below every real key (padding).
__device__ __forceinline__ unsigned long long nt_pack(float s, int i) {
  uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) |
         (unsigned long long)(0xffffffffu - (uint32_t)i);
}

__device__ __forceinline__ float nt_unpack_score(unsigned long long key) {
  const uint32_t u = (uint32_t)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int nt_unpack_index(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

// Block-wide bitonic sort of n_pad keys (a power of two), descending,
// in shared or global memory; ``pay`` (may be null) moves with its
// key. Opens and closes with a barrier.
__device__ __forceinline__ void nt_bitonic_desc(unsigned long long* keys,
                                                int* pay, int n_pad) {
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
          if (pay) {
            const int p = pay[lo];
            pay[lo] = pay[hi];
            pay[hi] = p;
          }
        }
      }
    }
  }
  __syncthreads();
}

// One chunk of a node-order group sum (K7's group capacity, K10b's
// partials): this thread holds node (base + threadIdx.x)'s units ``u``
// and group ``id`` (< 0 or >= g_pad: none; past N pass 0 and -1). Each
// group the chunk adds to is summed by one thread walking the chunk in
// node order, into ``sums`` [g_pad], so a group's float sum rounds in
// the order index_add_ rounds it, also past 2^24. Adding a zero leaves
// a sum as it is: only groups with units here are walked. ``s_units``
// and ``s_ids`` hold blockDim.x entries, ``s_lo``/``s_hi`` one int, all
// in shared memory. Opens and closes with a barrier.
__device__ __forceinline__ void nt_group_chunk(int base, int N, int g_pad,
                                               float u, int id, float* sums,
                                               float* s_units, int* s_ids,
                                               int* s_lo, int* s_hi) {
  const int t = threadIdx.x;
  if (t == 0) {
    *s_lo = 0x7fffffff;
    *s_hi = -1;
  }
  __syncthreads();
  s_units[t] = u;
  s_ids[t] = id;
  if (id >= 0 && id < g_pad && u != 0.0f) {
    atomicMin(s_lo, id);
    atomicMax(s_hi, id);
  }
  __syncthreads();
  const int m = min((int)blockDim.x, N - base);
  const int lo = *s_lo, hi = *s_hi;  // lo > hi: no group to add to
  for (int g = lo <= hi ? lo + t : hi + 1; g <= hi; g += blockDim.x) {
    float acc = sums[g];
    for (int i = 0; i < m; ++i)
      if (s_ids[i] == g) acc = __fadd_rn(acc, s_units[i]);
    sums[g] = acc;
  }
  __syncthreads();
}
