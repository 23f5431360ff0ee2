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

// The shared-memory address of a generic pointer into this CTA's
// shared memory, as PTX takes it.
__device__ __forceinline__ uint32_t nt_saddr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// An mbarrier (one arrival a phase) for bulk copies to complete on.
__device__ __forceinline__ void nt_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(nt_saddr(bar))
               : "memory");
}

// Wait until the phase of ``bar`` with this parity has completed.
__device__ __forceinline__ void nt_mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(nt_saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Where [src, src + len) lands in a staging region: the region's byte
// (src mod 16) on, so that the 16-byte-aligned body of the source maps
// to a 16-byte-aligned destination.
template <class T>
__device__ __forceinline__ T* nt_staged(unsigned char* region, const T* src) {
  return (T*)(region + ((uintptr_t)src & 15));
}

// threefry2x32 (20 rounds, 5 key injections) of the counter pair
// (x0, x1) under the key (k0, k1), in place: jax.random's hash.
__device__ __forceinline__ uint32_t nt_rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define NT_TF_ROUND(r) \
  x0 += x1;            \
  x1 = nt_rotl(x1, r); \
  x1 ^= x0;

__device__ __forceinline__ void nt_threefry2x32(uint32_t k0, uint32_t k1,
                                                uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  NT_TF_ROUND(13) NT_TF_ROUND(15) NT_TF_ROUND(26) NT_TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  NT_TF_ROUND(17) NT_TF_ROUND(29) NT_TF_ROUND(16) NT_TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  NT_TF_ROUND(13) NT_TF_ROUND(15) NT_TF_ROUND(26) NT_TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  NT_TF_ROUND(17) NT_TF_ROUND(29) NT_TF_ROUND(16) NT_TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  NT_TF_ROUND(13) NT_TF_ROUND(15) NT_TF_ROUND(26) NT_TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

#undef NT_TF_ROUND

// The tie-break noise of one element, bit-identical to
// jax.random.uniform(key, shape, minval, minval + scale) in float32
// under jax_threefry_partitionable (the JAX package's ops/binpack.py
// draws at :320 and :384): the element's 64-bit counter hashed as the
// pair (counter >> 32, counter & 0xffffffff) under the raw key (k0,
// k1); its 32 bits the XOR of the two output words; the float
// (bits >> 9 | 0x3f800000) - 1 in [0, 1), scaled by one fused
// multiply-add (XLA contracts f * (maxval - minval) + minval so) and
// clamped below at minval, as jax/_src/random.py _uniform does. Every
// kernel that draws noise draws it through this function: K0
// (csrc/threefry.cu) for the consumers that keep a noise tensor, and
// the scans that draw their own (csrc/greedy_scan.cu,
// csrc/uniform_topk.cu).
__device__ __forceinline__ float nt_noise_at(uint32_t k0, uint32_t k1,
                                             unsigned long long counter,
                                             float minval, float scale) {
  uint32_t x0 = (uint32_t)(counter >> 32);
  uint32_t x1 = (uint32_t)counter;
  nt_threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
  return fmaxf(minval, fmaf(f, scale, minval));
}

// One ask's BestFit-v3 score before the tie-break noise on a node whose
// rows are already loaded, with the part of its feasibility mask that
// does not depend on the ask's task group: fit minus the anti-affinity
// penalty, or -INFINITY where the ask's resources, bandwidth or ports
// do not fit, the node is not ok, or the job's distinct_hosts binds. u,
// cap, sc the util, capacity and sched rows; jc the job's count.
__device__ __forceinline__ float nt_fit_of(
    float4 u, float4 cap, float4 sc, float bw_used, float bw_avail,
    float ports_free, bool ok, int jc, bool jdh, float penalty, float4 a,
    float abw, float aports) {
  const float nu0 = __fadd_rn(u.x, a.x);
  const float nu1 = __fadd_rn(u.y, a.y);
  const float nu2 = __fadd_rn(u.z, a.z);
  const float nu3 = __fadd_rn(u.w, a.w);
  bool fits = (nu0 <= cap.x) && (nu1 <= cap.y) && (nu2 <= cap.z) &&
              (nu3 <= cap.w);
  fits = fits && (__fadd_rn(bw_used, abw) <= bw_avail);
  fits = fits && (ports_free >= aports);
  fits = fits && ok;
  if (jdh) fits = fits && (jc == 0);
  const float f0 = __fsub_rn(1.0f, __fdiv_rn(nu0, fmaxf(sc.x, 1.0f)));
  const float f1 = __fsub_rn(1.0f, __fdiv_rn(nu1, fmaxf(sc.y, 1.0f)));
  float fit = __fsub_rn(20.0f, __fadd_rn(powf(10.0f, f0), powf(10.0f, f1)));
  fit = fminf(fmaxf(fit, 0.0f), 18.0f);
  if (sc.x <= 0.0f || sc.y <= 0.0f) fit = 0.0f;
  return fits ? __fsub_rn(fit, __fmul_rn(penalty, (float)jc)) : -INFINITY;
}

// The task group's part of the mask: its column of feasible (feas), and
// under its distinct_hosts (tdh) no alloc of the group on the node
// (tgc, read only under tdh).
__device__ __forceinline__ bool nt_group_fits(bool feas, bool tdh, int tgc) {
  return feas && (!tdh || tgc == 0);
}

// One ask's masked score with the noise added, NT_NEG_INF where the
// ask does not fit; feas the ask's task-group column of feasible, tgc
// its count.
__device__ __forceinline__ float nt_score_of(
    float4 u, float4 cap, float4 sc, float bw_used, float bw_avail,
    float ports_free, bool feas, bool ok, int jc, int tgc, bool jdh,
    bool tdh, float penalty, float4 a, float abw, float aports,
    float noise) {
  const float base = nt_fit_of(u, cap, sc, bw_used, bw_avail, ports_free,
                               ok, jc, jdh, penalty, a, abw, aports);
  return base == -INFINITY || !nt_group_fits(feas, tdh, tgc)
             ? NT_NEG_INF
             : __fadd_rn(base, noise);
}

// One ask's feasibility mask and BestFit-v3 score on node n. The
// arguments are the eval's rows (already offset by the batch index).
// Every row loads before any test, so the loads overlap.
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
  const size_t cell = (size_t)n * G + tg;
  return nt_score_of(util[n], capacity[n], sched[n], bw_used[n], bw_avail[n],
                     ports_free[n], feasible[cell] != 0, node_ok[n] != 0,
                     job_count[n], tdh ? tg_count[cell] : 0, jdh, tdh,
                     penalty, a, abw, aports, noise);
}

// The convex kernel's rounding bias (kernels/convex.py ROUND_BIAS and
// STRAND_BIAS): ROUND_BIAS x the relaxation's preference, minus
// STRAND_BIAS x the strand penalty of nt_strand_pen.
#define NT_ROUND_BIAS 8.0f
#define NT_STRAND_BIAS 12.0f

// The strand penalty of placing ask a on node n at the carried state:
// the post-placement headroom over the dimensions the ask uses,
// normalized by schedulable capacity, 0 where another such ask still
// fits (K8b: csrc/greedy_scan.cu's BIAS case; K10g-b:
// csrc/sharded_scan.cu).
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
