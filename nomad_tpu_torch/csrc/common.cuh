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

// (s, i) ranks before (bs, bi).
__device__ __forceinline__ bool nt_better(float s, int i, float bs, int bi) {
  return s > bs || (s == bs && i < bi);
}
