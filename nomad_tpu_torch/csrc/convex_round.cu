// K8b: the convex kernel's rounding scan (kernels/convex.py
// convex_placement_program's body scan, convex.py:244-305 in the JAX
// package): K1's masked BestFit argmax steps with the relaxation's
// preference as a bounded bias,
//
//   biased[n] = score[n] + ROUND_BIAS * pref[k, n]
//               - STRAND_BIAS * strand_pen(n),
//
// where score is nt_node_score (the same mask and score K1 and the host
// oracle enforce, at the carried state) and strand_pen is the waste a
// placement leaves on a node that then cannot fit another such ask:
// the post-placement headroom over the dimensions the ask uses,
// normalized by schedulable capacity, 0 where another ask still fits.
// A placement is valid when the best biased value is above NEG_INF / 2
// and the ask is active; the reported score is score - noise, without
// the bias. The bias cannot lift an infeasible node (NEG_INF plus a
// bounded bias stays NEG_INF), so validity is K1's.
//
// The batch layouts are K1's (csrc/greedy_scan.cu): independent evals
// (one block each, a carry copy each), sequential evals (seq = 1: one
// block walks the B evals in order over one shared util / bw_used /
// ports_free) and stacked states (stacked = 1: the static rows per
// eval). Under pre_resolve the wrapper runs the relaxation and this
// scan eval by eval (seq, B = 1), so each eval's relaxation reads the
// capacity the earlier evals' scans claimed.
//
// Bound on the card: K1's chain of K dependent block-wide argmaxes
// (nt_argmax_chain measures it), not bytes: each step is a pass over N
// nodes (~40 B a node and 4 B of pref, from L2 after the first step),
// two barriers, and one row update by thread 0. Design: K1's, one
// block of 1024 threads per eval scoring strided nodes, a warp-shuffle
// then shared-memory argmax (lowest index on ties, as jnp.argmax);
// thread 0 rescores the winner without the bias for the reported
// score and updates its row. Every + - * / of the bias and the strand
// term is a round-to-nearest intrinsic, in the plain version's order,
// so choices match it exactly.
#include "common.cuh"

#define NT_ROUND_THREADS 1024

// One eval's K rounding steps; every pointer is already offset to it.
__device__ __forceinline__ void nt_round_eval(
    int N, int G, int K, float penalty, bool jdh,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok,
    float4* util, float* bw_used, float* ports_free, int* job_count,
    int* tg_count, const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, const float* __restrict__ pref,
    int* __restrict__ choices, float* __restrict__ scores, float* s_best,
    int* i_best) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = 0; k < K; ++k) {
    const float4 a = ask_res[k];
    const float abw = ask_bw[k];
    const float aports = ask_ports[k];
    const int tg = tg_index[k];
    const bool tdh = tg_dh[tg] != 0;
    const float* nz = noise + (size_t)k * N;
    const float* pr = pref + (size_t)k * N;

    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float s = nt_node_score(n, G, tg, jdh, tdh, penalty, capacity,
                                    sched, bw_avail, node_ok, util, bw_used,
                                    ports_free, job_count, tg_count, feasible,
                                    a, abw, aports, nz[n]);
      const float v = __fadd_rn(
          s, nt_round_bias(n, capacity, sched, util, a, pr[n]));
      if (v > bs) {  // n rises per thread: strict > keeps the lowest index
        bs = v;
        bi = n;
      }
    }
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
      if (lane == 0) {
        const bool valid = (bs > NT_NEG_INF / 2) && active[k] != 0;
        if (valid) {
          const float s = nt_node_score(
              bi, G, tg, jdh, tdh, penalty, capacity, sched, bw_avail,
              node_ok, util, bw_used, ports_free, job_count, tg_count,
              feasible, a, abw, aports, nz[bi]);
          choices[k] = bi;
          scores[k] = __fsub_rn(s, nz[bi]);
          const float4 u = util[bi];
          util[bi] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                                 __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
          bw_used[bi] = __fadd_rn(bw_used[bi], abw);
          ports_free[bi] = __fadd_rn(ports_free[bi], -aports);
          job_count[bi] = job_count[bi] + 1;
          tg_count[(size_t)bi * G + tg] = tg_count[(size_t)bi * G + tg] + 1;
        } else {
          choices[k] = -1;
          scores[k] = 0.0f;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT_ROUND_THREADS) nt_convex_round_kernel(
    int B, int N, int G, int K, float penalty, int seq, int stacked,
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
    const float* __restrict__ noise, const float* __restrict__ pref,
    int* __restrict__ choices, float* __restrict__ scores) {
  __shared__ float s_best[NT_ROUND_THREADS / 32];
  __shared__ int i_best[NT_ROUND_THREADS / 32];
  const int first = seq ? 0 : blockIdx.x;
  const int last = seq ? B : first + 1;
  for (int b = first; b < last; ++b) {
    const size_t sb = stacked ? b : 0;  // static rows: per eval or shared
    const size_t cb = seq ? 0 : b;      // claimed capacity: shared under seq
    nt_round_eval(N, G, K, penalty, job_dh[b] != 0, capacity + sb * N,
                  sched + sb * N, bw_avail + sb * N, node_ok + sb * N,
                  util + cb * N, bw_used + cb * N, ports_free + cb * N,
                  job_count + (size_t)b * N, tg_count + (size_t)b * N * G,
                  feasible + (size_t)b * N * G, ask_res + (size_t)b * K,
                  ask_bw + (size_t)b * K, ask_ports + (size_t)b * K,
                  tg_index + (size_t)b * K, active + (size_t)b * K,
                  tg_dh + (size_t)b * G, noise + (size_t)b * K * N,
                  pref + (size_t)b * K * N, choices + (size_t)b * K,
                  scores + (size_t)b * K, s_best, i_best);
  }
}

// Shapes: K1's (csrc/greedy_scan.cu nt_greedy_scan) plus pref [B,K,N]
// f32 after noise.
NT_API int nt_convex_round(int B, int N, int G, int K, float penalty,
                           int seq, int stacked, const void* capacity,
                           const void* sched, const void* bw_avail,
                           const void* node_ok, void* util, void* bw_used,
                           void* ports_free, void* job_count, void* tg_count,
                           const void* feasible, const void* ask_res,
                           const void* ask_bw, const void* ask_ports,
                           const void* tg_index, const void* active,
                           const void* job_dh, const void* tg_dh,
                           const void* noise, const void* pref,
                           void* choices, void* scores, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  nt_convex_round_kernel<<<seq ? 1 : B, NT_ROUND_THREADS, 0,
                           (cudaStream_t)stream>>>(
      B, N, G, K, penalty, seq, stacked, (const float4*)capacity,
      (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (float4*)util, (float*)bw_used,
      (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)active, (const unsigned char*)job_dh,
      (const unsigned char*)tg_dh, (const float*)noise, (const float*)pref,
      (int*)choices, (float*)scores);
  return (int)cudaGetLastError();
}
