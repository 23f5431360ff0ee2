// K6: the dense preemption pass — K dependent place-or-preempt steps
// for one eval (ops/preempt.py _preempt_step, scanned by
// preempt_placement_program, in the JAX package).
//
// Step k, for ask k, over every node n:
// - the normal masked BestFit-v3 score (nt_node_score, K1's);
// - if n does not fit normally but is eligible (feasible, ready,
//   distinct_hosts clear), a walk over its V = 8 priority-ascending
//   victim slots keeping the running freed sums: the first slot k* that
//   is live, whose prefix holds only live victims below the eval's
//   priority (consumed and padding slots do not break the prefix), and
//   after whose eviction the ask fits, gives the post-eviction score
//   BestFit(util + ask - freed) - penalty * job_count - 2 * n_victims +
//   noise, with NO zero-sched-capacity guard (the JAX program has none).
// Each thread keeps two candidates over its strided nodes, the best
// normal fit and the best preemption; one block reduction carries both.
// A normal fit anywhere wins (preemption is masked out while any node
// fits normally), so no second pass over N is needed. Ties go to the
// lowest node index in both argmaxes, and k* is the first fitting slot.
// Thread 0 then walks the winner's slots again to recover k*, adds
// ask - freed to its util and bw_used and freed_ports - ask_ports to
// ports_free, one to job_count and tg_count, and marks slots 0..k* dead
// before the next step's barrier. Inactive (padding) asks skip the pass.
//
// Bound on the card: the K dependent block-wide argmax rounds, as K1's,
// each a pass over N nodes that also reads the victim slots of the
// nodes that do not fit normally (232 bytes a node, from L2 after the
// first step). Design: one block, 1024 threads, as K1; the victims'
// footprints are float4 rows, the consumed mask is carried in place.
#include "common.cuh"

#define NT_PREEMPT_THREADS 1024
#define NT_PREEMPT_V 8
#define NT_PREEMPT_VICTIM_PENALTY 2.0f

struct NtVictimWalk {
  int k;         // first fitting slot, -1 when none
  float4 freed;  // resources freed by slots 0..k
  float fbw;
  float fports;
  float nv;      // live victims among slots 0..k
};

// The first fitting prefix of node n's victims for an ask that brings
// the node to util nu, bandwidth bwn (bw_used + ask) and leaves it
// ports_free pf; the sums run in slot order, as the JAX cumsum.
__device__ __forceinline__ NtVictimWalk nt_victim_walk(
    int n, float4 nu, float bwn, float pf, float4 cap, float bwa,
    float aports, float prio_e, const float4* __restrict__ v_res,
    const float* __restrict__ v_bw, const float* __restrict__ v_ports,
    const float* __restrict__ v_prio, const unsigned char* v_ok) {
  NtVictimWalk w;
  w.k = -1;
  float f0 = 0.0f, f1 = 0.0f, f2 = 0.0f, f3 = 0.0f, fb = 0.0f, fp = 0.0f;
  float live = 0.0f;
  for (int v = 0; v < NT_PREEMPT_V; ++v) {
    const size_t s = (size_t)n * NT_PREEMPT_V + v;
    const bool ok = v_ok[s] != 0;
    if (ok) {
      // Dead slots add nothing (the JAX sums multiply them by 0).
      if (!(v_prio[s] < prio_e)) break;  // the prefix ends here
      const float4 r = v_res[s];
      f0 = __fadd_rn(f0, r.x);
      f1 = __fadd_rn(f1, r.y);
      f2 = __fadd_rn(f2, r.z);
      f3 = __fadd_rn(f3, r.w);
      fb = __fadd_rn(fb, v_bw[s]);
      fp = __fadd_rn(fp, v_ports[s]);
      live = __fadd_rn(live, 1.0f);
      const bool fits = (__fsub_rn(nu.x, f0) <= cap.x) &&
                        (__fsub_rn(nu.y, f1) <= cap.y) &&
                        (__fsub_rn(nu.z, f2) <= cap.z) &&
                        (__fsub_rn(nu.w, f3) <= cap.w) &&
                        (__fsub_rn(bwn, fb) <= bwa) &&
                        (__fadd_rn(pf, fp) >= aports);
      if (fits) {
        w.k = v;
        w.freed = make_float4(f0, f1, f2, f3);
        w.fbw = fb;
        w.fports = fp;
        w.nv = live;
        return w;
      }
    }
  }
  return w;
}

__device__ __forceinline__ void nt_reduce_pair(float& bs, int& bi, float os,
                                               int oi) {
  if (nt_better(os, oi, bs, bi)) {
    bs = os;
    bi = oi;
  }
}

__global__ void __launch_bounds__(NT_PREEMPT_THREADS) nt_preempt_scan_kernel(
    int N, int G, int K, float penalty, float prio_e,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok, float4* util, float* bw_used,
    float* ports_free, int* job_count, int* tg_count,
    const unsigned char* __restrict__ feasible,
    const float4* __restrict__ v_res, const float* __restrict__ v_bw,
    const float* __restrict__ v_ports, const float* __restrict__ v_prio,
    unsigned char* v_ok, const float4* __restrict__ ask_res,
    const float* __restrict__ ask_bw, const float* __restrict__ ask_ports,
    const int* __restrict__ tg_index, const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ job_dh,
    const unsigned char* __restrict__ tg_dh, const float* __restrict__ noise,
    int* __restrict__ choices, float* __restrict__ scores,
    int* __restrict__ n_victims) {
  __shared__ float s_norm[NT_PREEMPT_THREADS / 32];
  __shared__ int i_norm[NT_PREEMPT_THREADS / 32];
  __shared__ float s_pre[NT_PREEMPT_THREADS / 32];
  __shared__ int i_pre[NT_PREEMPT_THREADS / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const bool jdh = job_dh[0] != 0;

  for (int k = 0; k < K; ++k) {
    if (!active[k]) {  // uniform over the block: no barrier is skipped
      if (threadIdx.x == 0) {
        choices[k] = -1;
        scores[k] = 0.0f;
        n_victims[k] = 0;
      }
      continue;
    }
    const float4 a = ask_res[k];
    const float abw = ask_bw[k];
    const float aports = ask_ports[k];
    const int tg = tg_index[k];
    const bool tdh = tg_dh[tg] != 0;
    const float* nz = noise + (size_t)k * N;

    float bn = -INFINITY, bp = -INFINITY;
    int in = 0x7fffffff, ip = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float s = nt_node_score(n, G, tg, jdh, tdh, penalty, capacity,
                                    sched, bw_avail, node_ok, util, bw_used,
                                    ports_free, job_count, tg_count, feasible,
                                    a, abw, aports, nz[n]);
      if (s > NT_NEG_INF / 2) {
        if (s > bn) {  // n rises per thread: strict > keeps the lowest
          bn = s;
          in = n;
        }
        continue;
      }
      const int jc = job_count[n];
      bool elig = feasible[(size_t)n * G + tg] && node_ok[n];
      if (jdh) elig = elig && jc == 0;
      if (tdh) elig = elig && tg_count[(size_t)n * G + tg] == 0;
      if (!elig) continue;
      const float4 u = util[n];
      const float4 nu = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                                    __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
      const NtVictimWalk w = nt_victim_walk(
          n, nu, __fadd_rn(bw_used[n], abw), ports_free[n], capacity[n],
          bw_avail[n], aports, prio_e, v_res, v_bw, v_ports, v_prio, v_ok);
      if (w.k < 0) continue;
      const float4 sc = sched[n];
      const float f0 = __fsub_rn(
          1.0f, __fdiv_rn(__fsub_rn(nu.x, w.freed.x), fmaxf(sc.x, 1.0f)));
      const float f1 = __fsub_rn(
          1.0f, __fdiv_rn(__fsub_rn(nu.y, w.freed.y), fmaxf(sc.y, 1.0f)));
      float fit =
          __fsub_rn(20.0f, __fadd_rn(powf(10.0f, f0), powf(10.0f, f1)));
      fit = fminf(fmaxf(fit, 0.0f), 18.0f);
      const float ps = __fadd_rn(
          __fsub_rn(__fsub_rn(fit, __fmul_rn(penalty, (float)jc)),
                    __fmul_rn(NT_PREEMPT_VICTIM_PENALTY, w.nv)),
          nz[n]);
      if (ps > bp) {
        bp = ps;
        ip = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      nt_reduce_pair(bn, in, __shfl_down_sync(0xffffffffu, bn, off),
                     __shfl_down_sync(0xffffffffu, in, off));
      nt_reduce_pair(bp, ip, __shfl_down_sync(0xffffffffu, bp, off),
                     __shfl_down_sync(0xffffffffu, ip, off));
    }
    if (lane == 0) {
      s_norm[warp] = bn;
      i_norm[warp] = in;
      s_pre[warp] = bp;
      i_pre[warp] = ip;
    }
    __syncthreads();
    if (warp == 0) {
      bn = lane < n_warps ? s_norm[lane] : -INFINITY;
      in = lane < n_warps ? i_norm[lane] : 0x7fffffff;
      bp = lane < n_warps ? s_pre[lane] : -INFINITY;
      ip = lane < n_warps ? i_pre[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        nt_reduce_pair(bn, in, __shfl_down_sync(0xffffffffu, bn, off),
                       __shfl_down_sync(0xffffffffu, in, off));
        nt_reduce_pair(bp, ip, __shfl_down_sync(0xffffffffu, bp, off),
                       __shfl_down_sync(0xffffffffu, ip, off));
      }
      if (lane == 0) {
        const bool normal = bn > NT_NEG_INF / 2;
        const bool pre = !normal && bp > NT_NEG_INF / 2;
        if (normal || pre) {
          const int c = normal ? in : ip;
          const float best = normal ? bn : bp;
          const float4 u = util[c];
          float4 d = a;
          float dbw = abw;
          float dports = -aports;
          int nv = 0;
          if (pre) {
            const float4 nu =
                make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                            __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
            const NtVictimWalk w = nt_victim_walk(
                c, nu, __fadd_rn(bw_used[c], abw), ports_free[c],
                capacity[c], bw_avail[c], aports, prio_e, v_res, v_bw,
                v_ports, v_prio, v_ok);
            d = make_float4(__fsub_rn(a.x, w.freed.x),
                            __fsub_rn(a.y, w.freed.y),
                            __fsub_rn(a.z, w.freed.z),
                            __fsub_rn(a.w, w.freed.w));
            dbw = __fsub_rn(abw, w.fbw);
            dports = __fsub_rn(w.fports, aports);
            nv = (int)w.nv;
            for (int v = 0; v <= w.k; ++v)
              v_ok[(size_t)c * NT_PREEMPT_V + v] = 0;
          }
          choices[k] = c;
          scores[k] = __fsub_rn(best, nz[c]);
          n_victims[k] = nv;
          util[c] = make_float4(__fadd_rn(u.x, d.x), __fadd_rn(u.y, d.y),
                                __fadd_rn(u.z, d.z), __fadd_rn(u.w, d.w));
          bw_used[c] = __fadd_rn(bw_used[c], dbw);
          ports_free[c] = __fadd_rn(ports_free[c], dports);
          job_count[c] = job_count[c] + 1;
          tg_count[(size_t)c * G + tg] = tg_count[(size_t)c * G + tg] + 1;
        } else {
          choices[k] = -1;
          scores[k] = 0.0f;
          n_victims[k] = 0;
        }
      }
    }
    __syncthreads();
  }
}

// Shapes: capacity/sched [N,4] f32, bw_avail [N] f32, node_ok [N] u8;
// util [N,4] f32, bw_used/ports_free [N] f32, job_count [N] i32,
// tg_count [N,G] i32 (carried, updated in place); feasible [N,G] u8;
// v_res [N,8,4] f32, v_bw/v_ports/v_prio [N,8] f32, v_ok [N,8] u8
// (carried); ask_res [K,4] f32, ask_bw/ask_ports [K] f32, tg_index [K]
// i32, active [K] u8, job_dh [] u8, tg_dh [G] u8; noise [K,N] f32; out
// choices [K] i32, scores [K] f32, n_victims [K] i32.
NT_API int nt_preempt_scan(int N, int G, int K, float penalty, float prio_e,
                           const void* capacity, const void* sched,
                           const void* bw_avail, const void* node_ok,
                           void* util, void* bw_used, void* ports_free,
                           void* job_count, void* tg_count,
                           const void* feasible, const void* v_res,
                           const void* v_bw, const void* v_ports,
                           const void* v_prio, void* v_ok,
                           const void* ask_res, const void* ask_bw,
                           const void* ask_ports, const void* tg_index,
                           const void* active, const void* job_dh,
                           const void* tg_dh, const void* noise,
                           void* choices, void* scores, void* n_victims,
                           void* stream) {
  if (K <= 0) return 0;
  nt_preempt_scan_kernel<<<1, NT_PREEMPT_THREADS, 0, (cudaStream_t)stream>>>(
      N, G, K, penalty, prio_e, (const float4*)capacity,
      (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (float4*)util, (float*)bw_used,
      (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)v_res,
      (const float*)v_bw, (const float*)v_ports, (const float*)v_prio,
      (unsigned char*)v_ok, (const float4*)ask_res, (const float*)ask_bw,
      (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)active, (const unsigned char*)job_dh,
      (const unsigned char*)tg_dh, (const float*)noise, (int*)choices,
      (float*)scores, (int*)n_victims);
  return (int)cudaGetLastError();
}
