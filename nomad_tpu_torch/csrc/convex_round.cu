// K8b: the convex kernel's rounding scan (kernels/convex.py
// convex_placement_program's body scan, convex.py:244-305 in the JAX
// package): K1's masked BestFit argmax steps with the relaxation's
// preference as a bounded bias,
//
//   biased[n] = score[n] + ROUND_BIAS * pref[k, n]
//               - STRAND_BIAS * strand_pen(n),
//
// where score is K1's masked score with the noise (the same mask and
// score K1 and the host oracle enforce, at the carried state) and
// strand_pen is the waste a placement leaves on a node that then cannot
// fit another such ask: the post-placement headroom over the dimensions
// the ask uses, normalized by schedulable capacity, 0 where another ask
// still fits (csrc/common.cuh nt_strand_pen). A placement is valid when
// the best biased value is above NEG_INF / 2 and the ask is active; the
// reported score is score - noise, without the bias.
//
// Bound on the card: K1's chain of K dependent argmaxes over N nodes
// (B x K under seq), not bytes. Design: K1's cluster scan itself
// (csrc/greedy_scan.cu nt_greedy_cluster_kernel, its BIAS case), one
// launch: the node axis split over a thread-block cluster of up to 16
// CTAs an eval (one cluster walking the evals under seq), the slice's
// rows resident in shared memory where they fit, the pref row staged
// beside the noise row ahead of its step, the strand term kept in the
// score cache beside the score, one st.async key exchange a step.
// ops/scan.py plans it as K1's (scan_plan with bias), counting the pref
// stages and the strand cache in a CTA's shared memory. The batch
// layouts are K1's: independent evals, sequential evals (seq = 1: one
// shared util / bw_used / ports_free; under pre_resolve the wrapper runs
// the relaxation and this scan eval by eval, B = 1) and stacked states.
// K10g-b on the shards of one card is the same kernel over the shards'
// segments (csrc/greedy_scan.cu nt_scan_segments with ``bias``).
#include "cluster.cuh"

// Shapes: K1's (csrc/greedy_scan.cu nt_greedy_scan) with the noise read
// from noise [B,K,N] f32 (K0's) and pref [B,K,N] f32, the relaxation's
// preference; the plan's fields as K1's, for a plan with bias
// (ops/scan.py layout's pref stages and strand cache).
NT_API int nt_convex_round(int B, int N, int G, int K, float penalty,
                           int seq, int stacked, int ctas, int threads,
                           int resident, int stage_noise, int eval_bufs,
                           int cache, long long smem, const void* capacity,
                           const void* sched, const void* bw_avail,
                           const void* node_ok, void* util, void* bw_used,
                           void* ports_free, void* job_count, void* tg_count,
                           const void* feasible, const void* ask_res,
                           const void* ask_bw, const void* ask_ports,
                           const void* tg_index, const void* active,
                           const void* job_dh, const void* tg_dh,
                           const void* noise, const void* pref,
                           void* choices, void* scores, void* prof,
                           void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (pref == nullptr || noise == nullptr) return (int)cudaErrorInvalidValue;
  return nt_scan_launch(B, N, G, K, penalty, seq, stacked, ctas, threads,
                        resident, 0, stage_noise, eval_bufs, cache, smem,
                        capacity, sched, bw_avail, node_ok, util, bw_used,
                        ports_free, job_count, tg_count, feasible, ask_res,
                        ask_bw, ask_ports, tg_index, active, job_dh, tg_dh,
                        nullptr, 0.0f, 0, 0, noise, pref, choices, scores,
                        prof, stream);
}
