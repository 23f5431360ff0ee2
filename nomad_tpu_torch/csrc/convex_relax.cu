// K8a / K9: the convex kernel's relaxation (kernels/convex.py
// mirror_descent and _relaxed_assignment in the JAX package) and the
// defrag loop's global solve over the same program (defrag/solver.py
// _solve_jit.solve), one source, two prologues:
//
// - placement (mode 0): B evals x K asks x N nodes. feas[b,k,n] is the
//   ask's constraint column, node readiness, resource / bandwidth /
//   port headroom at the eval's initial state and distinct_hosts;
//   lin = feas ? BestFit fitness - penalty * job_count : 0; the logits
//   start at lin. After the loop: x = softmax(logits + mask) and the
//   rounding preference pref = (x / rowmax x + y / max y) / 2, y the
//   column sums of x over all K rows.
// - defrag (mode 1): one problem of the movable allocs (K) over the
//   nodes or node classes (N) of the residual state: no job or task
//   group terms, capacity[:, 0] > 0, fitness without the penalty;
//   warm start (rows with fresh[k] = 0 resume from the carried logits,
//   the others start at lin). After the loop: x = softmax * active.
//
// The loop, SOLVE_ITERS (12) or the defrag's 24 cold / 5 warm
// iterations, is entropic mirror descent with the closed-form
// gradient: x = softmax(logits + mask) * active; per node the
// contractions over K of x with the asks' resources [K,4], bandwidth
// and ports give the expected load, its over-capacity and the packing
// term; the gradient back on [K,N] is lin plus those node terms
// against each ask; logits += SOLVE_STEP * g.
//
// Bound on the card: bytes. Each iteration a row pass reads logits and
// the mask (5 B a pair: max, then the sum of exp), and a column pass
// reads them again, then lin and logits, and writes logits (17 B a
// pair): ~22 B a pair, ~230 MB an iteration at K = 1,024 x N = 10,240.
// A whole solve must read its O(N + K) inputs and write pref (and x
// and the logits) once; the per-iteration passes are what this simple
// design adds. Design: one launch per pass per iteration; the row pass
// is one block per (eval, ask), a block max then a block sum in a
// fixed tree; the column pass is one thread per (eval, node) walking
// k = 0..K-1 in order (coalesced over n), so every sum has one order
// and a run gives the same bits twice (no atomics). The contractions
// (R = 4) stay in registers. A persistent kernel that keeps the logits
// on chip between iterations is the next step.
#include "relax.cuh"

// ---------------------------------------------------------------- C API

// The JAX signature, one problem: logits [K,N] f32 (updated in place),
// lin and mask [K,N] f32, res_active [K,4], bw_active / ports_active /
// active [K], base_frac / denom [N,4], base_bw_frac / bw_denom /
// ports_denom [N], all f32; row_stats [2,K] f32 scratch.
NT_API int nt_mirror_descent(int N, int K, int iters, void* logits,
                             const void* lin, const void* mask,
                             const void* res_active, const void* bw_active,
                             const void* ports_active, const void* base_frac,
                             const void* base_bw_frac, const void* denom,
                             const void* bw_denom, const void* ports_denom,
                             const void* active, void* row_stats,
                             void* stream) {
  if (N <= 0 || K <= 0 || iters <= 0) return 0;
  NtRelaxLoop L{1, N, K, (float*)logits, (const float*)lin,
                (const float4*)denom, (const float4*)base_frac,
                (const float*)bw_denom, (const float*)base_bw_frac,
                (const float*)ports_denom, (const float4*)res_active,
                (const float*)bw_active, (const float*)ports_active,
                (const float*)active, (float*)row_stats,
                (float*)row_stats + K};
  return nt_relax_iterate(L, NtFloatMask{(const float*)mask}, iters,
                          (cudaStream_t)stream);
}

// The whole relaxation. mode 0 (placement): capacity / sched [N,4]
// (stacked: [B,N,4]), bw_avail [N] f32, node_ok [N] u8; util [B,N,4]
// (shared: [N,4]), bw_used / ports_free [B,N] (shared: [N]) f32;
// job_count [B,N] i32, tg_count [B,N,G] i32, feasible [B,N,G] u8;
// ask_res [B,K,4], ask_bw / ask_ports [B,K] f32, tg_index [B,K] i32,
// active [B,K] u8, job_dh [B] u8, tg_dh [B,G] u8. mode 1 (defrag): B =
// 1, the job / task group arrays null, fresh [K] u8, and logits holds
// the carried logits on entry. Outputs: logits, x, pref (mode 0) [B,K,N]
// f32, feas [B,K,N] u8; in mode 0 x may be null, and x is then staged
// in pref's buffer (the pref pass reads and writes each entry in
// place). Scratch: lin [B,K,N] f32; node4 [2,B,N,4],
// node1 [4,B,N], ask4 [B,K,4], ask1 [6,B,K], ymax [B], all f32.
NT_API int nt_convex_relax(
    int mode, int B, int N, int G, int K, int iters, float penalty,
    int stacked, int shared, const void* capacity, const void* sched,
    const void* bw_avail, const void* node_ok, const void* util,
    const void* bw_used, const void* ports_free, const void* job_count,
    const void* tg_count, const void* feasible, const void* ask_res,
    const void* ask_bw, const void* ask_ports, const void* tg_index,
    const void* active, const void* job_dh, const void* tg_dh,
    const void* fresh, void* logits, void* x, void* pref, void* feas,
    void* lin, void* node4, void* node1, void* ask4, void* ask1, void* ymax,
    void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  if (x == nullptr) {
    if (mode != 0) return cudaErrorInvalidValue;
    x = pref;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t bn = (size_t)B * N, bkn = (size_t)B * K * N;
  const NtRelaxLoop L =
      nt_relax_loop(B, N, K, logits, lin, node4, node1, ask4, ask1, nullptr);
  float* rowmax = (float*)ask1 + 5 * (size_t)B * K;
  float* y = nt_relax_y(B, N, node1);
  const NtRelaxState S = nt_relax_state(
      mode, B, N, G, K, penalty, stacked, shared, capacity, sched, bw_avail,
      node_ok, util, bw_used, ports_free, job_count, tg_count, feasible,
      ask_res, ask_bw, ask_ports, tg_index, active, job_dh, tg_dh, fresh,
      feas);
  int err = nt_relax_prologue(S, L, st);
  if (err) return err;
  const NtFeasMask mask{(const unsigned char*)feas};
  err = nt_relax_iterate(L, mask, iters, st);
  if (err) return err;
  nt_relax_rows_kernel<NtFeasMask>
      <<<B * K, NT_RELAX_ROW_THREADS, 0, st>>>(L, mask);
  NT_LAUNCHED();
  nt_relax_x_kernel<<<nt_blocks(bn, NT_RELAX_COL_THREADS),
                      NT_RELAX_COL_THREADS, 0, st>>>(L, mask, mode, (float*)x,
                                                     y);
  NT_LAUNCHED();
  if (mode != 0) return 0;
  nt_relax_max_kernel<<<B * (K + 1), NT_RELAX_ROW_THREADS, 0, st>>>(
      B, N, K, (const float*)x, y, rowmax, (float*)ymax);
  NT_LAUNCHED();
  nt_relax_pref_kernel<<<nt_blocks(bkn, 256), 256, 0, st>>>(
      B, N, K, (const float*)x, y, rowmax, (const float*)ymax, (float*)pref);
  NT_LAUNCHED();
  return 0;
}
