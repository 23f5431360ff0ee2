// K10f and K10g-a: the convex relaxation over node shards, in its two
// modes (csrc/convex_relax.cu's K9 and K8a with the node axis split):
//
// - defrag (mode 1, K10f): the defrag loop's global solve with x[K, N]
//   split over node columns (parallel/mesh.py defrag_solve_specs and
//   shard_defrag_inputs, then defrag/solver.py _solve_jit in the JAX
//   package, where GSPMD lowers the per-alloc softmax over the sharded
//   node axis to a cross-device reduction);
// - placement (mode 0, K10g-a): the convex kernel's relaxation over a
//   node-sharded base (kernels/convex.py _relaxed_assignment and the
//   preference of convex_placement_program, reached through
//   ops/binpack.py placement_program's kernel switch there).
//
// One process drives W shards, each a slice of N node columns on its
// own device. The host loop (parallel/shard.py sharded_relax) launches:
//
// 1. nt_srelax_prologue on every shard: convex_relax.cu's prologue on
//    the shard's columns (mask, lin, the logits' start; the per-ask
//    terms, replicated).
// 2. Each iteration: nt_srelax_rows on every shard, the softmax max
//    m_s and sum s_s of each (eval, ask) row over the shard's columns;
//    nt_srelax_combine on the combining device, m = max_s m_s and s =
//    sum_s s_s exp(m_s - m) in fixed shard order (a row whose every
//    entry is NEG_INF on every shard gives m = NEG_INF and s = N, so it
//    comes out uniform 1 / N over the whole node axis); then
//    nt_srelax_cols on every shard with the combined (m, s): the
//    column pass is node-local (the contractions run over K).
// 3. The rows and the combine once more, then nt_srelax_x on every
//    shard: x = softmax (defrag: times active) and, in placement mode,
//    the column sums y over all K rows (node-local).
// 4. Placement only: nt_srelax_max on every shard (each row's max of x
//    and the max of y over the shard's columns), the max combine, and
//    nt_srelax_pref, pref = (x / rowmax + y / ymax) / 2.
// No kernel writes another shard's memory: the partial statistics come
// to the combining device, and the combined ones go back, outside the
// kernels.
//
// Against the one-device kernel only the softmax sum's order differs
// (each shard's block tree, then the shards in order): the outputs
// agree to float32 rounding where the relaxation is not chaotic.
//
// Bound on the card: bytes, as K8a / K9, plus launches: 3 W + iters x
// (2 W + 1) + 2 W + 1 (and 2 W + 1 for pref) a solve.
#include "relax.cuh"

// mode 0 (the softmax statistics): part [W, 2, count] holds each
// shard's (m_s, s_s); out [2, count] gets (m, sum_s s_s exp(m_s - m)),
// the shards in order. mode 1: part [W, count]; out [count] the max.
static __global__ void nt_srelax_combine_kernel(
    int W, int count, int mode, const float* __restrict__ part,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const size_t stride = mode == 0 ? 2 * (size_t)count : (size_t)count;
  float m = part[i];
  for (int s = 1; s < W; ++s) m = fmaxf(m, part[s * stride + i]);
  out[i] = m;
  if (mode != 0) return;
  float acc = 0.0f;
  for (int s = 0; s < W; ++s)
    acc = __fadd_rn(acc, __fmul_rn(part[s * stride + count + i],
                                   expf(__fsub_rn(part[s * stride + i], m))));
  out[count + i] = acc;
}

// The loop's logits, activity and row statistics alone (the row pass
// and the x pass read nothing else).
static inline NtRelaxLoop nt_srelax_rows_loop(int B, int N, int K,
                                              void* logits, const void* act,
                                              float* stats) {
  NtRelaxLoop L{};
  L.B = B;
  L.N = N;
  L.K = K;
  L.logits = (float*)logits;
  L.act = (const float*)act;
  L.row_m = stats;
  L.row_s = stats + (size_t)B * K;
  return L;
}

// One shard's prologue: nt_convex_relax's state arguments over the
// shard's N columns (capacity / sched / bw_avail / node_ok and the
// carry's node rows, feasible [B,N,G], job_count / tg_count, the
// replicated asks, fresh [K] in defrag mode) and its scratch (logits,
// feas, lin [B,K,N]; node4, node1, ask4, ask1 as nt_convex_relax's).
// In defrag mode logits holds the carried logits on entry.
NT_API int nt_srelax_prologue(
    int mode, int B, int N, int G, int K, float penalty, int stacked,
    int shared, const void* capacity, const void* sched,
    const void* bw_avail, const void* node_ok, const void* util,
    const void* bw_used, const void* ports_free, const void* job_count,
    const void* tg_count, const void* feasible, const void* ask_res,
    const void* ask_bw, const void* ask_ports, const void* tg_index,
    const void* active, const void* job_dh, const void* tg_dh,
    const void* fresh, void* logits, void* feas, void* lin, void* node4,
    void* node1, void* ask4, void* ask1, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  const NtRelaxLoop L =
      nt_relax_loop(B, N, K, logits, lin, node4, node1, ask4, ask1, nullptr);
  const NtRelaxState S = nt_relax_state(
      mode, B, N, G, K, penalty, stacked, shared, capacity, sched, bw_avail,
      node_ok, util, bw_used, ports_free, job_count, tg_count, feasible,
      ask_res, ask_bw, ask_ports, tg_index, active, job_dh, tg_dh, fresh,
      feas);
  return nt_relax_prologue(S, L, (cudaStream_t)stream);
}

// One shard's row pass: part [2, B*K] f32 gets each row's max and sum
// of exp over the shard's columns (logits [B,K,N] f32, feas [B,K,N]
// u8).
NT_API int nt_srelax_rows(int B, int N, int K, const void* logits,
                          const void* feas, void* part, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  const NtRelaxLoop L =
      nt_srelax_rows_loop(B, N, K, (void*)logits, nullptr, (float*)part);
  nt_relax_rows_kernel<NtFeasMask>
      <<<B * K, NT_RELAX_ROW_THREADS, 0, (cudaStream_t)stream>>>(
          L, NtFeasMask{(const unsigned char*)feas});
  return (int)cudaGetLastError();
}

// On the combining device: part [W, 2, count] (mode 0) or [W, count]
// (mode 1) f32; out [2, count] or [count] f32.
NT_API int nt_srelax_combine(int W, int count, int mode, const void* part,
                             void* out, void* stream) {
  if (W <= 0 || count <= 0) return 0;
  const int threads = 256;
  nt_srelax_combine_kernel<<<(count + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
      W, count, mode, (const float*)part, (float*)out);
  return (int)cudaGetLastError();
}

// One shard's column pass with the combined statistics stats [2, B*K]
// (on this shard's device): the scratch as nt_srelax_prologue's.
NT_API int nt_srelax_cols(int B, int N, int K, void* logits, const void* lin,
                          const void* feas, void* node4, void* node1,
                          const void* ask4, void* ask1, const void* stats,
                          void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  const NtRelaxLoop L = nt_relax_loop(B, N, K, logits, lin, node4, node1,
                                      ask4, ask1, (float*)stats);
  nt_relax_cols_kernel<NtFeasMask>
      <<<nt_blocks((size_t)B * N, NT_RELAX_COL_THREADS),
         NT_RELAX_COL_THREADS, 0, (cudaStream_t)stream>>>(
          L, NtFeasMask{(const unsigned char*)feas});
  return (int)cudaGetLastError();
}

// One shard's x [B,K,N] f32 = softmax with the combined statistics
// (mode 1: times active); in mode 0 also y [B,N] into node1's scratch.
NT_API int nt_srelax_x(int mode, int B, int N, int K, const void* logits,
                       const void* feas, void* node1, const void* ask1,
                       const void* stats, void* x, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  const NtRelaxLoop L = nt_srelax_rows_loop(
      B, N, K, (void*)logits, (const float*)ask1 + 2 * (size_t)B * K,
      (float*)stats);
  nt_relax_x_kernel<<<nt_blocks((size_t)B * N, NT_RELAX_COL_THREADS),
                      NT_RELAX_COL_THREADS, 0, (cudaStream_t)stream>>>(
      L, NtFeasMask{(const unsigned char*)feas}, mode, (float*)x,
      nt_relax_y(B, N, node1));
  return (int)cudaGetLastError();
}

// One shard's maxima: part [B*K + B] f32 gets each row's max of x over
// the shard's columns, then each eval's max of y.
NT_API int nt_srelax_max(int B, int N, int K, const void* x,
                         const void* node1, void* part, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  float* rowmax = (float*)part;
  nt_relax_max_kernel<<<B * (K + 1), NT_RELAX_ROW_THREADS, 0,
                        (cudaStream_t)stream>>>(
      B, N, K, (const float*)x, nt_relax_y(B, N, (void*)node1), rowmax,
      rowmax + (size_t)B * K);
  return (int)cudaGetLastError();
}

// One shard's pref [B,K,N] f32 from x, its y (node1) and the combined
// maxima [B*K + B] (on this shard's device).
NT_API int nt_srelax_pref(int B, int N, int K, const void* x,
                          const void* node1, const void* maxima, void* pref,
                          void* stream) {
  if (B <= 0 || N <= 0 || K <= 0) return 0;
  const float* rowmax = (const float*)maxima;
  nt_relax_pref_kernel<<<nt_blocks((size_t)B * K * N, 256), 256, 0,
                         (cudaStream_t)stream>>>(
      B, N, K, (const float*)x, nt_relax_y(B, N, (void*)node1), rowmax,
      rowmax + (size_t)B * K, (float*)pref);
  return (int)cudaGetLastError();
}
