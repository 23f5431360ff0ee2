// K8a, K9, K10f and K10g-a: the convex kernel's relaxation (kernels/
// convex.py mirror_descent and _relaxed_assignment in the JAX package,
// with the preference of convex_placement_program), the defrag loop's
// global solve over the same program (defrag/solver.py _solve_jit.solve)
// and both over node shards (parallel/mesh.py:186,201, ops/binpack.py:
// 373): one persistent kernel (csrc/relax.cuh), three modes.
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
// - loop only (mode 2, the JAX signature of mirror_descent): the
//   caller's logits, lin, float mask, node terms and scaled asks; the
//   loop alone.
//
// The loop, SOLVE_ITERS (12) or the defrag's 24 cold / 5 warm
// iterations, is entropic mirror descent with the closed-form
// gradient: x = softmax(logits + mask) * active; per node the
// contractions over K of x with the asks' resources [K,4], bandwidth
// and ports give the expected load, its over-capacity and the packing
// term; the gradient back on [K,N] is lin plus those node terms
// against each ask; logits += SOLVE_STEP * g.
//
// One launch a solve: a cooperative launch of a grid that fits on the
// card at once (the host takes blocks a SM from nt_relax_occupancy),
// its phases separated by grid barriers (relax.cuh's header). Shards on
// distinct cards run the same phases one launch a phase a shard, and
// nt_relax_combine folds their statistics on the combining card.
#include <stddef.h>
#include <string.h>

#include "relax.cuh"

// ---------------------------------------------------------------- C API

// The launch's table as the host packs it (ops/relax.py): dims (i64)
// [mode, B, K, G, iters, stacked, shared, nseg, row_groups, pieces,
// cols, splits], then per segment [n, piece, pieces, piece0, col0]; ptrs the
// NT_RX_GPTRS pointers of NtRxArgs from ask_res to cnt in order, then
// per segment the NT_RX_SPTRS pointers of NtRxSeg from capacity to y.
#define NT_RX_GDIMS 12
#define NT_RX_SDIMS 5
#define NT_RX_GPTRS 24
#define NT_RX_SPTRS 22
static_assert(offsetof(NtRxArgs, cnt) - offsetof(NtRxArgs, ask_res) ==
                  (NT_RX_GPTRS - 1) * sizeof(void*),
              "NtRxArgs' pointers from ask_res to cnt");
static_assert(offsetof(NtRxSeg, y) - offsetof(NtRxSeg, capacity) ==
                  (NT_RX_SPTRS - 1) * sizeof(void*),
              "NtRxSeg's pointers from capacity to y");

static int nt_rx_args(int phase, float penalty, const long long* dims,
                      const void* const* ptrs, NtRxArgs* out) {
  NtRxArgs p = {};
  p.mode = (int)dims[0];
  p.phase = phase;
  p.B = (int)dims[1];
  p.K = (int)dims[2];
  p.G = (int)dims[3];
  p.iters = (int)dims[4];
  p.stacked = (int)dims[5];
  p.shared = (int)dims[6];
  p.nseg = (int)dims[7];
  p.row_groups = (int)dims[8];
  p.pieces = (int)dims[9];
  p.cols = (int)dims[10];
  p.splits = (int)dims[11];
  p.penalty = penalty;
  if (p.mode < NT_RX_PLACE || p.mode > NT_RX_LOOP || p.nseg < 1 ||
      p.nseg > NT_RX_SEGS || p.B < 1 || p.K < 1 || p.iters < 0 ||
      p.row_groups != (p.K + NT_RX_WARPS - 1) / NT_RX_WARPS ||
      p.splits < 1 || p.splits > NT_RX_SPLITS ||
      phase < NT_RX_ALL || phase > NT_RX_P)
    return (int)cudaErrorInvalidValue;
  memcpy((void*)&p.ask_res, ptrs, NT_RX_GPTRS * sizeof(void*));
  int pieces = 0, cols = 0;
  for (int s = 0; s < p.nseg; ++s) {
    const long long* d = dims + NT_RX_GDIMS + (size_t)s * NT_RX_SDIMS;
    NtRxSeg& sg = p.seg[s];
    sg.n = (int)d[0];
    sg.piece = (int)d[1];
    sg.pieces = (int)d[2];
    sg.piece0 = (int)d[3];
    sg.col0 = (int)d[4];
    if (sg.n < 1 || sg.piece < 1 || sg.pieces < 1 ||
        sg.pieces > NT_RX_PIECES_MAX ||
        (long long)sg.piece * (sg.pieces - 1) >= sg.n ||
        (long long)sg.piece * sg.pieces < sg.n || sg.piece0 != pieces ||
        sg.col0 != cols)
      return (int)cudaErrorInvalidValue;
    pieces += sg.pieces;
    cols += (sg.n + NT_RX_COL - 1) / NT_RX_COL;
    memcpy((void*)&sg.capacity, ptrs + NT_RX_GPTRS + (size_t)s * NT_RX_SPTRS,
           NT_RX_SPTRS * sizeof(void*));
  }
  if (pieces != p.pieces || cols != p.cols || !p.cnt ||
      (p.splits > 1 && !p.npart) || (phase == NT_RX_ALL && !p.bar))
    return (int)cudaErrorInvalidValue;
  *out = p;
  return 0;
}

static const void* nt_rx_fn(int float_mask) {
  return float_mask ? (const void*)nt_relax_kernel<true>
                    : (const void*)nt_relax_kernel<false>;
}

// Blocks of NT_RX_THREADS threads that fit on one SM at once.
NT_API int nt_relax_occupancy(int float_mask, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, nt_rx_fn(float_mask), NT_RX_THREADS, 0);
}

// phase -1: the whole solve, a cooperative launch of ``grid`` blocks (at
// most blocks a SM x SMs: a larger grid is refused, never run). Else
// one phase (0 prologue, 1 A, 2 B, 3 x, 4 y, 5 pref), an ordinary launch.
// float_mask: the mask is the caller's float array (mode 2) rather than
// the feasibility bytes the prologue writes.
NT_API int nt_relax_solve(int float_mask, int phase, int grid,
                          float penalty, const long long* dims,
                          const void* const* ptrs, void* stream) {
  NtRxArgs p;
  const int err = nt_rx_args(phase, penalty, dims, ptrs, &p);
  if (err) return err;
  if (grid < 1 || (float_mask != 0) != (p.mode == NT_RX_LOOP))
    return (int)cudaErrorInvalidValue;
  const void* fn = nt_rx_fn(float_mask);
  void* args[] = {(void*)&p};
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      phase == NT_RX_ALL
          ? cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(NT_RX_THREADS),
                                        args, 0, st)
          : cudaLaunchKernel(fn, dim3(grid), dim3(NT_RX_THREADS), args, 0,
                             st);
  // A refused launch is returned here; it must not stay behind as the
  // runtime's last error for the next entry to report.
  cudaGetLastError();
  return (int)e;
}

// Shards on distinct cards, on the combining card: part [W, count]
// float2 (m_s, s_s) folded in shard order into out [count] float2 (mode
// 0), or part [W, count] f32 maxima into out [count] (mode 1).
NT_API int nt_relax_combine(int W, int count, int mode, const void* part,
                            void* out, void* stream) {
  if (W <= 0 || count <= 0) return 0;
  const int threads = 256;
  nt_relax_combine_kernel<<<(count + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      W, count, mode, (const float*)part, (float*)out);
  return (int)cudaGetLastError();
}
