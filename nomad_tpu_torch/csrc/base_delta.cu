// K4: the base delta — a row scatter-set of a cluster base's mutable
// arrays (ops/binpack.py apply_base_delta and the copy fused into
// batched_placement_program_compact_delta, in the JAX package). A
// storm's next snapshot differs from the device-resident parent in the
// few rows its plans touched: util [N,4], bw_used [N], ports_free [N]
// and node_ok [N] take the child's values at rows [R], and nothing
// else moves.
//
// The wrapper hands this kernel fresh copies of the parent's arrays
// (Tensor.clone, a plain copy): the parent may still be cached, and a
// dispatch on it may still be running. Padding rows (ROW_BUCKETS)
// repeat the first changed row with the same values, so duplicate
// writes store the same bytes and their order does not matter. A row
// outside [0, N) is dropped, as the JAX scatter's mode="drop" does.
//
// Shard form (K10a, parallel/shard.py sharded_base_delta in the JAX
// package): the arrays are one node shard's slice of N rows starting
// at global row lo; each global row index is rebased by -lo, and rows
// of other shards (and the pad) fall outside [0, N) and drop, so the
// replicated payload is launched once per shard.
//
// Bound on the card: bytes — the copies (~25 B a node) and R rows of
// 29 B; at N = 10,240 and R <= 4,096 well under a megabyte, a fraction
// of a microsecond at the HBM rate, so launch latency is what a call
// costs. Design: one thread per (row, column) of the seven columns
// (util's four, bw_used, ports_free, node_ok), so neighbouring threads
// write neighbouring addresses of a row.
#include "common.cuh"

#define NT_DELTA_THREADS 256
#define NT_DELTA_COLS 7

__global__ void __launch_bounds__(NT_DELTA_THREADS) nt_base_delta_kernel(
    int N, int R, int lo, const int* __restrict__ rows,
    const float* __restrict__ util_rows, const float* __restrict__ bw_rows,
    const float* __restrict__ ports_rows,
    const unsigned char* __restrict__ ok_rows, float* __restrict__ util,
    float* __restrict__ bw_used, float* __restrict__ ports_free,
    unsigned char* __restrict__ node_ok) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * NT_DELTA_COLS) return;
  const int r = t / NT_DELTA_COLS;
  const int c = t - r * NT_DELTA_COLS;
  const int row = rows[r] - lo;
  if (row < 0 || row >= N) return;
  if (c < 4) {
    util[(size_t)row * 4 + c] = util_rows[(size_t)r * 4 + c];
  } else if (c == 4) {
    bw_used[row] = bw_rows[r];
  } else if (c == 5) {
    ports_free[row] = ports_rows[r];
  } else {
    node_ok[row] = ok_rows[r];
  }
}

// rows [R] i32; util_rows [R,4] f32; bw_rows/ports_rows [R] f32;
// ok_rows [R] u8; util [N,4] f32, bw_used/ports_free [N] f32, node_ok
// [N] u8: the child's copies, set in place; lo the global row of
// their first row (0 unsharded).
NT_API int nt_base_delta(int N, int R, int lo, const void* rows,
                         const void* util_rows,
                         const void* bw_rows, const void* ports_rows,
                         const void* ok_rows, void* util, void* bw_used,
                         void* ports_free, void* node_ok, void* stream) {
  if (R <= 0) return 0;
  const int total = R * NT_DELTA_COLS;
  const int blocks = (total + NT_DELTA_THREADS - 1) / NT_DELTA_THREADS;
  nt_base_delta_kernel<<<blocks, NT_DELTA_THREADS, 0, (cudaStream_t)stream>>>(
      N, R, lo, (const int*)rows, (const float*)util_rows,
      (const float*)bw_rows,
      (const float*)ports_rows, (const unsigned char*)ok_rows, (float*)util,
      (float*)bw_used, (float*)ports_free, (unsigned char*)node_ok);
  return (int)cudaGetLastError();
}
