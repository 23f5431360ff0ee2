// K4: the base delta — a row scatter-set of a cluster base's mutable
// arrays (ops/binpack.py apply_base_delta and the copy fused into
// batched_placement_program_compact_delta, in the JAX package). A
// storm's next snapshot differs from the device-resident parent in the
// few rows its plans touched: util [N,4], bw_used [N], ports_free [N]
// and node_ok [N] take the child's values at rows [R], and nothing
// else moves.
//
// nt_base_delta (K4): one launch and one allocation a call. The
// wrapper allocates the four child arrays as 16-byte-aligned views of
// one buffer (the parent may still be cached, and a dispatch on it may
// still be running, so it is only read); the kernel runs over node
// tiles of NT_DELTA_TILE nodes, a CTA each: it copies its tile of the
// parent into the child, and after a block barrier reads the R payload
// row indices (from L2 after the first CTA) and sets the rows that
// land in its tile. Padding rows (ROW_BUCKETS) repeat a real row with
// the same values, so duplicate writes store the same bytes and their
// order does not matter. A row outside [0, N) is dropped, as the JAX
// scatter's mode="drop" does. Bound on the card: bytes — the
// parent read and the child written once (25 B a node) and the R
// payload rows (29 B); at N = 10,240 and R <= 4,096 well under a
// megabyte, a fraction of a microsecond at the HBM rate, so the host's
// issue of the call is its cost: the design makes it one allocation and
// one launch (four copies and a scatter before).
//
// nt_base_delta_shards (K10a, parallel/shard.py sharded_base_delta in
// the JAX package): the same delta over the node shards of one card
// in ONE launch, copy and scatter fused. A __grid_constant__ table
// holds each shard's global row lo, its rows, its four parent arrays
// and its four child arrays (views of one allocation the wrapper
// makes for the card). The kernel writes every child in gather form:
// a thread owns a node, finds the node's global row in the payload's
// rows (sorted on the host, with each one's payload index; in shared
// memory where they fit) by binary search, and stores the payload's
// values there, else the parent's. Rows outside every shard match no
// node and drop; a padding row repeats a real row with identical
// values, so whichever duplicate the search finds writes the same
// bytes. The parent is only read. Bound: bytes — 25 B a node read and
// 25 written, plus the table; the call is one launch in place of W
// launches and 4 W copies.
#include "common.cuh"

#define NT_DELTA_THREADS 256
// Nodes a CTA.
#define NT_DELTA_TILE 512

__global__ void __launch_bounds__(NT_DELTA_THREADS) nt_base_delta_kernel(
    int N, int R, const int* __restrict__ rows,
    const float4* __restrict__ util_rows, const float* __restrict__ bw_rows,
    const float* __restrict__ ports_rows,
    const unsigned char* __restrict__ ok_rows,
    const float4* __restrict__ util, const float* __restrict__ bw_used,
    const float* __restrict__ ports_free,
    const unsigned char* __restrict__ node_ok, float4* __restrict__ c_util,
    float* __restrict__ c_bw_used, float* __restrict__ c_ports_free,
    unsigned char* __restrict__ c_node_ok) {
  const int t = threadIdx.x;
  const int first = blockIdx.x * NT_DELTA_TILE;
  const int end = min(first + NT_DELTA_TILE, N);
  for (int i = first + t; i < end; i += NT_DELTA_THREADS) {
    c_util[i] = util[i];
    c_bw_used[i] = bw_used[i];
    c_ports_free[i] = ports_free[i];
    c_node_ok[i] = node_ok[i];
  }
  // The tile's copy is in before any of its rows is set.
  __syncthreads();
  for (int j = t; j < R; j += NT_DELTA_THREADS) {
    const int row = rows[j];
    if (row < first || row >= end) continue;
    c_util[row] = util_rows[j];
    c_bw_used[row] = bw_rows[j];
    c_ports_free[row] = ports_rows[j];
    c_node_ok[row] = ok_rows[j];
  }
}

// rows [R] i32; util_rows [R,4] f32; bw_rows/ports_rows [R] f32;
// ok_rows [R] u8; util [N,4] f32, bw_used/ports_free [N] f32, node_ok
// [N] u8: the parent's (read only), then the child's (written whole).
// util_rows, util and c_util 16-byte aligned.
NT_API int nt_base_delta(int N, int R, const void* rows,
                         const void* util_rows, const void* bw_rows,
                         const void* ports_rows, const void* ok_rows,
                         const void* util, const void* bw_used,
                         const void* ports_free, const void* node_ok,
                         void* c_util, void* c_bw_used, void* c_ports_free,
                         void* c_node_ok, void* stream) {
  if (N < 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (((uintptr_t)util | (uintptr_t)c_util |
       (R > 0 ? (uintptr_t)util_rows : 0)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int blocks = (N + NT_DELTA_TILE - 1) / NT_DELTA_TILE;
  nt_base_delta_kernel<<<blocks, NT_DELTA_THREADS, 0, (cudaStream_t)stream>>>(
      N, R, (const int*)rows, (const float4*)util_rows,
      (const float*)bw_rows, (const float*)ports_rows,
      (const unsigned char*)ok_rows, (const float4*)util,
      (const float*)bw_used, (const float*)ports_free,
      (const unsigned char*)node_ok, (float4*)c_util, (float*)c_bw_used,
      (float*)c_ports_free, (unsigned char*)c_node_ok);
  return (int)cudaGetLastError();
}

#define NT_DSEG_MAX 32
#define NT_DSEG_THREADS 256
#define NT_DSEG_SMEM_MAX (227 * 1024)

struct NtDeltaSeg {
  long long lo, n;
  const float4* util;
  const float* bw_used;
  const float* ports_free;
  const unsigned char* node_ok;
  float4* c_util;
  float* c_bw_used;
  float* c_ports_free;
  unsigned char* c_node_ok;
};
#define NT_DSEG_PTRS 8

struct NtDeltaArgs {
  int R, table_smem;
  const int* rows;   // [R] ascending
  const int* order;  // [R]: the payload index of each sorted row
  const float4* util_rows;
  const float* bw_rows;
  const float* ports_rows;
  const unsigned char* ok_rows;
  NtDeltaSeg seg[NT_DSEG_MAX];
};

__global__ void __launch_bounds__(NT_DSEG_THREADS)
    nt_delta_gather_kernel(const __grid_constant__ NtDeltaArgs p) {
  extern __shared__ int s_table[];
  const NtDeltaSeg& sg = p.seg[blockIdx.y];
  const long long first = (long long)blockIdx.x * NT_DSEG_THREADS;
  if (first >= sg.n) return;  // the whole block: a shorter shard
  const int R = p.R;
  const int* rows = p.rows;
  const int* order = p.order;
  if (p.table_smem) {
    for (int i = threadIdx.x; i < R; i += NT_DSEG_THREADS) {
      s_table[i] = p.rows[i];
      s_table[R + i] = p.order[i];
    }
    __syncthreads();
    rows = s_table;
    order = s_table + R;
  }
  const long long i = first + threadIdx.x;
  if (i >= sg.n) return;
  const long long row = sg.lo + i;
  int lo = 0, hi = R;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] < row)
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo < R && rows[lo] == row) {
    const int r = order[lo];
    sg.c_util[i] = p.util_rows[r];
    sg.c_bw_used[i] = p.bw_rows[r];
    sg.c_ports_free[i] = p.ports_rows[r];
    sg.c_node_ok[i] = p.ok_rows[r];
  } else {
    sg.c_util[i] = sg.util[i];
    sg.c_bw_used[i] = sg.bw_used[i];
    sg.c_ports_free[i] = sg.ports_free[i];
    sg.c_node_ok[i] = sg.node_ok[i];
  }
}

// The shards of one card: seg_dims [S,2] i64 (lo, rows) and seg_ptrs
// [S,8] (util [n,4] f32, bw_used, ports_free [n] f32, node_ok [n] u8:
// the parent's, then the child's in the same order) are host arrays;
// rows [R] i32 ascending, order [R] i32 (the payload index of each),
// util_rows [R,4] f32, bw_rows/ports_rows [R] f32, ok_rows [R] u8 the
// payload on this card. table_smem: keep (rows, order) in shared
// memory (8 R bytes; refused past 227 KB), else search them in device
// memory. util pointers 16-byte aligned.
NT_API int nt_base_delta_shards(int S, int R, int table_smem,
                                const long long* seg_dims,
                                const void* const* seg_ptrs, const void* rows,
                                const void* order, const void* util_rows,
                                const void* bw_rows, const void* ports_rows,
                                const void* ok_rows, void* stream) {
  if (S <= 0) return 0;
  if (S > NT_DSEG_MAX || R < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = table_smem ? (size_t)R * 8 : 0;
  if (smem > NT_DSEG_SMEM_MAX) return (int)cudaErrorInvalidValue;
  NtDeltaArgs p = {};
  p.R = R;
  p.table_smem = table_smem;
  p.rows = (const int*)rows;
  p.order = (const int*)order;
  p.util_rows = (const float4*)util_rows;
  p.bw_rows = (const float*)bw_rows;
  p.ports_rows = (const float*)ports_rows;
  p.ok_rows = (const unsigned char*)ok_rows;
  if (R > 0 && ((uintptr_t)util_rows & 15))
    return (int)cudaErrorMisalignedAddress;
  long long most = 0;
  for (int s = 0; s < S; ++s) {
    NtDeltaSeg& sg = p.seg[s];
    const void* const* q = seg_ptrs + (size_t)s * NT_DSEG_PTRS;
    sg.lo = seg_dims[2 * s];
    sg.n = seg_dims[2 * s + 1];
    sg.util = (const float4*)q[0];
    sg.bw_used = (const float*)q[1];
    sg.ports_free = (const float*)q[2];
    sg.node_ok = (const unsigned char*)q[3];
    sg.c_util = (float4*)q[4];
    sg.c_bw_used = (float*)q[5];
    sg.c_ports_free = (float*)q[6];
    sg.c_node_ok = (unsigned char*)q[7];
    if (((uintptr_t)q[0] | (uintptr_t)q[4]) & 15)
      return (int)cudaErrorMisalignedAddress;
    most = sg.n > most ? sg.n : most;
  }
  if (most == 0) return 0;
  const long long per = NT_DSEG_THREADS;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)nt_delta_gather_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nt_delta_gather_kernel<<<dim3((unsigned)((most + per - 1) / per),
                                (unsigned)S),
                           NT_DSEG_THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
