// K10b: the gang program's topology-group scatter-add over node shards
// (parallel/shard.py sharded_group_capacity in the JAX package: a
// shard_map of ops/gang.py _group_capacity, then a psum over the node
// axis). A gang slice can span shards, so each shard sums its own
// nodes' member units into a partial group vector, and the partials
// are added up in shard order.
//
// Semantics, kept bit for bit from the plain version: each shard's
// partial sums its nodes in node order (ids < 0 or >= g_pad drop, a
// zero addend is skipped: adding +-0 to a sum that starts at +0 leaves
// its bits as they are), and the W partials add up in shard order
// (__fadd_rn). So the result equals the plain version's in every case,
// also past 2^24 (a zero ask gives every feasible node 1e9 units),
// where every addition rounds and the order decides the bits.
//
// Two kernels:
// 1. nt_group_capacity: ONE launch for all the shards of one card, one
//    CTA a shard, the shards' (rows, units, ids, partial row) in a
//    __grid_constant__ segment table. Each CTA builds its shard's
//    partial one of two ways:
//    - exact: where every addend is a whole number >= 0 and every
//      group's sum stays under 2^24, every order of the additions is
//      exact and gives the same bits, so all 1,024 threads add their
//      nodes by atomics (one pass over the shard, then a check of the
//      sums; a sum at or past 2^24 means the exact sum is, since
//      rounding is monotone);
//    - ordered: otherwise (the 1e9 units of a zero ask, fractions) the
//      block stages a chunk of ids and units in shared memory, and one
//      warp walks it in node order, 32 nodes a step; __match_any_sync
//      gathers the lanes that share a group, and the lowest of them
//      folds their units in lane order (a shuffle a lane) into the
//      group's running sum, so each sum rounds exactly as the
//      node-order walk rounds it.
//    The partial lives in shared memory where it fits beside the chunk
//    (smem_partial), else in its device-memory row. Each CTA leaves its
//    partial in its row, then:
//    - combine (the shards of one card): the last CTA to finish (a
//      fence and a counter that it resets) adds the rows in shard order;
//    - partials (shards on distinct cards): the caller brings the rows
//      to the combining card.
//    The caller (parallel/shard.py group_capacity_plan) picks the path,
//    the chunk and where the partial lives; the entry refuses what does
//    not fit. The kernel has no static shared memory, so the dynamic
//    block may take all of NT_GC_SMEM_MAX.
// 2. nt_group_combine, on the combining card for the distinct-card
//    path only: out[g] is the sum of the W partial rows in shard order.
//
// Bound on the card: bytes are tiny (8 B a node, 4 B a group a shard,
// 37 ns at 10,240 nodes); a call costs its launch, a pass over a shard
// (the ordered walk: a dependent step a 32 nodes, up to 32 dependent
// additions a step where lanes share a group) and the last CTA's
// combine.
#include "common.cuh"

#define NT_GC_THREADS 1024
#define NT_GC_SEGS 32
#define NT_GC_CHUNK 4096
#define NT_GC_SMEM_MAX (227 * 1024)
#define NT_GC_COMBINE 4

enum { NT_GC_PATH_COMBINE = 0, NT_GC_PATH_PARTIALS = 1 };

struct NtGcSeg {
  long long n;
  const float* units;
  const int* ids;
  float* row;  // [g_pad]: this shard's partial in device memory
};

struct NtGcArgs {
  int S, g_pad, chunk, path, smem_partial;
  float* out;
  unsigned int* counter;
  NtGcSeg seg[NT_GC_SEGS];
};

static size_t nt_gc_smem(int chunk, int g_pad, int smem_partial) {
  return (size_t)chunk * 8 + (smem_partial ? (size_t)g_pad * 4 : 0);
}

__global__ void __launch_bounds__(NT_GC_THREADS)
    nt_group_capacity_kernel(const __grid_constant__ NtGcArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const NtGcSeg sg = p.seg[blockIdx.x];
  const int g_pad = p.g_pad;
  int* s_ids = (int*)smem;
  float* s_units = (float*)(s_ids + p.chunk);
  float* sums = p.smem_partial ? s_units + p.chunk : sg.row;
  for (int g = t; g < g_pad; g += NT_GC_THREADS) sums[g] = 0.0f;
  __syncthreads();
  // Exact: atomics in any order, while every addend is whole and >= 0.
  bool whole = true;
  for (long long i = t; i < sg.n; i += NT_GC_THREADS) {
    const int id = sg.ids[i];
    const float u = sg.units[i];
    if (id < 0 || id >= g_pad || u == 0.0f) continue;
    if (u >= 0.0f && u == truncf(u))
      atomicAdd(sums + id, u);
    else
      whole = false;
  }
  bool exact = __syncthreads_and(whole);
  if (exact) {
    bool past = false;
    for (int g = t; g < g_pad; g += NT_GC_THREADS)
      past = past || !(sums[g] < 16777216.0f);
    exact = !__syncthreads_or(past);
  }
  if (!exact) {
    // Ordered: warp 0 walks the shard in node order.
    for (int g = t; g < g_pad; g += NT_GC_THREADS) sums[g] = 0.0f;
    for (long long base = 0; base < sg.n; base += p.chunk) {
      const int m = sg.n - base < p.chunk ? (int)(sg.n - base) : p.chunk;
      __syncthreads();
      for (int i = t; i < m; i += NT_GC_THREADS) {
        s_ids[i] = sg.ids[base + i];
        s_units[i] = sg.units[base + i];
      }
      __syncthreads();
      if (t >= 32) continue;
      for (int b = 0; b < m; b += 32) {
        const int i = b + lane;
        const int id = i < m ? s_ids[i] : -1;
        const float u = i < m ? s_units[i] : 0.0f;
        const bool valid = id >= 0 && id < g_pad && u != 0.0f;
        const unsigned mask =
            __match_any_sync(full, valid ? id : -1 - lane);
        const bool lead = valid && lane == __ffs(mask) - 1;
        float acc = lead ? sums[id] : 0.0f;
        if (__any_sync(full, valid && (mask & (mask - 1)))) {
          // Some group has several lanes: fold them in lane order.
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const float v = __shfl_sync(full, u, k);
            if ((mask >> k) & 1u) acc = __fadd_rn(acc, v);
          }
        } else {
          acc = __fadd_rn(acc, u);
        }
        if (lead) sums[id] = acc;
        __syncwarp();
      }
    }
    __syncthreads();
  }
  if (p.smem_partial)
    for (int g = t; g < g_pad; g += NT_GC_THREADS) sg.row[g] = sums[g];
  if (p.path == NT_GC_PATH_PARTIALS) return;
  __threadfence();
  __syncthreads();
  const bool last = __syncthreads_or(
      t == 0 && atomicAdd(p.counter, 1u) == (unsigned)(p.S - 1));
  if (!last) return;
  __threadfence();
  // The last CTA adds the rows in shard order, NT_GC_COMBINE groups a
  // thread at a time so that their loads are in flight together.
  for (int g0 = t; g0 < g_pad; g0 += NT_GC_COMBINE * NT_GC_THREADS) {
    float acc[NT_GC_COMBINE];
#pragma unroll
    for (int q = 0; q < NT_GC_COMBINE; ++q) {
      const int g = g0 + q * NT_GC_THREADS;
      acc[q] = g < g_pad ? __ldcg(p.seg[0].row + g) : 0.0f;
    }
#pragma unroll 4
    for (int r = 1; r < p.S; ++r) {
      float v[NT_GC_COMBINE];
#pragma unroll
      for (int q = 0; q < NT_GC_COMBINE; ++q) {
        const int g = g0 + q * NT_GC_THREADS;
        v[q] = g < g_pad ? __ldcg(p.seg[r].row + g) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < NT_GC_COMBINE; ++q)
        acc[q] = __fadd_rn(acc[q], v[q]);
    }
#pragma unroll
    for (int q = 0; q < NT_GC_COMBINE; ++q) {
      const int g = g0 + q * NT_GC_THREADS;
      if (g < g_pad) p.out[g] = acc[q];
    }
  }
  if (t == 0) *p.counter = 0u;
}

// The shards of one card: seg_n [S] i64 (rows a shard) and seg_ptrs
// [S,3] (units [n] f32, ids [n] i32, partial row [g_pad] f32) are host
// arrays. path: 0 combine (counter a zeroed u32 on the card, left
// zeroed; out [g_pad] f32), 1 partials (out unused). chunk: the nodes
// staged at a time, a power of two <= 4,096. smem_partial: build the
// partial in shared memory (chunk * 8 + g_pad * 4 bytes, at most
// NT_GC_SMEM_MAX) before writing it to its row.
NT_API int nt_group_capacity(int S, int g_pad, int path, int chunk,
                             int smem_partial, const long long* seg_n,
                             const void* const* seg_ptrs, void* out,
                             void* counter, void* stream) {
  if (S <= 0 || g_pad <= 0) return 0;
  if (S > NT_GC_SEGS || chunk < 2 || chunk > NT_GC_CHUNK ||
      (chunk & (chunk - 1)) || path < 0 || path > 1 ||
      (path == NT_GC_PATH_COMBINE && (!counter || !out)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = nt_gc_smem(chunk, g_pad, smem_partial);
  if (smem > NT_GC_SMEM_MAX) return (int)cudaErrorInvalidValue;
  NtGcArgs p = {};
  p.S = S;
  p.g_pad = g_pad;
  p.chunk = chunk;
  p.path = path;
  p.smem_partial = smem_partial;
  p.out = (float*)out;
  p.counter = (unsigned int*)counter;
  for (int s = 0; s < S; ++s) {
    const void* const* q = seg_ptrs + (size_t)s * 3;
    p.seg[s].n = seg_n[s];
    p.seg[s].units = (const float*)q[0];
    p.seg[s].ids = (const int*)q[1];
    p.seg[s].row = (float*)q[2];
    if (!p.seg[s].row) return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        nt_group_capacity_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nt_group_capacity_kernel<<<S, NT_GC_THREADS, smem,
                             (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

__global__ void nt_group_combine_kernel(int W, int g_pad,
                                        const float* __restrict__ partials,
                                        float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= g_pad) return;
  float acc = partials[g];
  for (int s = 1; s < W; ++s)
    acc = __fadd_rn(acc, partials[(size_t)s * g_pad + g]);
  out[g] = acc;
}

// partials [W, g_pad] f32 in shard order; out [g_pad] f32.
NT_API int nt_group_combine(int W, int g_pad, const void* partials,
                            void* out, void* stream) {
  if (g_pad <= 0 || W <= 0) return 0;
  const int threads = 256;
  nt_group_combine_kernel<<<(g_pad + threads - 1) / threads, threads, 0,
                            (cudaStream_t)stream>>>(
      W, g_pad, (const float*)partials, (float*)out);
  return (int)cudaGetLastError();
}
