// K10b: the gang program's topology-group scatter-add over node shards
// (parallel/shard.py sharded_group_capacity in the JAX package: a
// shard_map of ops/gang.py _group_capacity, then a psum over the node
// axis). A gang slice can span shards, so each shard sums its own
// nodes' member units into a partial group vector, and the partials
// are added up.
//
// Two kernels:
// 1. nt_group_partial, launched once per shard on the shard's device:
//    zeroes the shard's partial row [g_pad], then walks the shard's
//    nodes chunk by chunk of 1024 (K7's group pass, common.cuh
//    nt_group_chunk): every thread loads one node's units and id into
//    shared memory, and each group id the chunk touches is summed by
//    one thread in node order. Ids < 0 or >= g_pad drop. So each
//    partial rounds in the order the plain version's index_add_ rounds
//    it, also past 2^24 (a zero ask gives every feasible node 1e9
//    units).
// 2. nt_group_combine, on the combining device: out[g] is the sum of
//    the W partial rows in shard order (the caller has brought the
//    rows to that device; on one card they already are).
// The shard-order sum equals the one-device node-order sum while every
// partial and every prefix is exact in float32 (whole numbers under
// 2^24), as the JAX psum's does.
//
// Bound on the card: bytes are tiny (8 B a node, 4 B a group a shard);
// the partial pass is one block a shard, and for one group a node
// (g_pad = N) each chunk is 1024 threads walking 1024 entries, so the
// issue rate of one SM bounds it. The combine is one thread a group.
#include "common.cuh"

#define NT_GROUP_THREADS 1024

__global__ void __launch_bounds__(NT_GROUP_THREADS) nt_group_partial_kernel(
    int N, int g_pad, const float* __restrict__ units,
    const int* __restrict__ topo_ids, float* __restrict__ partial) {
  __shared__ float s_units[NT_GROUP_THREADS];
  __shared__ int s_ids[NT_GROUP_THREADS];
  __shared__ int s_lo, s_hi;
  const int t = threadIdx.x;
  for (int g = t; g < g_pad; g += blockDim.x) partial[g] = 0.0f;
  for (int base = 0; base < N; base += blockDim.x) {
    const int n = base + t;
    nt_group_chunk(base, N, g_pad, n < N ? units[n] : 0.0f,
                   n < N ? topo_ids[n] : -1, partial, s_units, s_ids, &s_lo,
                   &s_hi);
  }
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

// One shard: units [N] f32, topo_ids [N] i32 (the shard's slice);
// partial [g_pad] f32, written whole.
NT_API int nt_group_partial(int N, int g_pad, const void* units,
                            const void* topo_ids, void* partial,
                            void* stream) {
  if (g_pad <= 0) return 0;
  nt_group_partial_kernel<<<1, NT_GROUP_THREADS, 0, (cudaStream_t)stream>>>(
      N, g_pad, (const float*)units, (const int*)topo_ids, (float*)partial);
  return (int)cudaGetLastError();
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
