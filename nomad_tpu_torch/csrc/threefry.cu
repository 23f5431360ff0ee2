// K0: threefry2x32 uniform noise, bit-identical to
// jax.random.uniform(key, shape, minval, maxval) for float32 under
// jax_threefry_partitionable=True (the JAX package draws it at
// ops/binpack.py:320 and :384). Each element is csrc/common.cuh's
// nt_noise_at of its counter.
//
// Element (b, r, j) of a [B, rows, cols] draw hashes, under keys[b],
// the 64-bit counter r * total_cols + lo + j: a column window (lo, cols
// of total_cols) draws one node shard's columns of the full [rows,
// total_cols] draw (parallel/shard.py), and lo = 0, cols = total_cols
// is the whole draw.
//
// The uniform top-K draws its own noise (csrc/uniform_topk.cu), as the
// greedy scan does on launches whose CTAs each hash few enough nodes a
// step (csrc/greedy_scan.cu, ops/scan.py draws); this kernel serves the
// greedy scan's other launches (one cluster on 16 SMs hashes slower
// than this kernel on all of them) and the consumers that keep a noise
// tensor: the gang scan (K7), the convex rounding scan (K8b), the
// preemption scan (K6) and the node-sharded scans' windows (K10c,
// K10e, K10g-b, K10d's per-shard path).
//
// Bound on the card: integer instructions, ~80 an element (20 rounds
// of add, funnel-shift rotate and xor, the key injections, the float)
// against one 4-byte store; chip_smoke.py restates it from this
// kernel's SASS. Design:
//
// - A block owns one (eval, row) pair (gridDim.x, which holds more than
//   the 65,535 pairs of B = 64 x K = 1,024) and a run of 4 x blockDim.x
//   columns (gridDim.y). The pair's key words load once a block and its
//   64-bit counter base r * total_cols + lo is formed once a block: no
//   division of a 64-bit index an element, column offsets 32-bit.
// - Each thread hashes four consecutive counters (independent chains,
//   so their instructions interleave) and writes them with one 16-byte
//   store: the row's columns from its first 16-byte boundary on, in
//   groups of four; the up to three columns before that boundary and
//   the up to three after the last whole group are written one by one
//   by the first block of the row.
#include "common.cuh"

// Most threads a block; columns a thread.
#define NT_TF_THREADS 256
#define NT_TF_PER 4

__global__ void __launch_bounds__(NT_TF_THREADS) nt_threefry_uniform_kernel(
    const long long* __restrict__ keys, float* __restrict__ out, int rows,
    int cols, long long total_cols, long long lo, float minval,
    float scale) {
  __shared__ uint32_t key[2];
  const unsigned pair = blockIdx.x;
  const unsigned b = pair / (unsigned)rows;
  const unsigned r = pair - b * (unsigned)rows;
  if (threadIdx.x < 2) key[threadIdx.x] = (uint32_t)keys[2 * b + threadIdx.x];
  __syncthreads();
  const uint32_t k0 = key[0], k1 = key[1];
  const unsigned long long base = (unsigned long long)r * total_cols + lo;
  float* row = out + (size_t)pair * cols;
  // Columns before the row's first 16-byte boundary, the whole groups
  // of four after it, and the columns left over.
  const unsigned mis = (unsigned)((uintptr_t)row & 15u);
  const int head = min(cols, (int)(((16u - mis) & 15u) >> 2));
  const int body = (cols - head) & ~(NT_TF_PER - 1);
  const int tail = cols - head - body;
  const int q = (int)(blockIdx.y * blockDim.x + threadIdx.x);
  if (NT_TF_PER * q < body) {
    const unsigned j = (unsigned)(head + NT_TF_PER * q);
    float v[NT_TF_PER];
#pragma unroll
    for (int u = 0; u < NT_TF_PER; ++u)
      v[u] = nt_noise_at(k0, k1, base + (j + u), minval, scale);
    *(float4*)(row + j) = make_float4(v[0], v[1], v[2], v[3]);
  }
  if (blockIdx.y == 0 && (int)threadIdx.x < head + tail) {
    const int t = (int)threadIdx.x;
    const unsigned e = (unsigned)(t < head ? t : body + t);
    row[e] = nt_noise_at(k0, k1, base + e, minval, scale);
  }
}

// keys: int64[B, 2] holding the uint32 key words; out: float32[B, rows,
// cols], the column window [lo, lo + cols) of a [rows, total_cols] draw
// per key. The launch (ops/prng.py noise_launch): B x rows blocks along
// x, ``runs`` along y, ``threads`` a block, with runs x threads x 4 >=
// cols.
NT_API int nt_threefry_uniform(const void* keys, void* out, int rows,
                               int cols, long long total_cols, long long lo,
                               int batch, int runs, int threads, float minval,
                               float scale, void* stream) {
  if ((long long)rows * cols * batch <= 0) return 0;
  if (threads < 32 || threads > NT_TF_THREADS || threads % 32 != 0 ||
      runs < 1 || runs > 65535 ||
      (long long)runs * threads * NT_TF_PER < cols ||
      (long long)rows * batch > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  nt_threefry_uniform_kernel<<<dim3((unsigned)(rows * batch), (unsigned)runs),
                               threads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, (float*)out, rows, cols, total_cols, lo, minval,
      scale);
  return (int)cudaGetLastError();
}
