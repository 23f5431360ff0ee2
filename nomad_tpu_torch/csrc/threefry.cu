// K0: threefry2x32 uniform noise, bit-identical to
// jax.random.uniform(key, shape, minval, maxval) for float32 under
// jax_threefry_partitionable=True (the JAX package draws it at
// ops/binpack.py:320 and :384).
//
// Element i of the flattened shape hashes the 64-bit counter i, split
// (hi, lo) = (i >> 32, i & 0xffffffff), under the raw key (k0, k1);
// the 32 random bits are the XOR of the two output words. The float
// is (bits >> 9 | 0x3f800000) - 1 in [0, 1), scaled to
// [minval, maxval) and clamped below at minval, as jax/_src/random.py
// _uniform does. XLA contracts its f * (maxval - minval) + minval into
// one fused multiply-add, so the scaling here is fmaf (for the noise's
// minval of 0 the two roundings agree anyway).
//
// A column window (lo, cols of total_cols) draws one node shard's
// columns of the full draw: element (r, j) hashes counter
// r * total_cols + lo + j, so W shards' windows are exactly the full
// [rows, total_cols] draw's columns (parallel/shard.py).
//
// Bound on the card: 20 rounds of 32-bit add/rotate/xor per element
// against one 4-byte store; integer-ALU bound. Design: one thread per
// element over a grid-stride loop, no shared memory, coalesced stores.
#include "common.cuh"

__device__ __forceinline__ uint32_t nt_rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

#define NT_ROUND(r)   \
  x0 += x1;           \
  x1 = nt_rotl(x1, r); \
  x1 ^= x0;

__device__ __forceinline__ void nt_threefry2x32(uint32_t k0, uint32_t k1,
                                                uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  NT_ROUND(13) NT_ROUND(15) NT_ROUND(26) NT_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  NT_ROUND(17) NT_ROUND(29) NT_ROUND(16) NT_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  NT_ROUND(13) NT_ROUND(15) NT_ROUND(26) NT_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  NT_ROUND(17) NT_ROUND(29) NT_ROUND(16) NT_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  NT_ROUND(13) NT_ROUND(15) NT_ROUND(26) NT_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
}

__global__ void nt_threefry_uniform_kernel(const long long* __restrict__ keys,
                                           float* __restrict__ out,
                                           long long rows, long long cols,
                                           long long total_cols, long long lo,
                                           int batch, float minval,
                                           float scale) {
  const long long per_eval = rows * cols;
  const long long total = per_eval * (long long)batch;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += step) {
    const long long b = t / per_eval;
    const long long e = t - b * per_eval;
    const long long r = e / cols;
    // The element's counter in the full [rows, total_cols] draw.
    const unsigned long long i =
        (unsigned long long)(r * total_cols + lo + (e - r * cols));
    const uint32_t k0 = (uint32_t)keys[2 * b];
    const uint32_t k1 = (uint32_t)keys[2 * b + 1];
    uint32_t x0 = (uint32_t)(i >> 32);
    uint32_t x1 = (uint32_t)i;
    nt_threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
    const float v = fmaf(f, scale, minval);
    out[t] = fmaxf(minval, v);
  }
}

// keys: int64[B, 2] holding the uint32 key words; out: float32[B, rows,
// cols], the column window [lo, lo + cols) of a [rows, total_cols]
// draw per key (lo = 0 and cols = total_cols: the whole draw).
NT_API int nt_threefry_uniform(const void* keys, void* out, long long rows,
                               long long cols, long long total_cols,
                               long long lo, int batch, float minval,
                               float scale, void* stream) {
  const long long total = rows * cols * (long long)batch;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  nt_threefry_uniform_kernel<<<(int)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const long long*)keys, (float*)out, rows, cols, total_cols, lo, batch,
      minval, scale);
  return (int)cudaGetLastError();
}
