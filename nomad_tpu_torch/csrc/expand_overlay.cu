// K3: device-side overlay expansion (ops/binpack.py _expand_overlay in
// the JAX package): per eval, feasible[N, G] = verdicts[class_ids]
// where the class id is >= 0 (else false), then the patch rows are set
// from patch_vals; job_count[N] and tg_count[N, G] are scatter-adds of
// one at the job's alloc rows. Row index N (the padding) and anything
// else out of range is dropped, as mode="drop" does.
//
// Bound on the card: bytes — N x G mask and count writes plus the
// small gathers; a few hundred KB per eval at N = 10,240. Design: one
// block per eval (grid = B); phase 1 gathers the verdict row of every
// node and zeroes the counts; __syncthreads; phase 2 sets the patch
// rows and applies the job positions with atomicAdd (several allocs
// of one job on one node are real duplicates).
//
// Shard form (the overlay expansion under GSPMD over a node-sharded
// base): the outputs and class_ids are one node shard's N rows from
// global row lo; patch and job rows are rebased by -lo, and the pad
// (global N) and other shards' rows fall outside [0, N) and drop.
#include "common.cuh"

#define NT_EXPAND_THREADS 512

__global__ void __launch_bounds__(NT_EXPAND_THREADS) nt_expand_overlay_kernel(
    int N, int G, int C, int P, int J, int lo,
    const int* __restrict__ class_ids,
    const unsigned char* __restrict__ verdicts,
    const int* __restrict__ patch_rows,
    const unsigned char* __restrict__ patch_vals,
    const int* __restrict__ job_rows, const int* __restrict__ job_tgs,
    unsigned char* feasible, int* job_count, int* tg_count) {
  const size_t b = blockIdx.x;
  verdicts += b * C * G;
  patch_rows += b * P;
  patch_vals += b * P * G;
  job_rows += b * J;
  job_tgs += b * J;
  feasible += b * N * G;
  job_count += b * N;
  tg_count += b * N * G;

  for (int r = threadIdx.x; r < N; r += blockDim.x) {
    int cid = class_ids[r];
    if (cid >= C) cid = C - 1;  // gathers clamp, as XLA's do
    for (int g = 0; g < G; ++g) {
      feasible[(size_t)r * G + g] =
          cid >= 0 ? verdicts[(size_t)cid * G + g] : (unsigned char)0;
      tg_count[(size_t)r * G + g] = 0;
    }
    job_count[r] = 0;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const int row = patch_rows[p] - lo;
    if (row < 0 || row >= N) continue;
    for (int g = 0; g < G; ++g)
      feasible[(size_t)row * G + g] = patch_vals[(size_t)p * G + g];
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const int row = job_rows[j] - lo;
    if (row < 0 || row >= N) continue;
    atomicAdd(&job_count[row], 1);
    const int tg = job_tgs[j];
    if (tg >= 0 && tg < G) atomicAdd(&tg_count[(size_t)row * G + tg], 1);
  }
}

// class_ids [N] i32; verdicts [B,C,G] u8; patch_rows [B,P] i32;
// patch_vals [B,P,G] u8; job_rows/job_tgs [B,J] i32; out feasible
// [B,N,G] u8, job_count [B,N] i32, tg_count [B,N,G] i32; lo the
// global row of the outputs' first row (0 unsharded).
NT_API int nt_expand_overlay(int B, int N, int G, int C, int P, int J,
                             int lo,
                             const void* class_ids, const void* verdicts,
                             const void* patch_rows, const void* patch_vals,
                             const void* job_rows, const void* job_tgs,
                             void* feasible, void* job_count, void* tg_count,
                             void* stream) {
  if (B <= 0) return 0;
  nt_expand_overlay_kernel<<<B, NT_EXPAND_THREADS, 0, (cudaStream_t)stream>>>(
      N, G, C, P, J, lo, (const int*)class_ids, (const unsigned char*)verdicts,
      (const int*)patch_rows, (const unsigned char*)patch_vals,
      (const int*)job_rows, (const int*)job_tgs, (unsigned char*)feasible,
      (int*)job_count, (int*)tg_count);
  return (int)cudaGetLastError();
}
