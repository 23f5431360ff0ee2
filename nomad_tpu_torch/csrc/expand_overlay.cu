// K3: device-side overlay expansion (ops/binpack.py _expand_overlay in
// the JAX package): per eval, feasible[N, G] = verdicts[class_ids]
// where the class id is >= 0 (else false; ids past the C classes clamp
// to the last, as XLA's gathers do), then the patch rows are set from
// patch_vals; job_count[N] and tg_count[N, G] are scatter-adds of one
// at the job's alloc rows. Row index N (the padding) and anything else
// out of range is dropped, as mode="drop" does.
//
// Bound on the card: bytes — N x G mask and count writes plus the
// small gathers; a few hundred KB per eval at N = 10,240. Design: a
// grid over (node tile, eval, group window), so one eval fills many
// SMs. A CTA owns ``tile`` rows and ``groups`` task groups (all G
// where 32 rows of them fit, else a window: any G runs) of one eval
// and builds them in shared memory: the verdict rows of its nodes
// gathered, the counts zeroed; one barrier; the eval's P patch rows
// and J job rows walked, each applied only where it lands in the tile
// and window (several allocs of one job on one node are real
// duplicates: shared-memory atomics); one barrier; then feasible,
// job_count (by the first window's CTAs) and tg_count written once
// each, coalesced, with no global atomic and no second pass over
// device memory.
//
// Shard form (the overlay expansion under GSPMD over a node-sharded
// base): the outputs and class_ids are one node shard's N rows from
// global row lo; patch and job rows are rebased by -lo, and the pad
// (global N) and other shards' rows fall outside [0, N) and drop.
#include "common.cuh"

#define NT_EXPAND_THREADS 256
// Shared memory a CTA may take without opting in (48 KB).
#define NT_EXPAND_SMEM_MAX (48 * 1024)

// A tile's shared memory: tg_count [tile][groups] i32, job_count
// [tile] i32, feasible [tile][groups] u8.
__host__ __device__ inline size_t nt_expand_smem(int tile, int groups) {
  return (size_t)tile * groups * 4 + (size_t)tile * 4 +
         (size_t)tile * groups;
}

__global__ void __launch_bounds__(NT_EXPAND_THREADS) nt_expand_overlay_kernel(
    int N, int G, int C, int P, int J, int lo, int tile, int groups,
    const int* __restrict__ class_ids,
    const unsigned char* __restrict__ verdicts,
    const int* __restrict__ patch_rows,
    const unsigned char* __restrict__ patch_vals,
    const int* __restrict__ job_rows, const int* __restrict__ job_tgs,
    unsigned char* __restrict__ feasible, int* __restrict__ job_count,
    int* __restrict__ tg_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_tgc = (int*)smem;
  int* s_jc = s_tgc + (size_t)tile * groups;
  unsigned char* s_feas = (unsigned char*)(s_jc + tile);
  const int r0 = blockIdx.x * tile;
  const int rows = min(tile, N - r0);
  const int g0 = blockIdx.z * groups;
  const int gs = min(groups, G - g0);
  const int cells = rows * gs;
  const size_t b = blockIdx.y;
  verdicts += b * C * G + g0;
  patch_rows += b * P;
  patch_vals += b * P * G + g0;
  job_rows += b * J;
  job_tgs += b * J;

  for (int x = threadIdx.x; x < cells; x += blockDim.x) {
    const int r = x / gs, g = x - r * gs;
    int cid = class_ids[r0 + r];
    if (cid >= C) cid = C - 1;  // gathers clamp, as XLA's do
    s_feas[x] = cid >= 0 ? verdicts[(size_t)cid * G + g] : (unsigned char)0;
    s_tgc[x] = 0;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) s_jc[r] = 0;
  __syncthreads();
  // The patch rows are distinct (models/matrix.py), so no two patches
  // of an eval race for a row.
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    const long long row = (long long)patch_rows[p] - lo - r0;
    if (row < 0 || row >= rows) continue;
    for (int g = 0; g < gs; ++g)
      s_feas[row * gs + g] = patch_vals[(size_t)p * G + g];
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const long long row = (long long)job_rows[j] - lo - r0;
    if (row < 0 || row >= rows) continue;
    atomicAdd(&s_jc[row], 1);
    const int tg = job_tgs[j];
    if (tg >= g0 && tg < g0 + gs) atomicAdd(&s_tgc[row * gs + tg - g0], 1);
  }
  __syncthreads();
  const size_t at = (b * N + r0) * G + g0;
  for (int x = threadIdx.x; x < cells; x += blockDim.x) {
    const int r = x / gs, g = x - r * gs;
    feasible[at + (size_t)r * G + g] = s_feas[x];
    tg_count[at + (size_t)r * G + g] = s_tgc[x];
  }
  if (blockIdx.z == 0)
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      job_count[b * N + r0 + r] = s_jc[r];
}

// class_ids [N] i32; verdicts [B,C,G] u8; patch_rows [B,P] i32;
// patch_vals [B,P,G] u8; job_rows/job_tgs [B,J] i32; out feasible
// [B,N,G] u8, job_count [B,N] i32, tg_count [B,N,G] i32; lo the
// global row of the outputs' first row (0 unsharded); tile the rows
// and groups the task groups a CTA (ops/binpack.py overlay_tile:
// ceil(N / tile) x B x ceil(G / groups) CTAs).
NT_API int nt_expand_overlay(int B, int N, int G, int C, int P, int J,
                             int lo, int tile, int groups,
                             const void* class_ids, const void* verdicts,
                             const void* patch_rows, const void* patch_vals,
                             const void* job_rows, const void* job_tgs,
                             void* feasible, void* job_count, void* tg_count,
                             void* stream) {
  if (B <= 0 || N <= 0) return 0;
  if (tile < 1 || groups < 1 || G < 1 || B > 65535 ||
      (G + groups - 1) / groups > 65535 ||
      nt_expand_smem(tile, groups) > NT_EXPAND_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = nt_expand_smem(tile, groups);
  const dim3 grid((unsigned)((N + tile - 1) / tile), (unsigned)B,
                  (unsigned)((G + groups - 1) / groups));
  nt_expand_overlay_kernel<<<grid, NT_EXPAND_THREADS, smem,
                             (cudaStream_t)stream>>>(
      N, G, C, P, J, lo, tile, groups, (const int*)class_ids,
      (const unsigned char*)verdicts, (const int*)patch_rows,
      (const unsigned char*)patch_vals, (const int*)job_rows,
      (const int*)job_tgs, (unsigned char*)feasible, (int*)job_count,
      (int*)tg_count);
  return (int)cudaGetLastError();
}
