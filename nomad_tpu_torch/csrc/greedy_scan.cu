// K1: the greedy placement scan — K dependent masked-argmax steps per
// eval (ops/binpack.py _score_and_mask + placement_step, scanned by
// placement_program, in the JAX package), under three batch layouts:
//
// - independent evals (vmap): one block per eval, each with its own
//   copy of the carried util, bw_used and ports_free;
// - sequential evals (seq = 1; the pre_resolve scan over the eval axis,
//   _overlay_seq and the pre_resolve branch of _compact_batch): ONE
//   block walks the B evals in order over one shared copy of util,
//   bw_used and ports_free (batch stride 0), so eval b+1 scores against
//   the capacity evals 0..b claimed; job_count, tg_count, feasible,
//   asks and noise stay per eval;
// - stacked states (stacked = 1; batched_placement_program): capacity,
//   sched, bw_avail and node_ok carry the batch axis too.
//
// Step k scores every node for ask k, takes the best (lowest index on
// ties, as jnp.argmax), and, when the ask is active and some node
// fits, adds the ask to that one row of the carried util, bw_used,
// ports_free, job_count and tg_count. Step k+1 reads the row step k
// wrote, so the K steps are a dependent chain; under seq the chain is
// B x K steps long, and the barrier that closes each step also orders
// one eval's last update before the next eval's first read.
//
// Bound on the card: the chain, not the bytes — K block-wide argmax
// reductions in sequence, each a pass over N nodes (~40 bytes a node,
// served from L2 after the first step) plus two __syncthreads. Design:
// one block per eval (grid = B), or one block in all (seq), 1024
// threads, each scoring its strided nodes; a warp-shuffle then a
// shared-memory argmax; thread 0 updates the chosen row in global
// memory, which the next step's __syncthreads makes visible to the
// block. The carried arrays are private to the launch (the wrapper
// clones the base), and the feasibility column of ask k is read in
// place from feasible[N, G]: the [K, N] gather is never built.
// Measured (H100, N = 10,240): ~14 us a step, bound by the one SM's
// bandwidth and issue rate; so at B = 64 x K = 1,024 a sequential scan
// takes ~1 s. Splitting one eval's node axis over a thread-block
// cluster is the next step.
#include "common.cuh"

#define NT_SCAN_THREADS 1024

// One eval's K steps; every pointer is already offset to the eval.
__device__ __forceinline__ void nt_scan_eval(
    int N, int G, int K, float penalty, bool jdh,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok,
    float4* util, float* bw_used, float* ports_free, int* job_count,
    int* tg_count, const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, int* __restrict__ choices,
    float* __restrict__ scores, float* s_best, int* i_best) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;

  for (int k = 0; k < K; ++k) {
    const float4 a = ask_res[k];
    const float abw = ask_bw[k];
    const float aports = ask_ports[k];
    const int tg = tg_index[k];
    const bool tdh = tg_dh[tg] != 0;
    const float* nz = noise + (size_t)k * N;

    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const float s = nt_node_score(n, G, tg, jdh, tdh, penalty, capacity,
                                    sched, bw_avail, node_ok, util, bw_used,
                                    ports_free, job_count, tg_count, feasible,
                                    a, abw, aports, nz[n]);
      if (s > bs) {  // n rises per thread: strict > keeps the lowest index
        bs = s;
        bi = n;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (nt_better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_best[warp] = bs;
      i_best[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < n_warps ? s_best[lane] : -INFINITY;
      bi = lane < n_warps ? i_best[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (nt_better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
      if (lane == 0) {
        const bool valid = (bs > NT_NEG_INF / 2) && active[k] != 0;
        if (valid) {
          choices[k] = bi;
          scores[k] = __fsub_rn(bs, nz[bi]);
          const float4 u = util[bi];
          util[bi] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                                 __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
          bw_used[bi] = __fadd_rn(bw_used[bi], abw);
          ports_free[bi] = __fadd_rn(ports_free[bi], -aports);
          job_count[bi] = job_count[bi] + 1;
          tg_count[(size_t)bi * G + tg] = tg_count[(size_t)bi * G + tg] + 1;
        } else {
          choices[k] = -1;
          scores[k] = 0.0f;
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT_SCAN_THREADS) nt_greedy_scan_kernel(
    int B, int N, int G, int K, float penalty, int seq, int stacked,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok,
    float4* util, float* bw_used, float* ports_free, int* job_count,
    int* tg_count, const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ active,
    const unsigned char* __restrict__ job_dh,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, int* __restrict__ choices,
    float* __restrict__ scores) {
  __shared__ float s_best[NT_SCAN_THREADS / 32];
  __shared__ int i_best[NT_SCAN_THREADS / 32];
  const int first = seq ? 0 : blockIdx.x;
  const int last = seq ? B : first + 1;
  for (int b = first; b < last; ++b) {
    const size_t sb = stacked ? b : 0;  // static rows: per eval or shared
    const size_t cb = seq ? 0 : b;      // claimed capacity: shared under seq
    nt_scan_eval(N, G, K, penalty, job_dh[b] != 0, capacity + sb * N,
                 sched + sb * N, bw_avail + sb * N, node_ok + sb * N,
                 util + cb * N, bw_used + cb * N, ports_free + cb * N,
                 job_count + (size_t)b * N, tg_count + (size_t)b * N * G,
                 feasible + (size_t)b * N * G, ask_res + (size_t)b * K,
                 ask_bw + (size_t)b * K, ask_ports + (size_t)b * K,
                 tg_index + (size_t)b * K, active + (size_t)b * K,
                 tg_dh + (size_t)b * G, noise + (size_t)b * K * N,
                 choices + (size_t)b * K, scores + (size_t)b * K, s_best,
                 i_best);
  }
}

// Shapes: capacity/sched [N,4] f32, bw_avail [N] f32, node_ok [N] u8
// (stacked: [B,N,...]); util [B,N,4] f32, bw_used/ports_free [B,N] f32
// (seq: [N,4] and [N], one shared copy); job_count [B,N] i32, tg_count
// [B,N,G] i32 (carried, updated in place); feasible [B,N,G] u8;
// ask_res [B,K,4] f32; ask_bw/ask_ports [B,K] f32; tg_index [B,K] i32;
// active [B,K] u8; job_dh [B] u8; tg_dh [B,G] u8; noise [B,K,N] f32;
// out choices [B,K] i32, scores [B,K] f32.
NT_API int nt_greedy_scan(int B, int N, int G, int K, float penalty, int seq,
                          int stacked, const void* capacity,
                          const void* sched, const void* bw_avail,
                          const void* node_ok, void* util, void* bw_used,
                          void* ports_free, void* job_count, void* tg_count,
                          const void* feasible, const void* ask_res,
                          const void* ask_bw, const void* ask_ports,
                          const void* tg_index, const void* active,
                          const void* job_dh, const void* tg_dh,
                          const void* noise, void* choices, void* scores,
                          void* stream) {
  if (B <= 0 || K <= 0) return 0;
  nt_greedy_scan_kernel<<<seq ? 1 : B, NT_SCAN_THREADS, 0,
                          (cudaStream_t)stream>>>(
      B, N, G, K, penalty, seq, stacked, (const float4*)capacity,
      (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (float4*)util, (float*)bw_used,
      (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)active, (const unsigned char*)job_dh,
      (const unsigned char*)tg_dh, (const float*)noise, (int*)choices,
      (float*)scores);
  return (int)cudaGetLastError();
}

// The greedy scan's dependent chain alone, for measuring it: K rounds
// of the same block-wide argmax (warp shuffle, shared memory, warp 0,
// two barriers) over 1024 threads with no node scoring. Each round's
// values depend on the previous round's winner, as step k+1 of the
// scan depends on the row step k chose, so no round can start early.
// Not on the placement path: chip_smoke.py times it to bound K1.
__global__ void __launch_bounds__(NT_SCAN_THREADS) nt_argmax_chain_kernel(
    int K, int* __restrict__ out) {
  __shared__ float s_best[NT_SCAN_THREADS / 32];
  __shared__ int i_best[NT_SCAN_THREADS / 32];
  __shared__ int s_win;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int win = 0;
  for (int k = 0; k < K; ++k) {
    float bs = (float)(((unsigned)threadIdx.x * 2654435761u + (unsigned)win) &
                       1023u);
    int bi = threadIdx.x;
    for (int off = 16; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, bs, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (nt_better(os, oi, bs, bi)) {
        bs = os;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_best[warp] = bs;
      i_best[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bs = lane < n_warps ? s_best[lane] : -INFINITY;
      bi = lane < n_warps ? i_best[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (nt_better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
      if (lane == 0) s_win = bi;
    }
    __syncthreads();
    win = s_win;
  }
  if (threadIdx.x == 0) out[0] = win;
}

// One block of 1024 threads, K rounds; out [1] i32 (the last winner).
NT_API int nt_argmax_chain(int K, void* out, void* stream) {
  if (K <= 0) return 0;
  nt_argmax_chain_kernel<<<1, NT_SCAN_THREADS, 0, (cudaStream_t)stream>>>(
      K, (int*)out);
  return (int)cudaGetLastError();
}
