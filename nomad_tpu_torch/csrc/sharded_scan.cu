// K10c: the greedy placement scan over node shards (parallel/mesh.py
// sharded_placement in the JAX package, and the greedy overlay and
// compact dispatches over a node-sharded base: GSPMD runs K1's
// masked-argmax scan with the node axis split over devices and lowers
// each step's argmax to a cross-device reduction).
//
// One process drives W shards, each a slice of N rows from global row
// lo on its own device (W slices of one card, or W cards). Every step
// of the scan is two launches, driven by a host loop over the K steps
// (B x K under seq, the pre_resolve layout):
//
// 1. nt_shard_step, once per shard on the shard's device. Prologue:
//    the previous step's winner (win[], a global index or -1) updates
//    its one row of the carried util, bw_used, ports_free, job_count
//    and tg_count, on the shard that owns it. Then the shard scores
//    its slice for the step's ask (mask, BestFit-v3, penalty and its
//    window of the noise, csrc/common.cuh nt_node_score) and reduces
//    to one packed 64-bit key (nt_pack: order-preserving score bits
//    high, the inverted GLOBAL index low). Its thread 0 recomputes the
//    winning node's score and writes it without the noise beside the
//    key: the reported score comes from the shard that owns the node.
// 2. nt_shard_winner, on the combining device: the max of the W keys
//    (a higher score, then the lower global index: jnp.argmax's
//    order), valid when its score beats NEG_INF / 2 and the ask is
//    active; writes choices/scores and the winner for the next step's
//    prologue. Nothing fits anywhere: every key holds NEG_INF, the
//    winner is -1.
// A last nt_shard_step with k = -1 applies the last step's winner.
//
// Under seq one block walks the evals in order over one shared copy of
// util/bw_used/ports_free (job_count, tg_count, feasible, asks and
// noise per eval), as K1's seq layout does; the independent layout
// runs every eval's step in one launch, one block an eval; stacked
// states (batched_placement_program) give each eval its own static
// rows.
//
// The choices and scores are K1's bit for bit: the same score
// arithmetic, a key order equal to nt_better's, the noise window
// drawn from the global counters (csrc/threefry.cu), and the reported
// score recomputed on the owning shard.
//
// K10g-b, the convex kernel's rounding scan over node shards
// (kernels/convex.py convex_placement_program's body scan over a
// node-sharded base in the JAX package), is the same pair of kernels
// with the rounding bias: given ``pref`` (the shard's columns of the
// relaxation's preference, [B,K,N]), nt_shard_step packs score +
// ROUND_BIAS x pref - STRAND_BIAS x strand penalty (csrc/common.cuh
// nt_round_bias, K8b's arithmetic), the strand penalty read from the
// shard's own carried rows, and thread 0 still reports the score
// without the noise and the bias, as K8b does. The winner's validity
// (its packed value above NEG_INF / 2, the ask active) is K8b's.
//
// Bound on the card: launches. An eval is K x (W + 1) + W launches of
// a few microseconds each; every step kernel scores N / 1024 nodes a
// thread. The chain of K dependent argmaxes stays, now across launches.
#include "common.cuh"

#define NT_SHARD_THREADS 1024

__device__ __forceinline__ unsigned long long nt_key_max(
    unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// Block-wide max of one key a thread; thread 0 gets the result.
__device__ __forceinline__ unsigned long long nt_block_key_max(
    unsigned long long key, unsigned long long* s_key) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    key = nt_key_max(key, __shfl_down_sync(0xffffffffu, key, off));
  if (lane == 0) s_key[warp] = key;
  __syncthreads();
  if (warp == 0) {
    key = lane < n_warps ? s_key[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1)
      key = nt_key_max(key, __shfl_down_sync(0xffffffffu, key, off));
  }
  return key;
}

// Add ask (e, k) to local row r of the carry (cb: the claimed
// capacity's eval row, 0 under seq).
__device__ __forceinline__ void nt_shard_apply(
    int r, int N, int G, int K, int e, int k, size_t cb, float4* util,
    float* bw_used, float* ports_free, int* job_count, int* tg_count,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index) {
  const size_t a_at = (size_t)e * K + k;
  const float4 a = ask_res[a_at];
  const int tg = tg_index[a_at];
  float4* u = util + cb * N + r;
  *u = make_float4(__fadd_rn(u->x, a.x), __fadd_rn(u->y, a.y),
                   __fadd_rn(u->z, a.z), __fadd_rn(u->w, a.w));
  bw_used[cb * N + r] = __fadd_rn(bw_used[cb * N + r], ask_bw[a_at]);
  ports_free[cb * N + r] =
      __fadd_rn(ports_free[cb * N + r], -ask_ports[a_at]);
  job_count[(size_t)e * N + r] += 1;
  tg_count[((size_t)e * N + r) * G + tg] += 1;
}

__global__ void __launch_bounds__(NT_SHARD_THREADS) nt_shard_step_kernel(
    int B, int N, int G, int K, int lo, float penalty, int seq, int stacked,
    int e_seq, int k, int pe_seq, int pk, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float* __restrict__ bw_avail,
    const unsigned char* __restrict__ node_ok, float4* util, float* bw_used,
    float* ports_free, int* job_count, int* tg_count,
    const unsigned char* __restrict__ feasible,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, const int* __restrict__ tg_index,
    const unsigned char* __restrict__ job_dh,
    const unsigned char* __restrict__ tg_dh,
    const float* __restrict__ noise, const float* __restrict__ pref,
    const int* __restrict__ win, unsigned long long* __restrict__ part_key,
    float* __restrict__ part_score) {
  __shared__ unsigned long long s_key[NT_SHARD_THREADS / 32];
  const int e = seq ? e_seq : blockIdx.x;
  const int pe = seq ? pe_seq : e;
  if (pk >= 0 && threadIdx.x == 0) {
    const int r = win[pe] - lo;
    if (r >= 0 && r < N)
      nt_shard_apply(r, N, G, K, pe, pk, seq ? 0 : pe, util, bw_used,
                     ports_free, job_count, tg_count, ask_res, ask_bw,
                     ask_ports, tg_index);
  }
  if (k < 0) return;
  __syncthreads();

  const size_t cb = seq ? 0 : e;
  const size_t sb = stacked ? e : 0;  // static rows: per eval or shared
  capacity += sb * N;
  sched += sb * N;
  bw_avail += sb * N;
  node_ok += sb * N;
  const size_t a_at = (size_t)e * K + k;
  const float4 a = ask_res[a_at];
  const float abw = ask_bw[a_at];
  const float aports = ask_ports[a_at];
  const int tg = tg_index[a_at];
  const bool jdh = job_dh[e] != 0;
  const bool tdh = tg_dh[(size_t)e * G + tg] != 0;
  const float* nz = noise + ((size_t)e * K + k) * N;
  const float4* u = util + cb * N;
  const float* bw = bw_used + cb * N;
  const float* pf = ports_free + cb * N;
  const int* jc = job_count + (size_t)e * N;
  const int* tgc = tg_count + (size_t)e * N * G;
  const unsigned char* fe = feasible + (size_t)e * N * G;
  const float* pr = pref ? pref + ((size_t)e * K + k) * N : nullptr;

  unsigned long long best = 0ull;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = nt_node_score(n, G, tg, jdh, tdh, penalty, capacity, sched,
                            bw_avail, node_ok, u, bw, pf, jc, tgc, fe, a, abw,
                            aports, nz[n]);
    if (pr) s = __fadd_rn(s, nt_round_bias(n, capacity, sched, u, a, pr[n]));
    best = nt_key_max(best, nt_pack(s, lo + n));
  }
  best = nt_block_key_max(best, s_key);
  if (threadIdx.x == 0) {
    const int r = nt_unpack_index(best) - lo;
    const float s = nt_node_score(r, G, tg, jdh, tdh, penalty, capacity,
                                  sched, bw_avail, node_ok, u, bw, pf, jc,
                                  tgc, fe, a, abw, aports, nz[r]);
    part_key[e] = best;
    part_score[e] = __fsub_rn(s, nz[r]);
  }
}

__global__ void nt_shard_winner_kernel(
    int W, int B, int K, int k, int seq, int e_seq,
    const unsigned long long* __restrict__ part_key,
    const float* __restrict__ part_score,
    const unsigned char* __restrict__ active, int* __restrict__ choices,
    float* __restrict__ scores, int* __restrict__ win) {
  const int e = seq ? e_seq : (int)(blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= B || (seq && threadIdx.x != 0)) return;
  unsigned long long best = part_key[e];
  int owner = 0;
  for (int s = 1; s < W; ++s) {  // keys are distinct: order-free max
    const unsigned long long key = part_key[(size_t)s * B + e];
    if (key > best) {
      best = key;
      owner = s;
    }
  }
  const size_t at = (size_t)e * K + k;
  const bool valid =
      nt_unpack_score(best) > NT_NEG_INF / 2 && active[at] != 0;
  const int idx = nt_unpack_index(best);
  choices[at] = valid ? idx : -1;
  scores[at] = valid ? part_score[(size_t)owner * B + e] : 0.0f;
  win[e] = valid ? idx : -1;
}

// One shard's step (k >= 0), or the last winner's update alone (k =
// -1). Shapes (the shard's N rows): capacity/sched [N,4] f32, bw_avail
// [N] f32, node_ok [N] u8; util [B,N,4] f32, bw_used/ports_free [B,N]
// f32 (seq: [N,4], [N]); job_count [B,N] i32; tg_count, feasible
// [B,N,G]; ask_res [B,K,4] f32; ask_bw/ask_ports [B,K] f32; tg_index
// [B,K] i32; job_dh [B] u8; tg_dh [B,G] u8; noise [B,K,N] f32 (the
// shard's window); pref [B,K,N] f32 (the shard's columns; null: no
// rounding bias); win [B] i32 (the last step's winners); part_key
// [B] u64 and part_score [B] f32 out (this shard's candidates);
// stacked: capacity/sched/bw_avail/node_ok carry the batch axis. Under
// seq (e, k) is the step and (pe, pk) the previous one (pk = -1:
// none); independent, every eval runs step k after step pk.
NT_API int nt_shard_step(int B, int N, int G, int K, int lo, float penalty,
                         int seq, int stacked, int e, int k, int pe, int pk,
                         const void* capacity, const void* sched,
                         const void* bw_avail, const void* node_ok,
                         void* util, void* bw_used, void* ports_free,
                         void* job_count, void* tg_count,
                         const void* feasible, const void* ask_res,
                         const void* ask_bw, const void* ask_ports,
                         const void* tg_index, const void* job_dh,
                         const void* tg_dh, const void* noise,
                         const void* pref, const void* win, void* part_key,
                         void* part_score, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  nt_shard_step_kernel<<<seq ? 1 : B, NT_SHARD_THREADS, 0,
                         (cudaStream_t)stream>>>(
      B, N, G, K, lo, penalty, seq, stacked, e, k, pe, pk,
      (const float4*)capacity,
      (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (float4*)util, (float*)bw_used,
      (float*)ports_free, (int*)job_count, (int*)tg_count,
      (const unsigned char*)feasible, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (const int*)tg_index,
      (const unsigned char*)job_dh, (const unsigned char*)tg_dh,
      (const float*)noise, (const float*)pref, (const int*)win,
      (unsigned long long*)part_key, (float*)part_score);
  return (int)cudaGetLastError();
}

// The W shards' candidates of step k: part_key [W,B] u64, part_score
// [W,B] f32 in shard order; active [B,K] u8; choices [B,K] i32, scores
// [B,K] f32 and win [B] i32 written (under seq: eval e only).
NT_API int nt_shard_winner(int W, int B, int K, int k, int seq, int e,
                           const void* part_key, const void* part_score,
                           const void* active, void* choices, void* scores,
                           void* win, void* stream) {
  if (B <= 0 || W <= 0) return 0;
  const int threads = seq ? 32 : 256;
  const int blocks = seq ? 1 : (B + threads - 1) / threads;
  nt_shard_winner_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      W, B, K, k, seq, e, (const unsigned long long*)part_key,
      (const float*)part_score, (const unsigned char*)active, (int*)choices,
      (float*)scores, (int*)win);
  return (int)cudaGetLastError();
}
