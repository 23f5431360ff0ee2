// K10e: the gang program over node shards (ops/gang.py
// gang_placement_program_jit on a GangState that parallel/mesh.py
// shard_gang_inputs laid out over the node axis, in the JAX package:
// GSPMD splits K7's node passes and lowers the group scatter-add and
// each member's argmax to cross-device reductions).
//
// One process drives W shards, each a slice of N rows from global row
// lo on its own device (W slices of one card, or W cards). Every shard
// keeps a replicated copy of the per-group member counts [g_pad]; the
// claimed capacity and ``placed`` stay node-local. The host loop
// (parallel/shard.py sharded_gang_scan) launches:
//
// 1. nt_gang_units, once per shard (slice and spread modes only): each
//    node's member units (csrc/gang.cuh nt_member_units). K10b
//    (csrc/group_capacity.cu) then sums them into the group capacities
//    on the combining device, each shard's partial in node order and
//    the partials in shard order.
// 2. nt_gang_pick, on the combining device: k_actual (the active
//    members), the slice (the argmax of -capacity + group noise over
//    the covering groups, the lowest id on ties; with none, the
//    sentinel g_pad + 1 matches no node) or the spread cap
//    ceil(k_actual / max(groups with capacity >= 1, 1)), into ``meta``
//    [4] = (chosen group, match, k_actual, spread cap's bits), which
//    every shard reads.
// 3. K member steps, each nt_gang_step on every shard and nt_gang_winner
//    on the combining device, as K10c's step and winner
//    (csrc/sharded_scan.cu). The step's prologue applies the last
//    winner: its owning shard adds the ask to the row, and EVERY shard
//    adds 1 to the winner's group in its copy of the member counts, so
//    spread caps and affinity bonuses read the same counts everywhere.
//    Then the shard scores its slice (csrc/gang.cuh nt_gang_node) into
//    one packed key (score bits high, the inverted global index low);
//    thread 0 recomputes the winner's score without the noise and reads
//    its topology id. The winner kernel takes the max of the W keys,
//    valid when its score beats NEG_INF / 2 and the member is active,
//    and carries the owning shard's topology id with the winner, so no
//    shard reads another's rows. A last step with k = -1 applies the
//    last winner.
// 4. nt_gang_finish, on the combining device: unless every active
//    member was placed, every choice is -1 and every score 0, and
//    slice_group -1 (else the chosen group).
//
// The choices, scores and slice group are K7's bit for bit while the
// group capacities are (whole numbers under 2^24): the same score
// arithmetic, a key order equal to K7's argmax, the member noise drawn
// from the global counters, the score recomputed on the owning shard.
//
// Bound on the card: launches, as K10c's. A gang is K x (W + 1) + W
// launches of the member steps, plus W + 2 (and K10b's W + 1 in slice
// and spread mode); the chain of K dependent argmaxes stays.
#include "gang.cuh"

#define NT_SGANG_THREADS 1024

__device__ __forceinline__ unsigned long long nt_gkey_max(
    unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

__global__ void nt_gang_units_kernel(
    int N, int mode, int dh, const float4* __restrict__ capacity,
    const float4* __restrict__ util, const float* __restrict__ bw_avail,
    const float* __restrict__ bw_used, const float* __restrict__ ports_free,
    const unsigned char* __restrict__ feas_row,
    const int* __restrict__ dh_presence, const int* __restrict__ topo_ids,
    const float4* __restrict__ ask_res, const float* __restrict__ ask_bw,
    const float* __restrict__ ask_ports, float* __restrict__ units) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  units[n] = nt_member_units(n, mode, dh != 0, capacity, util, bw_avail,
                             bw_used, ports_free, feas_row, dh_presence,
                             topo_ids, ask_res[0], ask_bw[0], ask_ports[0]);
}

__global__ void __launch_bounds__(NT_SGANG_THREADS) nt_gang_pick_kernel(
    int K, int g_pad, int mode, const unsigned char* __restrict__ active,
    const float* __restrict__ group_cap,
    const float* __restrict__ group_noise, int* __restrict__ meta) {
  __shared__ float s_best[NT_SGANG_THREADS / 32];
  __shared__ int i_best[NT_SGANG_THREADS / 32];
  __shared__ int s_count;
  const int t = threadIdx.x;
  if (t == 0) s_count = 0;
  __syncthreads();
  int mine = 0;
  for (int k = t; k < K; k += blockDim.x) mine += active[k] != 0;
  if (mine) atomicAdd(&s_count, mine);
  __syncthreads();
  const int k_count = s_count;
  const float k_actual = (float)k_count;
  __syncthreads();
  int chosen = -1, match = -1;
  float spread_cap = (float)K;
  if (mode == NT_GANG_SLICE) {
    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int g = t; g < g_pad; g += blockDim.x) {
      const float s = group_cap[g] >= k_actual
                          ? __fadd_rn(-group_cap[g], group_noise[g])
                          : NT_NEG_INF;
      if (s > bs) {  // g rises per thread: strict > keeps the lowest id
        bs = s;
        bi = g;
      }
    }
    const int lane = t & 31, warp = t >> 5;
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
      bs = lane < (int)(blockDim.x >> 5) ? s_best[lane] : -INFINITY;
      bi = lane < (int)(blockDim.x >> 5) ? i_best[lane] : 0x7fffffff;
      for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_down_sync(0xffffffffu, bs, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (nt_better(os, oi, bs, bi)) {
          bs = os;
          bi = oi;
        }
      }
    }
    chosen = bs > NT_NEG_INF / 2 ? bi : -1;
    match = chosen >= 0 ? chosen : g_pad + 1;
  } else if (mode == NT_GANG_SPREAD) {
    if (t == 0) s_count = 0;
    __syncthreads();
    int eligible_mine = 0;
    for (int g = t; g < g_pad; g += blockDim.x)
      eligible_mine += group_cap[g] >= 1.0f;
    if (eligible_mine) atomicAdd(&s_count, eligible_mine);
    __syncthreads();
    const float eligible = fmaxf((float)s_count, 1.0f);
    spread_cap = ceilf(__fdiv_rn(k_actual, eligible));
  }
  if (t == 0) {
    meta[0] = chosen;
    meta[1] = match;
    meta[2] = k_count;
    meta[3] = __float_as_int(spread_cap);
  }
}

__global__ void __launch_bounds__(NT_SGANG_THREADS) nt_gang_step_kernel(
    int N, int K, int g_pad, int lo, int mode, int dh, float penalty, int k,
    int pk, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, float4* util,
    const float* __restrict__ bw_avail, float* bw_used, float* ports_free,
    const unsigned char* __restrict__ feas_row,
    const int* __restrict__ job_count, const int* __restrict__ dh_presence,
    const int* __restrict__ topo_ids, const float4* __restrict__ ask_res,
    const float* __restrict__ ask_bw, const float* __restrict__ ask_ports,
    const float* __restrict__ noise, const int* __restrict__ meta,
    const int* __restrict__ win, int* placed, float* members,
    unsigned long long* __restrict__ part_key,
    float* __restrict__ part_score, int* __restrict__ part_gid) {
  __shared__ unsigned long long s_key[NT_SGANG_THREADS / 32];
  const float4 a = ask_res[0];
  const float abw = ask_bw[0];
  const float aports = ask_ports[0];
  if (pk >= 0 && threadIdx.x == 0 && win[0] >= 0) {
    const int r = win[0] - lo;
    if (r >= 0 && r < N) {
      const float4 u = util[r];
      util[r] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                            __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
      bw_used[r] = __fadd_rn(bw_used[r], abw);
      ports_free[r] = __fadd_rn(ports_free[r], -aports);
      placed[r] = placed[r] + 1;
    }
    const int gid = win[1];
    if (gid >= 0 && gid < g_pad) members[gid] = __fadd_rn(members[gid], 1.0f);
  }
  if (k < 0) return;
  __syncthreads();

  const bool dhb = dh != 0;
  const int match = meta[1];
  const float spread_cap = __int_as_float(meta[3]);
  const float* nz = noise + (size_t)k * N;
  unsigned long long best = 0ull;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s;
    if (!nt_gang_node(n, mode, dhb, penalty, g_pad, match, spread_cap,
                      capacity, sched, util, bw_avail, bw_used, ports_free,
                      feas_row, job_count, dh_presence, topo_ids, placed,
                      members, a, abw, aports, nz, &s))
      s = NT_NEG_INF;
    best = nt_gkey_max(best, nt_pack(s, lo + n));
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    best = nt_gkey_max(best, __shfl_down_sync(0xffffffffu, best, off));
  if (lane == 0) s_key[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < (int)(blockDim.x >> 5) ? s_key[lane] : 0ull;
    for (int off = 16; off > 0; off >>= 1)
      best = nt_gkey_max(best, __shfl_down_sync(0xffffffffu, best, off));
  }
  if (threadIdx.x == 0) {
    const int r = nt_unpack_index(best) - lo;
    float s;
    if (!nt_gang_node(r, mode, dhb, penalty, g_pad, match, spread_cap,
                      capacity, sched, util, bw_avail, bw_used, ports_free,
                      feas_row, job_count, dh_presence, topo_ids, placed,
                      members, a, abw, aports, nz, &s))
      s = NT_NEG_INF;
    part_key[0] = best;
    part_score[0] = __fsub_rn(s, nz[r]);
    part_gid[0] = topo_ids[r];
  }
}

__global__ void nt_gang_winner_kernel(
    int W, int k, const unsigned long long* __restrict__ part_key,
    const float* __restrict__ part_score, const int* __restrict__ part_gid,
    const unsigned char* __restrict__ active, int* __restrict__ choices,
    float* __restrict__ scores, int* __restrict__ win) {
  if (threadIdx.x != 0) return;
  unsigned long long best = part_key[0];
  int owner = 0;
  for (int s = 1; s < W; ++s) {  // keys are distinct: order-free max
    if (part_key[s] > best) {
      best = part_key[s];
      owner = s;
    }
  }
  const bool valid = nt_unpack_score(best) > NT_NEG_INF / 2 && active[k] != 0;
  choices[k] = valid ? nt_unpack_index(best) : -1;
  scores[k] = valid ? part_score[owner] : 0.0f;
  win[0] = valid ? nt_unpack_index(best) : -1;
  win[1] = valid ? part_gid[owner] : -1;
}

__global__ void nt_gang_finish_kernel(int K,
                                      const unsigned char* __restrict__ active,
                                      const int* __restrict__ meta,
                                      int* choices, float* scores,
                                      int* __restrict__ slice_group) {
  int missing = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x)
    if (active[k] && choices[k] < 0) missing = 1;
  const int partial = __syncthreads_or(missing);
  if (partial) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      choices[k] = -1;
      scores[k] = 0.0f;
    }
  }
  if (threadIdx.x == 0) slice_group[0] = partial ? -1 : meta[0];
}

// One shard's member units: the shard's N rows of capacity / util [N,4]
// f32, bw_avail / bw_used / ports_free [N] f32, feas_row [N] u8,
// dh_presence / topo_ids [N] i32; ask_res [4], ask_bw / ask_ports []
// f32; units [N] f32 out.
NT_API int nt_gang_units(int N, int mode, int dh, const void* capacity,
                         const void* util, const void* bw_avail,
                         const void* bw_used, const void* ports_free,
                         const void* feas_row, const void* dh_presence,
                         const void* topo_ids, const void* ask_res,
                         const void* ask_bw, const void* ask_ports,
                         void* units, void* stream) {
  if (N <= 0) return 0;
  const int threads = 256;
  nt_gang_units_kernel<<<(N + threads - 1) / threads, threads, 0,
                         (cudaStream_t)stream>>>(
      N, mode, dh, (const float4*)capacity, (const float4*)util,
      (const float*)bw_avail, (const float*)bw_used,
      (const float*)ports_free, (const unsigned char*)feas_row,
      (const int*)dh_presence, (const int*)topo_ids, (const float4*)ask_res,
      (const float*)ask_bw, (const float*)ask_ports, (float*)units);
  return (int)cudaGetLastError();
}

// On the combining device: active [K] u8; group_cap [g_pad] f32 (read
// in slice and spread mode only; may be null otherwise); group_noise
// [g_pad] f32; meta [4] i32 out.
NT_API int nt_gang_pick(int K, int g_pad, int mode, const void* active,
                        const void* group_cap, const void* group_noise,
                        void* meta, void* stream) {
  if (g_pad < 1) return (int)cudaErrorInvalidValue;
  nt_gang_pick_kernel<<<1, NT_SGANG_THREADS, 0, (cudaStream_t)stream>>>(
      K, g_pad, mode, (const unsigned char*)active, (const float*)group_cap,
      (const float*)group_noise, (int*)meta);
  return (int)cudaGetLastError();
}

// One shard's member step k (k = -1: the last winner's update alone;
// pk = -1: no winner yet). The shard's N rows of capacity / sched /
// util [N,4] f32, bw_avail / bw_used / ports_free [N] f32, feas_row
// [N] u8, job_count / dh_presence / topo_ids [N] i32; ask_res [4],
// ask_bw / ask_ports [] f32; noise [K,N] f32 (the shard's window);
// meta [4] i32 (nt_gang_pick's); win [2] i32 (the last winner's global
// index and topology id, -1 for none); placed [N] i32 and members
// [g_pad] f32 carried; part_key [1] u64, part_score [1] f32, part_gid
// [1] i32 out (this shard's candidate).
NT_API int nt_gang_step(int N, int K, int g_pad, int lo, int mode, int dh,
                        float penalty, int k, int pk, const void* capacity,
                        const void* sched, void* util, const void* bw_avail,
                        void* bw_used, void* ports_free, const void* feas_row,
                        const void* job_count, const void* dh_presence,
                        const void* topo_ids, const void* ask_res,
                        const void* ask_bw, const void* ask_ports,
                        const void* noise, const void* meta, const void* win,
                        void* placed, void* members, void* part_key,
                        void* part_score, void* part_gid, void* stream) {
  if (N <= 0) return 0;
  if (g_pad < 1) return (int)cudaErrorInvalidValue;
  nt_gang_step_kernel<<<1, NT_SGANG_THREADS, 0, (cudaStream_t)stream>>>(
      N, K, g_pad, lo, mode, dh, penalty, k, pk, (const float4*)capacity,
      (const float4*)sched, (float4*)util, (const float*)bw_avail,
      (float*)bw_used, (float*)ports_free, (const unsigned char*)feas_row,
      (const int*)job_count, (const int*)dh_presence, (const int*)topo_ids,
      (const float4*)ask_res, (const float*)ask_bw, (const float*)ask_ports,
      (const float*)noise, (const int*)meta, (const int*)win, (int*)placed,
      (float*)members, (unsigned long long*)part_key, (float*)part_score,
      (int*)part_gid);
  return (int)cudaGetLastError();
}

// The W shards' candidates of member k: part_key [W] u64, part_score
// [W] f32, part_gid [W] i32 in shard order; active [K] u8; choices [K]
// i32, scores [K] f32 and win [2] i32 written.
NT_API int nt_gang_winner(int W, int k, const void* part_key,
                          const void* part_score, const void* part_gid,
                          const void* active, void* choices, void* scores,
                          void* win, void* stream) {
  if (W <= 0) return 0;
  nt_gang_winner_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      W, k, (const unsigned long long*)part_key, (const float*)part_score,
      (const int*)part_gid, (const unsigned char*)active, (int*)choices,
      (float*)scores, (int*)win);
  return (int)cudaGetLastError();
}

// The all-K rewrite: active [K] u8, meta [4] i32; choices [K] i32 and
// scores [K] f32 rewritten in place; slice_group [] i32 out.
NT_API int nt_gang_finish(int K, const void* active, const void* meta,
                          void* choices, void* scores, void* slice_group,
                          void* stream) {
  if (K <= 0) return 0;
  nt_gang_finish_kernel<<<1, NT_SGANG_THREADS, 0, (cudaStream_t)stream>>>(
      K, (const unsigned char*)active, (const int*)meta, (int*)choices,
      (float*)scores, (int*)slice_group);
  return (int)cudaGetLastError();
}
