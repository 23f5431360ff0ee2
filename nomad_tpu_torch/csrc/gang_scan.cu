// K7: all-K gang placement of one gang over the node-topology tensor
// (ops/gang.py _member_units, _group_capacity and
// gang_placement_program, in the JAX package).
//
// One block:
// 1. Group capacity (slice and spread modes; free and affinity read
//    none). Chunk by chunk of 1024 nodes, every thread computes one
//    node's member units (min over dimensions of floor(free / ask),
//    1e9 on a zero ask, bounded by bandwidth and ports; 0 off the
//    feasibility row; at most 1 under distinct_hosts; 0 without a
//    topology id in slice mode) into shared memory, and then each
//    group of the chunk's id range [lo, hi] is summed by one thread in
//    node order. So each group's float sum rounds in the order the
//    plain version's index_add_ rounds it, even past 2^24 (a zero ask
//    gives every feasible node 1e9 units).
// 2. Slice mode: the tightest covering group, (-capacity + group noise)
//    argmax over the g_pad groups, lowest id on ties; with none, the
//    sentinel g_pad + 1 matches no node. Spread mode: the cap
//    ceil(k_actual / max(groups with capacity >= 1, 1)), over the active
//    members only.
// 3. K steps of a masked argmax over N (the gang score keeps the
//    zero-sched-capacity guard, penalises job_count + placed, and in
//    affinity mode adds 5 per member already in the node's group);
//    thread 0 updates the chosen row, placed[] and the group's member
//    count before the step's closing barrier.
// 4. All-K: unless every active member was placed, every choice is
//    rewritten to -1 and every score to 0, and slice_group to -1.
//
// Group capacities and member counts live in shared memory up to
// NT_GANG_SHARED_GROUPS groups, past that in global memory (the
// group_cap scratch and the group_members output): spread, affinity and
// free gangs give every node without the level's meta its own group, so
// g_pad reaches the node count.
//
// Bound on the card: the K dependent block-wide argmax rounds, as K1's;
// the units pass and the group sums run once per launch (N / 1024
// chunks, each three barriers and a 1024-entry scan by the group
// threads).
#include "gang.cuh"

#define NT_GANG_THREADS 1024
#define NT_GANG_SHARED_GROUPS 1024

// Block-wide argmax of (s, i), lowest index on ties; every thread gets
// the result. s_best/i_best hold one entry a warp.
__device__ __forceinline__ void nt_block_argmax(float& bs, int& bi,
                                                float* s_best, int* i_best) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
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
  bs = __shfl_sync(0xffffffffu, bs, 0);
  bi = __shfl_sync(0xffffffffu, bi, 0);
}

__global__ void __launch_bounds__(NT_GANG_THREADS) nt_gang_scan_kernel(
    int N, int K, int g_pad, int mode, int dh, float penalty,
    const float4* __restrict__ capacity, const float4* __restrict__ sched,
    float4* util, const float* __restrict__ bw_avail, float* bw_used,
    float* ports_free, const unsigned char* __restrict__ feas_row,
    const int* __restrict__ job_count, const int* __restrict__ dh_presence,
    const int* __restrict__ topo_ids, const float4* __restrict__ ask_res,
    const float* __restrict__ ask_bw, const float* __restrict__ ask_ports,
    const unsigned char* __restrict__ active, const float* __restrict__ noise,
    const float* __restrict__ group_noise, int* placed, float* group_members,
    int* choices, float* __restrict__ scores, int* __restrict__ slice_group,
    float* group_cap) {
  __shared__ float s_cap_sm[NT_GANG_SHARED_GROUPS];
  __shared__ float s_members_sm[NT_GANG_SHARED_GROUPS];
  __shared__ float s_units[NT_GANG_THREADS];
  __shared__ int s_ids[NT_GANG_THREADS];
  __shared__ float s_best[NT_GANG_THREADS / 32];
  __shared__ int i_best[NT_GANG_THREADS / 32];
  __shared__ int s_count, s_lo, s_hi;
  const int t = threadIdx.x;
  const float4 a = ask_res[0];
  const float abw = ask_bw[0];
  const float aports = ask_ports[0];
  const bool dhb = dh != 0;
  const bool in_shared = g_pad <= NT_GANG_SHARED_GROUPS;
  float* cap = in_shared ? s_cap_sm : group_cap;
  float* members = in_shared ? s_members_sm : group_members;

  for (int g = t; g < g_pad; g += blockDim.x) {
    cap[g] = 0.0f;
    members[g] = 0.0f;
  }
  if (t == 0) s_count = 0;
  __syncthreads();
  // ---- 1. member units and group capacity, in node order
  if (mode == NT_GANG_SLICE || mode == NT_GANG_SPREAD) {
    for (int base = 0; base < N; base += blockDim.x) {
      const int n = base + t;
      const float u = n < N ? nt_member_units(n, mode, dhb, capacity, util,
                                              bw_avail, bw_used, ports_free,
                                              feas_row, dh_presence, topo_ids,
                                              a, abw, aports)
                            : 0.0f;
      nt_group_chunk(base, N, g_pad, u, n < N ? topo_ids[n] : -1, cap,
                     s_units, s_ids, &s_lo, &s_hi);
    }
  }
  // k_actual: the active members (an exact count).
  int mine = 0;
  for (int k = t; k < K; k += blockDim.x) mine += active[k] != 0;
  if (mine) atomicAdd(&s_count, mine);
  __syncthreads();
  const float k_actual = (float)s_count;
  __syncthreads();

  // ---- 2. slice choice or spread cap
  int chosen = -1;
  int match = -1;
  float spread_cap = (float)K;
  if (mode == NT_GANG_SLICE) {
    float gs = -INFINITY;
    int gi = 0x7fffffff;
    for (int g = t; g < g_pad; g += blockDim.x) {
      const float s = cap[g] >= k_actual ? __fadd_rn(-cap[g], group_noise[g])
                                         : NT_NEG_INF;
      if (s > gs) {  // g rises per thread: strict > keeps the lowest id
        gs = s;
        gi = g;
      }
    }
    nt_block_argmax(gs, gi, s_best, i_best);
    chosen = gs > NT_NEG_INF / 2 ? gi : -1;
    match = chosen >= 0 ? chosen : g_pad + 1;
    __syncthreads();
  } else if (mode == NT_GANG_SPREAD) {
    if (t == 0) s_count = 0;
    __syncthreads();
    int eligible_mine = 0;
    for (int g = t; g < g_pad; g += blockDim.x) eligible_mine += cap[g] >= 1.0f;
    if (eligible_mine) atomicAdd(&s_count, eligible_mine);
    __syncthreads();
    const float eligible = fmaxf((float)s_count, 1.0f);
    spread_cap = ceilf(__fdiv_rn(k_actual, eligible));
  }

  // ---- 3. the K member steps
  for (int k = 0; k < K; ++k) {
    if (!active[k]) {  // uniform over the block: no barrier is skipped
      if (t == 0) {
        choices[k] = -1;
        scores[k] = 0.0f;
      }
      continue;
    }
    const float* nz = noise + (size_t)k * N;
    float bs = -INFINITY;
    int bi = 0x7fffffff;
    for (int n = t; n < N; n += blockDim.x) {
      const float4 u = util[n];
      const float4 cap = capacity[n];
      const float4 sc = sched[n];
      const float nu0 = __fadd_rn(u.x, a.x);
      const float nu1 = __fadd_rn(u.y, a.y);
      const float nu2 = __fadd_rn(u.z, a.z);
      const float nu3 = __fadd_rn(u.w, a.w);
      const int pl = placed[n];
      const int tid = topo_ids[n];
      bool fits = (nu0 <= cap.x) && (nu1 <= cap.y) && (nu2 <= cap.z) &&
                  (nu3 <= cap.w);
      fits = fits && (__fadd_rn(bw_used[n], abw) <= bw_avail[n]);
      fits = fits && (ports_free[n] >= aports) && feas_row[n];
      if (mode == NT_GANG_SLICE) fits = fits && tid == match;
      if (dhb) fits = fits && pl == 0 && dh_presence[n] == 0;
      const float gcount =
          members[min(max(tid >= 0 ? tid : g_pad, 0), g_pad - 1)];
      if (mode == NT_GANG_SPREAD) fits = fits && (tid < 0 || gcount < spread_cap);
      if (!fits) continue;
      const float f0 = __fsub_rn(1.0f, __fdiv_rn(nu0, fmaxf(sc.x, 1.0f)));
      const float f1 = __fsub_rn(1.0f, __fdiv_rn(nu1, fmaxf(sc.y, 1.0f)));
      float fit =
          __fsub_rn(20.0f, __fadd_rn(powf(10.0f, f0), powf(10.0f, f1)));
      fit = fminf(fmaxf(fit, 0.0f), 18.0f);
      if (sc.x <= 0.0f || sc.y <= 0.0f) fit = 0.0f;
      float s = __fsub_rn(fit, __fmul_rn(penalty, (float)(job_count[n] + pl)));
      if (mode == NT_GANG_AFFINITY)
        s = __fadd_rn(s, __fmul_rn(NT_GANG_AFFINITY_BONUS,
                                   tid >= 0 ? gcount : 0.0f));
      s = __fadd_rn(s, nz[n]);
      if (s > bs) {  // n rises per thread: strict > keeps the lowest index
        bs = s;
        bi = n;
      }
    }
    nt_block_argmax(bs, bi, s_best, i_best);
    if (t == 0) {
      if (bs > NT_NEG_INF / 2) {
        choices[k] = bi;
        scores[k] = __fsub_rn(bs, nz[bi]);
        const float4 u = util[bi];
        util[bi] = make_float4(__fadd_rn(u.x, a.x), __fadd_rn(u.y, a.y),
                               __fadd_rn(u.z, a.z), __fadd_rn(u.w, a.w));
        bw_used[bi] = __fadd_rn(bw_used[bi], abw);
        ports_free[bi] = __fadd_rn(ports_free[bi], -aports);
        placed[bi] = placed[bi] + 1;
        const int gid = topo_ids[bi];
        if (gid >= 0 && gid < g_pad)
          members[gid] = __fadd_rn(members[gid], 1.0f);
      } else {
        choices[k] = -1;
        scores[k] = 0.0f;
      }
    }
    __syncthreads();
  }

  // ---- 4. all-K: a partial gang never leaves the device
  int missing = 0;
  for (int k = t; k < K; k += blockDim.x)
    if (active[k] && choices[k] < 0) missing = 1;
  const int partial = __syncthreads_or(missing);
  if (partial) {
    for (int k = t; k < K; k += blockDim.x) {
      choices[k] = -1;
      scores[k] = 0.0f;
    }
  }
  if (in_shared)
    for (int g = t; g < g_pad; g += blockDim.x) group_members[g] = members[g];
  if (t == 0) slice_group[0] = partial ? -1 : chosen;
}

// Shapes: capacity/sched/util [N,4] f32; bw_avail/bw_used/ports_free [N]
// f32; feas_row [N] u8; job_count/dh_presence/topo_ids [N] i32;
// ask_res [4] f32, ask_bw/ask_ports [] f32; active [K] u8; noise [K,N]
// f32; group_noise [g_pad] f32; placed [N] i32 and group_members
// [g_pad] f32 (carried: zeros in); util/bw_used/ports_free carried in
// place; out choices [K] i32, scores [K] f32, slice_group [] i32;
// group_cap [g_pad] f32 scratch (read only past 1024 groups).
// mode: 0 free, 1 slice, 2 spread, 3 affinity; any g_pad >= 1.
NT_API int nt_gang_scan(int N, int K, int g_pad, int mode, int dh,
                        float penalty, const void* capacity,
                        const void* sched, void* util, const void* bw_avail,
                        void* bw_used, void* ports_free, const void* feas_row,
                        const void* job_count, const void* dh_presence,
                        const void* topo_ids, const void* ask_res,
                        const void* ask_bw, const void* ask_ports,
                        const void* active, const void* noise,
                        const void* group_noise, void* placed,
                        void* group_members, void* choices, void* scores,
                        void* slice_group, void* group_cap,
                        void* stream) {
  if (K <= 0) return 0;
  if (g_pad < 1) return (int)cudaErrorInvalidValue;
  nt_gang_scan_kernel<<<1, NT_GANG_THREADS, 0, (cudaStream_t)stream>>>(
      N, K, g_pad, mode, dh, penalty, (const float4*)capacity,
      (const float4*)sched, (float4*)util, (const float*)bw_avail,
      (float*)bw_used, (float*)ports_free, (const unsigned char*)feas_row,
      (const int*)job_count, (const int*)dh_presence, (const int*)topo_ids,
      (const float4*)ask_res, (const float*)ask_bw, (const float*)ask_ports,
      (const unsigned char*)active, (const float*)noise,
      (const float*)group_noise, (int*)placed, (float*)group_members,
      (int*)choices, (float*)scores, (int*)slice_group, (float*)group_cap);
  return (int)cudaGetLastError();
}
