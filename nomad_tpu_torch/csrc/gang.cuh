// Pieces of the gang kernels (K7, csrc/gang_scan.cu, and K10e,
// csrc/sharded_gang.cu): a node's member units, which both take, and
// one member's mask and score on a node, which K10e takes (ops/gang.py
// _member_units and the scan body of gang_placement_program, in the JAX
// package). Every + - * / is a round-to-nearest intrinsic
// (csrc/common.cuh), so the kernels and the plain version round alike;
// the card tests hold K10e's choices and scores equal to K7's.
#pragma once

#include "common.cuh"

#define NT_GANG_BIG 1e9f
#define NT_GANG_AFFINITY_BONUS 5.0f

enum { NT_GANG_FREE = 0, NT_GANG_SLICE = 1, NT_GANG_SPREAD = 2,
       NT_GANG_AFFINITY = 3 };

__device__ __forceinline__ float nt_units_dim(float free, float ask) {
  return ask > 0.0f ? floorf(__fdiv_rn(free, fmaxf(ask, 1e-9f)))
                    : NT_GANG_BIG;
}

// How many members node n can hold from its free capacity: the min over
// dimensions of floor(free / ask), 1e9 on a zero ask, bounded by
// bandwidth and ports; 0 off the feasibility row; at most 1 under
// distinct_hosts; 0 without a topology id in slice mode.
__device__ __forceinline__ float nt_member_units(
    int n, int mode, bool dh, const float4* __restrict__ capacity,
    const float4* util, const float* __restrict__ bw_avail,
    const float* bw_used, const float* ports_free,
    const unsigned char* __restrict__ feas_row,
    const int* __restrict__ dh_presence, const int* __restrict__ topo_ids,
    float4 a, float abw, float aports) {
  const float4 c = capacity[n];
  const float4 u = util[n];
  float units = fminf(fminf(nt_units_dim(__fsub_rn(c.x, u.x), a.x),
                            nt_units_dim(__fsub_rn(c.y, u.y), a.y)),
                      fminf(nt_units_dim(__fsub_rn(c.z, u.z), a.z),
                            nt_units_dim(__fsub_rn(c.w, u.w), a.w)));
  units = fminf(units, nt_units_dim(__fsub_rn(bw_avail[n], bw_used[n]), abw));
  units = fminf(units, nt_units_dim(ports_free[n], aports));
  units = fmaxf(units, 0.0f);
  if (!feas_row[n]) units = 0.0f;
  if (dh) {
    units = fminf(units, 1.0f);
    if (dh_presence[n] > 0) units = 0.0f;
  }
  if (mode == NT_GANG_SLICE && topo_ids[n] < 0) units = 0.0f;
  return units;
}

// One member on node n at the carried state (K10e's step; K7 keeps
// the part that changes only at a placement in its score cache and adds
// the rest a step, csrc/gang_scan.cu, in the same order of rounded
// operations): true when it fits (the resource, bandwidth and port
// headroom, the feasibility row, the slice ``match`` in slice mode,
// distinct_hosts, the spread cap), with *score
// the gang score plus the member's noise: BestFit-v3 with the
// zero-sched-capacity guard, minus penalty x (job_count + placed), plus
// 5 per member already in the node's group in affinity mode.
// ``members`` holds the per-group member counts [g_pad], ``noise`` the
// member's row of the noise [N].
__device__ __forceinline__ bool nt_gang_node(
    int n, int mode, bool dh, float penalty, int g_pad, int match,
    float spread_cap, const float4* __restrict__ capacity,
    const float4* __restrict__ sched, const float4* util,
    const float* __restrict__ bw_avail, const float* bw_used,
    const float* ports_free, const unsigned char* __restrict__ feas_row,
    const int* __restrict__ job_count, const int* __restrict__ dh_presence,
    const int* __restrict__ topo_ids, const int* placed,
    const float* members, float4 a, float abw, float aports,
    const float* __restrict__ noise, float* score) {
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
  if (dh) fits = fits && pl == 0 && dh_presence[n] == 0;
  const float gcount =
      members[min(max(tid >= 0 ? tid : g_pad, 0), g_pad - 1)];
  if (mode == NT_GANG_SPREAD) fits = fits && (tid < 0 || gcount < spread_cap);
  if (!fits) return false;
  const float f0 = __fsub_rn(1.0f, __fdiv_rn(nu0, fmaxf(sc.x, 1.0f)));
  const float f1 = __fsub_rn(1.0f, __fdiv_rn(nu1, fmaxf(sc.y, 1.0f)));
  float fit = __fsub_rn(20.0f, __fadd_rn(powf(10.0f, f0), powf(10.0f, f1)));
  fit = fminf(fmaxf(fit, 0.0f), 18.0f);
  if (sc.x <= 0.0f || sc.y <= 0.0f) fit = 0.0f;
  float s = __fsub_rn(fit, __fmul_rn(penalty, (float)(job_count[n] + pl)));
  if (mode == NT_GANG_AFFINITY)
    s = __fadd_rn(s, __fmul_rn(NT_GANG_AFFINITY_BONUS,
                               tid >= 0 ? gcount : 0.0f));
  *score = __fadd_rn(s, noise[n]);  // read only where the member fits
  return true;
}
