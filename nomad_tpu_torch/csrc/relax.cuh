// The convex relaxation's passes (K8a, K9 and K10f / K10g-a), shared by
// csrc/convex_relax.cu (one device) and csrc/sharded_relax.cu (node
// shards): the loop's operands, the row pass (the softmax max and sum
// of each row), the column pass (the contractions over K, the gradient
// and the logits step), the prologue kernels (per node, per ask, per
// pair) and the epilogue kernels (x and the column sums y, the row and
// y maxima, the preference). csrc/convex_relax.cu's header says what
// they compute and what bounds them. Kernels here are static: each
// source that includes this header has its own copy.
#pragma once

#include "common.cuh"

#define NT_RELAX_ROW_THREADS 256
#define NT_RELAX_COL_THREADS 128
#define NT_RELAX_PAIR_THREADS 256

// kernels/convex.py constants (convex.py:70-83 in the JAX package).
#define NT_SOLVE_STEP 0.35f
#define NT_OVER_PENALTY 60.0f
#define NT_PACK_REWARD 6.0f

// The loop's operands, every array carrying a leading B (B = 1 for one
// problem): per node denom [B,N,4] = max(sched_capacity, 1), base_frac
// [B,N,4] = util / denom, bw_denom, base_bw_frac, ports_denom [B,N];
// per ask res_active [B,K,4], bw_active, ports_active, act [B,K] (the
// active flag as 1 or 0); the row statistics row_m, row_s [B,K].
struct NtRelaxLoop {
  int B, N, K;
  float* logits;
  const float* lin;
  const float4* denom;
  const float4* base_frac;
  const float* bw_denom;
  const float* base_bw_frac;
  const float* ports_denom;
  const float4* res_active;
  const float* bw_active;
  const float* ports_active;
  const float* act;
  float* row_m;
  float* row_s;
};

// logits + mask, with the mask as the JAX package passes it (a float
// array of 0 and NEG_INF) or as the feasibility bytes it came from.
struct NtFloatMask {
  const float* m;
  __device__ __forceinline__ float apply(float l, size_t i) const {
    return __fadd_rn(l, m[i]);
  }
};
struct NtFeasMask {
  const unsigned char* f;
  __device__ __forceinline__ float apply(float l, size_t i) const {
    return f[i] ? l : __fadd_rn(l, NT_NEG_INF);
  }
};

// Block-wide max and sum in a fixed tree (shuffles, then warp 0).
__device__ __forceinline__ float nt_block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ float nt_block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// Row pass: block (b, k) computes the softmax max and sum of row k.
template <typename Mask>
static __global__ void __launch_bounds__(NT_RELAX_ROW_THREADS)
nt_relax_rows_kernel(NtRelaxLoop L, Mask mask) {
  __shared__ float red[NT_RELAX_ROW_THREADS / 32];
  const size_t row = (size_t)blockIdx.x * L.N;
  float m = -INFINITY;
  for (int n = threadIdx.x; n < L.N; n += blockDim.x)
    m = fmaxf(m, mask.apply(L.logits[row + n], row + n));
  m = nt_block_max(m, red);
  float s = 0.0f;
  for (int n = threadIdx.x; n < L.N; n += blockDim.x)
    s = __fadd_rn(s, expf(__fsub_rn(mask.apply(L.logits[row + n], row + n),
                                    m)));
  s = nt_block_sum(s, red);
  if (threadIdx.x == 0) {
    L.row_m[blockIdx.x] = m;
    L.row_s[blockIdx.x] = s;
  }
}

// Column pass: thread (b, n) forms x over k, its node terms, then the
// gradient back and the logits step. The contractions over K add in
// float64: in float32 a sum walked in order over K = 1,024 asks drifts
// ~5x farther from a float64 solve than cuBLAS's blocked sum, and the
// relaxation amplifies it.
template <typename Mask>
static __global__ void __launch_bounds__(NT_RELAX_COL_THREADS)
nt_relax_cols_kernel(NtRelaxLoop L, Mask mask) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)L.B * L.N) return;
  const int b = (int)(t / L.N);
  const int n = (int)(t - (size_t)b * L.N);
  const size_t bk0 = (size_t)b * L.K;
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0, abw = 0.0, apo = 0.0;
#pragma unroll 4
  for (int k = 0; k < L.K; ++k) {
    const size_t bk = bk0 + k;
    const size_t i = bk * L.N + n;
    const float v = mask.apply(L.logits[i], i);
    const float x = __fmul_rn(
        __fdiv_rn(expf(__fsub_rn(v, L.row_m[bk])), L.row_s[bk]), L.act[bk]);
    const float4 r = L.res_active[bk];
    const double xd = x;
    a0 = fma(xd, (double)r.x, a0);
    a1 = fma(xd, (double)r.y, a1);
    a2 = fma(xd, (double)r.z, a2);
    a3 = fma(xd, (double)r.w, a3);
    abw = fma(xd, (double)L.bw_active[bk], abw);
    apo = fma(xd, (double)L.ports_active[bk], apo);
  }
  const size_t bn = (size_t)b * L.N + n;
  const float4 d = L.denom[bn];
  const float4 f = L.base_frac[bn];
  const float e0 = f.x + (float)a0 / d.x, e1 = f.y + (float)a1 / d.y;
  const float e2 = f.z + (float)a2 / d.z, e3 = f.w + (float)a3 / d.w;
  const float tot = (((e0 + e1) + e2) + e3) / 4.0f;
  const float pack = (NT_PACK_REWARD / 4.0f) * tot;
  const float two_op = 2.0f * NT_OVER_PENALTY;
  const float t0 = (pack - two_op * fmaxf(e0 - 1.0f, 0.0f)) / d.x;
  const float t1 = (pack - two_op * fmaxf(e1 - 1.0f, 0.0f)) / d.y;
  const float t2 = (pack - two_op * fmaxf(e2 - 1.0f, 0.0f)) / d.z;
  const float t3 = (pack - two_op * fmaxf(e3 - 1.0f, 0.0f)) / d.w;
  const float bwd = L.bw_denom[bn];
  const float obw =
      fmaxf(L.base_bw_frac[bn] + (float)abw / bwd - 1.0f, 0.0f);
  const float pd = L.ports_denom[bn];
  const float opo = fmaxf((float)apo / pd - 1.0f, 0.0f);
  const float cbw = obw / bwd, cpo = opo / pd;
#pragma unroll 4
  for (int k = 0; k < L.K; ++k) {
    const size_t bk = bk0 + k;
    const size_t i = bk * L.N + n;
    const float4 r = L.res_active[bk];
    const float g =
        L.lin[i] + (((t0 * r.x + t1 * r.y) + t2 * r.z) + t3 * r.w) -
        two_op * (L.bw_active[bk] * cbw + L.ports_active[bk] * cpo);
    L.logits[i] = L.logits[i] + NT_SOLVE_STEP * g;
  }
}

#define NT_LAUNCHED()                            \
  do {                                           \
    const cudaError_t e = cudaGetLastError();    \
    if (e != cudaSuccess) return (int)e;         \
  } while (0)

static inline unsigned nt_blocks(size_t items, int threads) {
  return (unsigned)((items + threads - 1) / threads);
}

template <typename Mask>
static inline int nt_relax_iterate(const NtRelaxLoop& L, Mask mask,
                                   int iters, cudaStream_t st) {
  for (int it = 0; it < iters; ++it) {
    nt_relax_rows_kernel<Mask>
        <<<L.B * L.K, NT_RELAX_ROW_THREADS, 0, st>>>(L, mask);
    NT_LAUNCHED();
    nt_relax_cols_kernel<Mask>
        <<<nt_blocks((size_t)L.B * L.N, NT_RELAX_COL_THREADS),
           NT_RELAX_COL_THREADS, 0, st>>>(L, mask);
    NT_LAUNCHED();
  }
  return 0;
}

// ---------------------------------------------------------------- prologue

struct NtRelaxState {
  int mode, B, N, G, K, stacked, shared;
  float penalty;
  const float4* capacity;
  const float4* sched;
  const float* bw_avail;
  const unsigned char* node_ok;
  const float4* util;
  const float* bw_used;
  const float* ports_free;
  const int* job_count;              // [B,N]; placement only
  const int* tg_count;               // [B,N,G]; placement only
  const unsigned char* feasible;     // [B,N,G]; placement only
  const float4* ask_res;             // [B,K,4]
  const float* ask_bw;               // [B,K]
  const float* ask_ports;            // [B,K]
  const int* tg_index;               // [B,K]; placement only
  const unsigned char* active;       // [B,K]
  const unsigned char* job_dh;       // [B]; placement only
  const unsigned char* tg_dh;        // [B,G]; placement only
  const unsigned char* fresh;        // [K]; defrag only
  unsigned char* feas;               // out [B,K,N]
};

// Per node: denom, base_frac, bw_denom, base_bw_frac, ports_denom.
static __global__ void nt_relax_nodes_kernel(NtRelaxState S, NtRelaxLoop L) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)S.B * S.N) return;
  const int b = (int)(t / S.N);
  const int n = (int)(t - (size_t)b * S.N);
  const size_t sn = (S.stacked ? (size_t)b * S.N : 0) + n;
  const size_t cn = (S.shared ? 0 : (size_t)b * S.N) + n;
  const float4 sc = S.sched[sn];
  const float4 u = S.util[cn];
  const float4 d = make_float4(fmaxf(sc.x, 1.0f), fmaxf(sc.y, 1.0f),
                               fmaxf(sc.z, 1.0f), fmaxf(sc.w, 1.0f));
  ((float4*)L.denom)[t] = d;
  ((float4*)L.base_frac)[t] =
      make_float4(__fdiv_rn(u.x, d.x), __fdiv_rn(u.y, d.y),
                  __fdiv_rn(u.z, d.z), __fdiv_rn(u.w, d.w));
  const float bwd = fmaxf(S.bw_avail[sn], 1.0f);
  ((float*)L.bw_denom)[t] = bwd;
  ((float*)L.base_bw_frac)[t] = __fdiv_rn(S.bw_used[cn], bwd);
  ((float*)L.ports_denom)[t] = fmaxf(S.ports_free[cn], 1.0f);
}

// Per ask: the active flag and the asks scaled by it.
static __global__ void nt_relax_asks_kernel(NtRelaxState S, NtRelaxLoop L) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= S.B * S.K) return;
  const float a = S.active[t] ? 1.0f : 0.0f;
  const float4 r = S.ask_res[t];
  ((float4*)L.res_active)[t] = make_float4(
      __fmul_rn(r.x, a), __fmul_rn(r.y, a), __fmul_rn(r.z, a),
      __fmul_rn(r.w, a));
  ((float*)L.bw_active)[t] = __fmul_rn(S.ask_bw[t], a);
  ((float*)L.ports_active)[t] = __fmul_rn(S.ask_ports[t], a);
  ((float*)L.act)[t] = a;
}

// Per (eval, ask, node): the initial-state mask and the linear term;
// the logits start at lin (defrag: fresh rows only).
static __global__ void __launch_bounds__(NT_RELAX_PAIR_THREADS)
nt_relax_pairs_kernel(NtRelaxState S, NtRelaxLoop L) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)S.B * S.K * S.N) return;
  const size_t bk = t / S.N;
  const int n = (int)(t - bk * S.N);
  const int b = (int)(bk / S.K);
  const int k = (int)(bk - (size_t)b * S.K);
  const size_t sn = (S.stacked ? (size_t)b * S.N : 0) + n;
  const size_t cn = (S.shared ? 0 : (size_t)b * S.N) + n;
  const float4 cap = S.capacity[sn];
  const float4 sc = S.sched[sn];
  const float4 u = S.util[cn];
  const float4 a = S.ask_res[bk];
  bool f = S.node_ok[sn] != 0;
  f = f && a.x <= __fsub_rn(cap.x, u.x) && a.y <= __fsub_rn(cap.y, u.y) &&
      a.z <= __fsub_rn(cap.z, u.z) && a.w <= __fsub_rn(cap.w, u.w);
  f = f && S.ask_bw[bk] <= __fsub_rn(S.bw_avail[sn], S.bw_used[cn]);
  f = f && S.ask_ports[bk] <= S.ports_free[cn];
  int jc = 0;
  if (S.mode == 0) {
    const int tg = S.tg_index[bk];
    const size_t ng = ((size_t)b * S.N + n) * S.G + tg;
    jc = S.job_count[(size_t)b * S.N + n];
    f = f && S.feasible[ng] != 0;
    if (S.job_dh[b]) f = f && jc == 0;
    if (S.tg_dh[(size_t)b * S.G + tg]) f = f && S.tg_count[ng] == 0;
  } else {
    f = f && cap.x > 0.0f;
  }
  const float d0 = fmaxf(sc.x, 1.0f), d1 = fmaxf(sc.y, 1.0f);
  const float fc = __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(u.x, a.x), d0));
  const float fm = __fsub_rn(1.0f, __fdiv_rn(__fadd_rn(u.y, a.y), d1));
  float fit = __fsub_rn(20.0f, __fadd_rn(powf(10.0f, fc), powf(10.0f, fm)));
  fit = fminf(fmaxf(fit, 0.0f), 18.0f);
  if (sc.x <= 0.0f || sc.y <= 0.0f) fit = 0.0f;
  if (S.mode == 0) fit = __fsub_rn(fit, __fmul_rn(S.penalty, (float)jc));
  const float lin = f ? fit : 0.0f;
  S.feas[t] = f ? 1 : 0;
  ((float*)L.lin)[t] = lin;
  if (S.mode == 0 || S.fresh[k]) L.logits[t] = lin;
}

// -------------------------------------------------------------- epilogue

// x = softmax(logits + mask) (defrag: * active); placement also sums
// y[b, n] over all K rows, in order, in float64 (as the column pass).
static __global__ void nt_relax_x_kernel(NtRelaxLoop L, NtFeasMask mask,
                                         int mode, float* __restrict__ x,
                                         float* __restrict__ y) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)L.B * L.N) return;
  const int b = (int)(t / L.N);
  const int n = (int)(t - (size_t)b * L.N);
  double acc = 0.0;
  for (int k = 0; k < L.K; ++k) {
    const size_t bk = (size_t)b * L.K + k;
    const size_t i = bk * L.N + n;
    float v = __fdiv_rn(
        expf(__fsub_rn(mask.apply(L.logits[i], i), L.row_m[bk])),
        L.row_s[bk]);
    if (mode == 1) v = __fmul_rn(v, L.act[bk]);
    x[i] = v;
    acc += v;
  }
  if (mode == 0) y[t] = (float)acc;
}

// Block (b, k) < B*K: rowmax[b,k] = max_n x; block B*K + b: ymax[b].
static __global__ void __launch_bounds__(NT_RELAX_ROW_THREADS)
nt_relax_max_kernel(int B, int N, int K, const float* __restrict__ x,
                    const float* __restrict__ y, float* __restrict__ rowmax,
                    float* __restrict__ ymax) {
  __shared__ float red[NT_RELAX_ROW_THREADS / 32];
  const bool is_y = blockIdx.x >= (unsigned)(B * K);
  const float* src = is_y ? y + (size_t)(blockIdx.x - B * K) * N
                          : x + (size_t)blockIdx.x * N;
  float m = -INFINITY;
  for (int n = threadIdx.x; n < N; n += blockDim.x) m = fmaxf(m, src[n]);
  m = nt_block_max(m, red);
  if (threadIdx.x == 0) {
    if (is_y)
      ymax[blockIdx.x - B * K] = m;
    else
      rowmax[blockIdx.x] = m;
  }
}

// pref = (x / (rowmax + 1e-9) + y / (ymax + 1e-9)) * 0.5. x and pref
// may be one buffer (each entry is read, then written, by one thread).
static __global__ void nt_relax_pref_kernel(
    int B, int N, int K, const float* x, const float* __restrict__ y,
    const float* __restrict__ rowmax, const float* __restrict__ ymax,
    float* pref) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * K * N) return;
  const size_t bk = t / N;
  const int n = (int)(t - bk * N);
  const int b = (int)(bk / K);
  const float own = __fdiv_rn(x[t], __fadd_rn(rowmax[bk], 1e-9f));
  const float agg =
      __fdiv_rn(y[(size_t)b * N + n], __fadd_rn(ymax[b], 1e-9f));
  pref[t] = __fmul_rn(__fadd_rn(own, agg), 0.5f);
}

// ---------------------------------------------------------------- layout

// The loop's operands over the scratch layout nt_convex_relax takes:
// node4 [2,B,N,4] (denom, base_frac), node1 [4,B,N] (bw_denom,
// base_bw_frac, ports_denom, y), ask4 [B,K,4] (res_active), ask1
// [6,B,K] (bw_active, ports_active, act, row_m, row_s, rowmax); the
// row statistics at row_m / row_s, or at ``stats`` [2,B,K] when it is
// given (a shard's partial or the combined statistics).
static inline NtRelaxLoop nt_relax_loop(int B, int N, int K, void* logits,
                                        const void* lin, void* node4,
                                        void* node1, const void* ask4,
                                        void* ask1, float* stats) {
  const size_t bn = (size_t)B * N, bk = (size_t)B * K;
  float4* n4 = (float4*)node4;
  float* n1 = (float*)node1;
  float* a1 = (float*)ask1;
  float* row = stats ? stats : a1 + 3 * bk;
  return NtRelaxLoop{B, N, K, (float*)logits, (const float*)lin, n4,
                     n4 + bn, n1, n1 + bn, n1 + 2 * bn, (const float4*)ask4,
                     a1, a1 + bk, a1 + 2 * bk, row, row + bk};
}

// The column sums y [B,N] in node1's scratch.
static inline float* nt_relax_y(int B, int N, void* node1) {
  return (float*)node1 + 3 * (size_t)B * N;
}

// The prologue: per node the denominators and base fractions, per ask
// the active-scaled asks, per pair the mask (feas) and lin, and the
// logits' start.
static inline int nt_relax_prologue(const NtRelaxState& S,
                                    const NtRelaxLoop& L, cudaStream_t st) {
  const size_t bn = (size_t)S.B * S.N, bk = (size_t)S.B * S.K;
  nt_relax_nodes_kernel<<<nt_blocks(bn, 256), 256, 0, st>>>(S, L);
  NT_LAUNCHED();
  nt_relax_asks_kernel<<<nt_blocks(bk, 256), 256, 0, st>>>(S, L);
  NT_LAUNCHED();
  nt_relax_pairs_kernel<<<nt_blocks(bk * S.N, NT_RELAX_PAIR_THREADS),
                          NT_RELAX_PAIR_THREADS, 0, st>>>(S, L);
  NT_LAUNCHED();
  return 0;
}

// The prologue's state over nt_convex_relax's arguments.
static inline NtRelaxState nt_relax_state(
    int mode, int B, int N, int G, int K, float penalty, int stacked,
    int shared, const void* capacity, const void* sched, const void* bw_avail,
    const void* node_ok, const void* util, const void* bw_used,
    const void* ports_free, const void* job_count, const void* tg_count,
    const void* feasible, const void* ask_res, const void* ask_bw,
    const void* ask_ports, const void* tg_index, const void* active,
    const void* job_dh, const void* tg_dh, const void* fresh, void* feas) {
  return NtRelaxState{
      mode, B, N, G, K, stacked, shared, penalty, (const float4*)capacity,
      (const float4*)sched, (const float*)bw_avail,
      (const unsigned char*)node_ok, (const float4*)util,
      (const float*)bw_used, (const float*)ports_free, (const int*)job_count,
      (const int*)tg_count, (const unsigned char*)feasible,
      (const float4*)ask_res, (const float*)ask_bw, (const float*)ask_ports,
      (const int*)tg_index, (const unsigned char*)active,
      (const unsigned char*)job_dh, (const unsigned char*)tg_dh,
      (const unsigned char*)fresh, (unsigned char*)feas};
}
