// Top-K selection of packed (score, index) keys (nt_pack,
// csrc/common.cuh) for the uniform placement kernels: K2 and K10d's
// one-launch path (csrc/uniform_topk.cu), K10d's per-shard path
// (csrc/sharded_topk.cu). Keys are unique (each packs its node index),
// so an exact selection of the K largest gives the set a full sort
// would, and the selected keys come out in descending order, which is
// lax.top_k's order. Key 0 is "no key" (padding): no real key is 0.
//
// Two selections, picked by K:
//
// - K <= NT_TOPK_SMALL (register lists): each thread keeps a sorted
//   list of its best KM keys in registers while it produces its keys;
//   each warp merges its lanes' lists by butterfly (64-bit
//   __shfl_xor_sync of the partner's list, then the KM best of the two
//   sorted lists by a bitonic merge in registers); warp 0 merges the
//   warps' lists the same way, those of its CTA (nt_cta_topk_small) or
//   of its cluster (csrc/uniform_topk.cu: each warp's list reaches every
//   CTA through distributed shared memory before one cluster barrier).
// - larger K (radix select): four MSB-first passes over the score word
//   (the key's high 32 bits) with 256-bin shared-memory histograms
//   (warp-aggregated adds), summed over the cluster's CTAs through
//   distributed shared memory, find the K-th key's score T and how many
//   keys tie at T. A last pass compacts every key above T and, lowest
//   index first, the tied keys still needed (exactly min(K, N) keys).
//   A CTA selecting alone bitonic-sorts only those; in a cluster each
//   CTA counts the rank of its own selected keys (nt_rank_own). A
//   thread keeps its keys in registers across the passes (up to
//   NT_TOPK_RADIX_REGS) or produces them anew in each pass, so no
//   N-sized key buffer exists.
//
// The selections are block-wide: all NT_TOPK_THREADS threads of the
// CTA call them. CL = true: the CTA is one of a thread-block cluster
// whose CTAs select together; CL = false: the CTA selects alone.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define NT_TOPK_THREADS 256
#define NT_TOPK_WARPS (NT_TOPK_THREADS / 32)
// CTAs a cluster (the portable maximum).
#define NT_TOPK_CLUSTER 8
// Largest K that takes the register lists; larger K takes the radix
// select.
#define NT_TOPK_SMALL 32
// Keys a thread keeps in registers across the radix passes (slices up
// to 2,048 nodes a CTA).
#define NT_TOPK_RADIX_REGS 8

// The register lists' length for K (8 or 32), or 0: the radix select.
__host__ __device__ inline int nt_topk_km(int K) {
  return K <= 8 ? 8 : K <= NT_TOPK_SMALL ? 32 : 0;
}

__host__ __device__ inline size_t nt_r16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Scalars and histograms of one CTA's selection, at the start of its
// dynamic shared memory.
struct NtTopkShared {
  unsigned hist[2][256];     // radix digit histograms, by pass parity
  unsigned pub[2][2];        // (keys above T, tied keys kept), by eval parity
  unsigned peer[NT_TOPK_CLUSTER][2];
  unsigned long long ws64[NT_TOPK_WARPS];
  unsigned ws[NT_TOPK_WARPS];
  unsigned digit, krem, gt_add, eq, ngt, own_off, own_n;
};

template <bool CL>
__device__ __forceinline__ void nt_group_sync() {
  if constexpr (CL) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

template <bool CL>
__device__ __forceinline__ int nt_group_size() {
  if constexpr (CL) {
    return (int)cg::this_cluster().num_blocks();
  } else {
    return 1;
  }
}

// Peer r's copy of this CTA's shared-memory object p.
template <bool CL, class T>
__device__ __forceinline__ T* nt_peer(T* p, int r) {
  if constexpr (CL) {
    return cg::this_cluster().map_shared_rank(p, (unsigned)r);
  } else {
    return p;
  }
}

// Insert x into the descending list l (its KM best keys so far).
template <int KM>
__device__ __forceinline__ void nt_list_insert(unsigned long long (&l)[KM],
                                               unsigned long long x) {
  if (x <= l[KM - 1]) return;
#pragma unroll
  for (int j = KM - 1; j > 0; --j)
    l[j] = x > l[j - 1] ? l[j - 1] : (x > l[j] ? x : l[j]);
  l[0] = x > l[0] ? x : l[0];
}

// a becomes the KM best of a and b (both sorted descending), sorted
// descending: max(a[i], b[KM-1-i]) holds exactly those KM keys as a
// bitonic sequence, which a half-cleaner network sorts.
template <int KM>
__device__ __forceinline__ void nt_merge_top(unsigned long long (&a)[KM],
                                             const unsigned long long (&b)[KM]) {
#pragma unroll
  for (int i = 0; i < KM; ++i) a[i] = a[i] > b[KM - 1 - i] ? a[i] : b[KM - 1 - i];
#pragma unroll
  for (int s = KM / 2; s > 0; s >>= 1) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i & s) continue;
      const unsigned long long x = a[i], y = a[i + s];
      a[i] = x > y ? x : y;
      a[i + s] = x > y ? y : x;
    }
  }
}

// Butterfly merge of the lists of lanes that differ in the low
// log2(span) bits of their lane index: each lane ends with the KM best
// of its span's lists.
template <int KM>
__device__ __forceinline__ void nt_warp_merge(unsigned long long (&l)[KM],
                                              int span) {
  for (int o = 1; o < span; o <<= 1) {
    unsigned long long b[KM];
#pragma unroll
    for (int i = 0; i < KM; ++i) b[i] = __shfl_xor_sync(0xffffffffu, l[i], o);
    nt_merge_top<KM>(l, b);
  }
}

// This thread's sorted list of its KM best keys of key(0..count) (its
// items t, t + NT_TOPK_THREADS, ...), the keys made four at a time so
// their loads and arithmetic overlap.
template <int KM, class KeyFn>
__device__ __forceinline__ void nt_thread_list(const KeyFn& key, int count,
                                               unsigned long long (&l)[KM]) {
  constexpr int U = 4;
#pragma unroll
  for (int j = 0; j < KM; ++j) l[j] = 0ull;
  for (int i0 = threadIdx.x; i0 < count; i0 += U * NT_TOPK_THREADS) {
    unsigned long long x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * NT_TOPK_THREADS;
      x[u] = i < count ? key(i) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) nt_list_insert<KM>(l, x[u]);
  }
}

// Entry j of register list l (j < KM; a run-time j indexes by selects,
// so l stays in registers).
template <int KM>
__device__ __forceinline__ unsigned long long nt_list_at(
    const unsigned long long (&l)[KM], int j) {
  unsigned long long x = 0ull;
#pragma unroll
  for (int i = 0; i < KM; ++i)
    if (i == j) x = l[i];
  return x;
}

// This CTA's K best keys of key(0..count), descending into out[0..K),
// 0-padded (K <= KM): each thread's register list, merged in its warp
// by butterfly, the warps' lists (wl: NT_TOPK_WARPS x K keys of
// scratch) merged by warp 0. Closes with a barrier.
template <int KM, class KeyFn>
__device__ __forceinline__ void nt_cta_topk_small(const KeyFn& key, int count,
                                                  int K,
                                                  unsigned long long* wl,
                                                  unsigned long long* out) {
  unsigned long long l[KM];
  nt_thread_list<KM>(key, count, l);
  nt_warp_merge<KM>(l, 32);
  if ((threadIdx.x & 31) == 0) {
    unsigned long long* w = wl + (threadIdx.x >> 5) * K;
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < K) w[j] = l[j];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
#pragma unroll
    for (int j = 0; j < KM; ++j)
      l[j] = lane < NT_TOPK_WARPS && j < K ? wl[lane * K + j] : 0ull;
    nt_warp_merge<KM>(l, NT_TOPK_WARPS);
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < K) out[j] = l[j];
    }
  }
  __syncthreads();
}

// Inclusive suffix sum of v over the CTA's threads (thread t gets the
// sum over threads >= t). Opens and closes with a barrier.
__device__ __forceinline__ unsigned long long nt_block_suffix(
    unsigned long long v, unsigned long long* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_down_sync(0xffffffffu, v, o);
    if (lane + o < 32) v += y;
  }
  __syncthreads();
  if (lane == 0) ws[warp] = v;
  __syncthreads();
  for (int w = warp + 1; w < NT_TOPK_WARPS; ++w) v += ws[w];
  __syncthreads();
  return v;
}

// One round of a histogram pass: every lane of the warp takes part;
// lanes with the same bin add once (warp-aggregated: the passes' keys
// crowd into few bins).
__device__ __forceinline__ void nt_hist_add(unsigned* hist, unsigned bin,
                                            bool valid) {
  const unsigned b = valid ? bin : 256u;
  const unsigned m = __match_any_sync(0xffffffffu, b);
  if (valid && (int)(threadIdx.x & 31) == __ffs(m) - 1)
    atomicAdd(&hist[bin], (unsigned)__popc(m));
}

struct NtCompact {
  NtTopkShared* sh;
  unsigned long long* mine;
  unsigned prefix, own_gt, take;
  unsigned eq_base;

  // One round of the compaction (block-uniform; opens and closes with
  // a barrier): keys above the threshold go anywhere in mine[0,
  // own_gt), tied keys in node order after them, the first ``take``.
  __device__ __forceinline__ void round(unsigned long long x, bool in) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned w = (unsigned)(x >> 32);
    const bool gt = in && w > prefix, eq = in && w == prefix;
    const unsigned below = (1u << lane) - 1u;
    const unsigned bg = __ballot_sync(0xffffffffu, gt);
    unsigned at = 0;
    if (lane == 0 && bg) at = atomicAdd(&sh->ngt, (unsigned)__popc(bg));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (gt) mine[at + __popc(bg & below)] = x;
    const unsigned be = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) sh->ws[warp] = __popc(be);
    __syncthreads();
    unsigned before = eq_base + __popc(be & below), all = 0;
    for (int v = 0; v < NT_TOPK_WARPS; ++v) {
      if (v < warp) before += sh->ws[v];
      all += sh->ws[v];
    }
    if (eq && before < take) mine[own_gt + before] = x;
    eq_base += all;
    __syncthreads();
  }
};

// Radix select of the group's k_eff (>= 1) largest keys, each CTA
// producing key(0..count) (its node slice, in node order). Leaves them
// in sel[0..k_eff) of every CTA, in no order, this CTA's own at
// sel[sh->own_off, sh->own_off + sh->own_n). ``mine`` (>= k_eff keys)
// and ``pub`` [2] are this eval's parity buffers, which the group's
// CTAs read after the group barrier. Ties at the threshold keep the
// lowest index: the tied keys are counted in node order within a CTA
// and in rank order across the CTAs, whose slices ascend with their
// rank. A slice of up to R x NT_TOPK_THREADS keys keeps them in
// registers across the passes; a larger one produces them anew in each
// pass. Closes with a barrier.
template <bool CL, int R, class KeyFn>
__device__ void nt_radix_select(const KeyFn& key, int count, int k_eff,
                                NtTopkShared* sh, unsigned long long* mine,
                                unsigned* pub, unsigned long long* sel) {
  const int t = threadIdx.x;
  const int nc = nt_group_size<CL>();
  const bool cached = count <= R * NT_TOPK_THREADS;
  unsigned long long kr[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = t + j * NT_TOPK_THREADS;
    kr[j] = cached && i < count ? key(i) : 0ull;
  }
  unsigned prefix = 0, krem = (unsigned)k_eff, own_gt = 0, own_eq = 0;
  for (int p = 0; p < 4; ++p) {
    const int shift = 24 - 8 * p;
    unsigned* hist = sh->hist[p & 1];
    hist[t] = 0;
    __syncthreads();
    const unsigned hi = p == 0 ? 0u : (0xffffffffu << (shift + 8));
    if (cached) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (j * NT_TOPK_THREADS >= count) break;
        const unsigned w = (unsigned)(kr[j] >> 32);
        nt_hist_add(hist, (w >> shift) & 255u,
                    t + j * NT_TOPK_THREADS < count &&
                        (w & hi) == (prefix & hi));
      }
    } else {
      for (int c0 = 0; c0 < count; c0 += NT_TOPK_THREADS) {
        const int i = c0 + t;
        const unsigned w = i < count ? (unsigned)(key(i) >> 32) : 0u;
        nt_hist_add(hist, (w >> shift) & 255u,
                    i < count && (w & hi) == (prefix & hi));
      }
    }
    nt_group_sync<CL>();
    unsigned c = 0;
    for (int r = 0; r < nc; ++r) c += nt_peer<CL>(hist, r)[t];
    const unsigned o = hist[t];
    const unsigned long long suf =
        nt_block_suffix(((unsigned long long)c << 32) | o, sh->ws64);
    const unsigned sc = (unsigned)(suf >> 32), so = (unsigned)suf;
    if (sc >= krem && sc - c < krem) {  // the bin holding the k-th key
      sh->digit = (unsigned)t;
      sh->krem = krem - (sc - c);
      sh->gt_add = so - o;
      sh->eq = o;
    }
    __syncthreads();
    prefix |= sh->digit << shift;
    krem = sh->krem;
    own_gt += sh->gt_add;
    own_eq = sh->eq;
  }
  // prefix is T, krem the tied keys the selection still needs.
  if (t == 0) sh->ngt = 0;
  __syncthreads();
  NtCompact cp{sh, mine, prefix, own_gt, own_eq < krem ? own_eq : krem, 0};
  if (cached) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j * NT_TOPK_THREADS >= count) break;
      cp.round(kr[j], t + j * NT_TOPK_THREADS < count);
    }
  } else {
    for (int c0 = 0; c0 < count; c0 += NT_TOPK_THREADS) {
      const int i = c0 + t;
      cp.round(i < count ? key(i) : 0ull, i < count);
    }
  }
  if (t == 0) {
    pub[0] = own_gt;
    pub[1] = cp.take;
  }
  nt_group_sync<CL>();
  if (t < nc) {
    const unsigned* pp = nt_peer<CL>(pub, t);
    sh->peer[t][0] = pp[0];
    sh->peer[t][1] = pp[1];
  }
  __syncthreads();
  unsigned off = 0, left = krem;
  const int me = CL ? (int)cg::this_cluster().block_rank() : 0;
  for (int r = 0; r < nc; ++r) {
    const unsigned tk = sh->peer[r][1] < left ? sh->peer[r][1] : left;
    left -= tk;
    const unsigned n_r = sh->peer[r][0] + tk;
    const unsigned long long* src = nt_peer<CL>(mine, r);
    for (unsigned j = t; j < n_r; j += NT_TOPK_THREADS) sel[off + j] = src[j];
    if (r == me) {
      sh->own_off = off;
      sh->own_n = n_r;
    }
    off += n_r;
  }
  __syncthreads();
}

// nt_radix_select, then the k_eff keys sorted: sel[0..k_pad) descending
// and 0-padded (k_pad a power of two >= k_eff). Closes with a barrier.
template <bool CL, int R, class KeyFn>
__device__ __forceinline__ void nt_radix_topk(const KeyFn& key, int count,
                                              int k_eff, int k_pad,
                                              NtTopkShared* sh,
                                              unsigned long long* mine,
                                              unsigned* pub,
                                              unsigned long long* sel) {
  nt_radix_select<CL, R>(key, count, k_eff, sh, mine, pub, sel);
  for (int j = k_eff + (int)threadIdx.x; j < k_pad; j += NT_TOPK_THREADS)
    sel[j] = 0ull;
  nt_bitonic_desc(sel, nullptr, k_pad);
}

// Each of this CTA's selected keys (sel[sh->own_off, + sh->own_n)) with
// its rank among the k_eff selected keys, its position in the sorted
// top K: f(rank, key) runs once a key. The keys are ranked by counting,
// by up to 32 lanes each when there are few.
template <class F>
__device__ __forceinline__ void nt_rank_own(const unsigned long long* sel,
                                            int k_eff, const NtTopkShared* sh,
                                            const F& f) {
  const int t = threadIdx.x;
  const unsigned off = sh->own_off, n_own = sh->own_n;
  int g = 1;  // lanes a key, a power of two
  while (g < 32 && (unsigned)(2 * g) * n_own <= NT_TOPK_THREADS) g <<= 1;
  for (unsigned q0 = 0; q0 < n_own; q0 += NT_TOPK_THREADS / g) {
    const unsigned q = q0 + t / g;
    const bool has = q < n_own;
    const unsigned long long x = has ? sel[off + q] : 0ull;
    int rank = 0;
    if (has) {
#pragma unroll 8
      for (int m = t % g; m < k_eff; m += g) rank += sel[m] > x ? 1 : 0;
    }
    for (int o = 1; o < g; o <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, o);
    if (has && t % g == 0) f(rank, x);
  }
}

// Whether sorted (descending, 0-padded) list top[0..n) holds x; its
// position, else -1.
__device__ __forceinline__ int nt_find_desc(const unsigned long long* top,
                                            int n, unsigned long long x) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    const int mid = (lo + hi) >> 1;
    const unsigned long long y = top[mid];
    if (y == x) return mid;
    if (y > x) lo = mid + 1;
    else hi = mid - 1;
  }
  return -1;
}
