// The thread-block cluster machinery of the scans that split the node
// axis over a cluster of CTAs (K1 and K8b: csrc/greedy_scan.cu and
// csrc/convex_round.cu; K7: csrc/gang_scan.cu; and over the segments
// of node shards of one card, K10c, K10g-b and K10e): bulk copies of a
// slice's rows into shared memory on an mbarrier, one st.async key
// exchange a step for the cluster's argmax, the clock of a step's parts,
// and the launch of one kernel as a cluster, its attributes set once a
// device.
//
// The exchange: each warp reduces its threads' best (score, index) to
// one packed key (nt_pack's order) with two __reduce_max_sync, warp 0
// reduces the warps' keys after one block barrier, and its lane r sends
// the CTA's key to CTA r's slot for this CTA with st.async, which
// completes on CTA r's key mbarrier (slots and mbarriers double-buffered
// by step parity); every thread waits on its own CTA's mbarrier, then
// reduces the cluster's keys in its own shared memory to the same
// winner. A peer cannot send step s + 2's key before every thread of
// the cluster has read step s's: it first needs their step s + 1 keys.
// (Measured on the H100: a cluster barrier a step cost 0.3-0.6 us more
// than st.async, and a key a warp instead of a CTA ~2 ns a key.)
#pragma once

#include <cooperative_groups.h>

#include <atomic>

#include "common.cuh"

namespace cg = cooperative_groups;

// Most threads a CTA (the plans take fewer where slices are short).
#define NT_SCAN_THREADS 1024
// Most CTAs a cluster (above 8: a non-portable cluster size).
#define NT_SCAN_CLUSTER_MAX 16
// Shared-memory bytes a CTA may take (227 KB on sm_90).
#define NT_SCAN_SMEM_MAX (227 * 1024)
// Of those, kept from the dynamic shared memory of the kernels' segment
// forms: each CTA's static copy of its segment's row (ops/scan.py
// SEGMENT_SMEM).
#define NT_SCAN_SEG_SMEM 1024
// Noise rows (and K8b's pref rows) staged ahead of the step that reads
// them.
#define NT_SCAN_STAGES 4

// Parts of a step, timed by one thread of rank 0 when a kernel is timed
// (topk_profile.py --sections scan): the wait for staged rows, the
// asks' loads, the scoring pass, the warp reduction and the keys'
// sends, the work done while the keys travel (K1's next draw), the wait
// for the cluster's keys, and the winner's reduction and update.
enum { NT_P_WAIT, NT_P_ASK, NT_P_SCORE, NT_P_BLOCK, NT_P_DRAW, NT_P_EXCH,
       NT_P_WIN, NT_P_PARTS };

__host__ __device__ inline size_t nt_r16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// A staging region for ``bytes`` of rows: room for the 16-byte-aligned
// superset the bulk copy moves (ops/scan.py stage_len).
__host__ __device__ inline size_t nt_stage_len(size_t bytes) {
  return nt_r16(bytes) + 32;
}

// The bytes of the 16-byte-aligned superset of [src, src + len).
__device__ __forceinline__ unsigned nt_superset(const void* src, size_t len) {
  if (len == 0) return 0;
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  const uintptr_t e = ((uintptr_t)src + len + 15) & ~(uintptr_t)15;
  return (unsigned)(e - a);
}

// One bulk copy of that superset into ``region`` on ``bar``: the rows
// land at nt_staged(region, src). The superset lies in the pages of
// [src, src + len) (no 16-byte block straddles a page), and the bytes
// around the rows are never read.
__device__ __forceinline__ void nt_bulk(unsigned char* region,
                                        const void* src, size_t len,
                                        uint64_t* bar) {
  if (len == 0) return;
  const uintptr_t a = (uintptr_t)src & ~(uintptr_t)15;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(nt_saddr(region)),
      "l"(a), "r"(nt_superset(src, len)), "r"(nt_saddr(bar))
      : "memory");
}

// Post ``tx`` bytes of transfers on ``bar``'s phase (its one arrival).
__device__ __forceinline__ void nt_expect(uint64_t* bar, unsigned tx) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          nt_saddr(bar)),
      "r"(tx)
      : "memory");
}

// nt_expect for bulk copies into a region last read through the
// generic proxy.
__device__ __forceinline__ void nt_expect_bulk(uint64_t* bar, unsigned tx) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  nt_expect(bar, tx);
}

// The cluster barrier (.aligned: the warp's lanes arrive together).
__device__ __forceinline__ void nt_cluster_arrive_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// nt_pack's high word: the score's bits mapped so that unsigned order
// is float order (-0 ranks as +0); never 0 for a score.
__device__ __forceinline__ unsigned nt_score_word(float s) {
  const uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Clock cycles of a step's parts, kept by the timed thread of a
// TIMED kernel in shared memory (acc) and written out at the end; in
// an untimed kernel it holds nothing.
template <bool TIMED>
struct NtClock {
  bool on;
  long long clk;
  long long* acc;

  __device__ __forceinline__ void tick(int part) {
    if constexpr (TIMED) {
      if (on) {
        const long long now = clock64();
        acc[part] += now - clk;
        clk = now;
      }
    }
  }
};

__device__ __forceinline__ uint32_t nt_mapa(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// A thread's view of the keys' exchange: its CTA's warp keys [2][W],
// the cluster's CTA keys [2][nc] and key mbarriers [2] (by step
// parity), and for lane r < nc the shared::cluster addresses of CTA
// r's CTA keys and key mbarriers.
struct NtExchange {
  unsigned long long* wkeys;
  unsigned long long* keys;
  uint64_t* kbar;
  uint32_t peer_keys, peer_kbar;
  int nc, rank, warps;
};

// The exchange over the slots at byte ``slots`` of shared memory (CTA
// keys [2][nc], then warp keys [2][warps]) and the two key mbarriers at
// ``kbar``.
__device__ __forceinline__ NtExchange nt_exchange(unsigned char* smem,
                                                  size_t slots,
                                                  uint64_t* kbar, int nc,
                                                  int rank, int warps) {
  const int lane = threadIdx.x & 31;
  NtExchange x;
  x.keys = (unsigned long long*)(smem + slots);
  x.wkeys = x.keys + 2 * nc;
  x.kbar = kbar;
  x.peer_keys = nt_mapa(nt_saddr(x.keys), lane < nc ? lane : 0);
  x.peer_kbar = nt_mapa(nt_saddr(x.kbar), lane < nc ? lane : 0);
  x.nc = nc;
  x.rank = rank;
  x.warps = warps;
  return x;
}

// Post step s's keys (nc x 8 bytes) on this CTA's key mbarrier of its
// parity. Posted two steps ahead (after step s - 2's keys are in), so
// that no key of step s arrives before its phase is posted.
__device__ __forceinline__ void nt_expect_keys(const NtExchange& x, int s) {
  nt_expect(&x.kbar[s & 1], (unsigned)(8 * x.nc));
}

// The largest of the keys ``m`` across a warp (hi: score word, lo:
// 0xffffffff - node index), in every lane.
__device__ __forceinline__ unsigned long long nt_warp_max(
    unsigned long long m) {
  const unsigned h = __reduce_max_sync(0xffffffffu, (unsigned)(m >> 32));
  const unsigned l = __reduce_max_sync(
      0xffffffffu, (unsigned)(m >> 32) == h ? (unsigned)m : 0u);
  return ((unsigned long long)h << 32) | l;
}

// The largest of every thread's key across the CTA, in every thread,
// through ``wk`` (one slot a warp); opens and closes with a barrier, so
// ``wk`` may be taken again at once.
__device__ __forceinline__ unsigned long long nt_block_max(
    unsigned long long key, unsigned long long* wk) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned long long w = nt_warp_max(key);
  __syncthreads();
  if (lane == 0) wk[warp] = w;
  __syncthreads();
  const unsigned long long r = nt_warp_max(lane < warps ? wk[lane] : 0ull);
  __syncthreads();
  return r;
}

// The cluster's winner of step s from each thread's best key (0: no
// node): each warp's largest into the CTA's warp keys, one block
// barrier, warp 0's largest of those sent to every CTA's slot for this
// CTA (st.async, completing on that CTA's key mbarrier), ``gap()`` (work
// that does not need the winner), the wait for the cluster's keys, then
// the largest of them in every thread.
template <bool TIMED, class Gap>
__device__ __forceinline__ unsigned long long nt_cluster_argmax(
    unsigned long long key, const NtExchange& x, int s,
    NtClock<TIMED>& clock, const Gap& gap) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int par = s & 1;
  const unsigned long long wk = nt_warp_max(key);
  if (lane == 0) x.wkeys[par * x.warps + warp] = wk;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long ck =
        nt_warp_max(lane < x.warps ? x.wkeys[par * x.warps + lane] : 0ull);
    if (lane < x.nc)
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 "
          "[%0], %1, [%2];\n" ::"r"(
              x.peer_keys + (uint32_t)(8 * (par * x.nc + x.rank))),
          "l"(ck), "r"(x.peer_kbar + (uint32_t)(8 * par))
          : "memory");
  }
  clock.tick(NT_P_BLOCK);
  gap();
  clock.tick(NT_P_DRAW);
  nt_mbar_wait(&x.kbar[par], (unsigned)((s >> 1) & 1));
  clock.tick(NT_P_EXCH);
  return nt_warp_max(lane < x.nc ? x.keys[par * x.nc + lane] : 0ull);
}

// Sets a kernel's attributes: the largest dynamic shared memory (less
// a segment form's static row), and clusters above the portable 8 CTAs.
static int nt_scan_attrs(const void* fn, bool seg = false) {
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      NT_SCAN_SMEM_MAX - (seg ? NT_SCAN_SEG_SMEM : 0));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// ``clusters`` clusters of ``ctas`` CTAs of ``threads``, ``smem`` bytes
// of dynamic shared memory each, on ``stream``; ``attr`` holds the
// cluster dimension.
static cudaLaunchConfig_t nt_scan_cfg(int clusters, int ctas, int threads,
                                      size_t smem, cudaStream_t stream,
                                      cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * ctas), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

static bool nt_scan_shape_ok(int ctas, int threads) {
  return ctas >= 1 && ctas <= NT_SCAN_CLUSTER_MAX && threads >= 32 &&
         threads <= NT_SCAN_THREADS && threads % 32 == 0;
}

// Kernel attributes belong to each device's context: ``set_all`` (which
// sets a file's kernels' attributes on the current device) runs once a
// device in ``ready`` (every call on a device past the table's end).
#define NT_SCAN_DEVICES 64

template <class F>
static int nt_once_a_device(std::atomic<int>* ready, const F& set_all) {
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return (int)got;
  const bool kept = dev >= 0 && dev < NT_SCAN_DEVICES;
  if (kept && ready[dev].load()) return 0;
  const int err = set_all();
  if (err) return err;
  if (kept) ready[dev].store(1);
  return 0;
}

// The clusters of one kernel's launch shape that the card holds at once,
// into *clusters (0: the card refuses such a cluster); no kernel runs.
static void nt_cluster_occupancy(const void* fn, int ctas, int threads,
                                 size_t smem, int* clusters) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      nt_scan_cfg(1, ctas, threads, smem, nullptr, attr);
  if (cudaOccupancyMaxActiveClusters(clusters, fn, &cfg) != cudaSuccess) {
    *clusters = 0;
    cudaGetLastError();  // a refused shape is an answer, not a fault
  }
}

// The cluster scan's launch (csrc/greedy_scan.cu), K1's and K8b's: K8b
// (csrc/convex_round.cu nt_convex_round) passes its rounding
// preference ``pref`` [B,K,N] (null for K1) and reads the noise.
// Arguments as nt_greedy_scan's.
int nt_scan_launch(int B, int N, int G, int K, float penalty, int seq,
                   int stacked, int ctas, int threads, int resident,
                   int draw, int stage_noise, int eval_bufs, int cache,
                   long long smem, const void* capacity, const void* sched,
                   const void* bw_avail, const void* node_ok, void* util,
                   void* bw_used, void* ports_free, void* job_count,
                   void* tg_count, const void* feasible, const void* ask_res,
                   const void* ask_bw, const void* ask_ports,
                   const void* tg_index, const void* active,
                   const void* job_dh, const void* tg_dh, const void* keys,
                   float scale, long long draw_total, long long draw_lo,
                   const void* noise, const void* pref, void* choices,
                   void* scores, void* prof, void* stream);
