// A whole BFS in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces: gunrockinst_tpu/ops/pallas_mega.py:566 `_make_chain_kernel`
// (wrapper `ChainBfs`, pallas_mega.py:732).  Same function at the
// word-map interface (bit b of word w is vertex 32w+b):
//
//   frontier = visited = {src}; depth = 0
//   while frontier is not empty and depth < max_depth:
//     next       = vertices with an in-edge from the frontier
//     nfw        = next & ~visited
//     visited   |= nfw
//     planes[b] |= nfw  for each bit b set in depth + 1
//     frontier   = nfw; depth += 1
//
// so `depth` counts the last, empty level, as the reference's does.
// The TPU design (hub and packed tiles, 32K-vertex source regions, a
// 4-deep DMA ring, the region skip) does not carry over.
//
// What bounds it on the card: the latency of a level, not bytes.  A
// search moves each out-edge id and offset once (~17 MB at grid-1024^2,
// ~5 us at 3.35 TB/s), but a road-like search runs thousands of levels
// of a few thousand edges each, and every level is a chain of dependent
// accesses ended by a barrier across all the threads that share it.
//
// Design: the whole search runs on ONE thread-block cluster (a launch of
// `cluster` blocks of 1024 threads, cudaLaunchKernelEx with a cluster
// dimension), so a level ends with a hardware cluster barrier
// (barrier.cluster arrive/wait, through cooperative_groups) instead of a
// barrier across the whole card, and the frontier lists live in rank 0's
// shared memory, which the other blocks reach as distributed shared
// memory (DSMEM).  The visited map has two placements:
//   * `shared_map`: one block (cluster of 1) holds the whole map in its
//     shared memory and claims with shared-memory atomicOr, then copies it
//     to `vw` at the end.  The wrapper takes it for a search with few
//     wide levels (at most one in eight wider than two vertices a thread)
//     whose map fits a block (a graph of up to ~1.8 M vertices);
//   * otherwise the map is `vw` itself in global memory, claimed with
//     integer atomicOr at L2, by a cluster of kGlobalCluster blocks.
// The frontier lists of two levels (by level parity) keep their first `q`
// entries in rank 0's shared memory and the rest in `lists`, read through
// L2 (__ldcg), never from a stale L1 line; the list lengths are three
// counters there, by level mod 3.
// One level:
//   1. Each thread takes frontier vertices (one a lane), reads its
//      out-offsets and claims its out-neighbours kBatch ids at a time (the
//      loads, then the atomics, all in flight); out-lists longer than
//      kLaneDegree are walked by the whole warp, 32 ids a step.  A thread
//      whose atomicOr set the bit owns the new vertex: it appends it to
//      the next list (one warp-aggregated atomicAdd on the level's count)
//      and stores its level (a plain store).
//   2. Cluster barrier; every thread reads the level's count (the same
//      value in all of them) and leaves the loop when it is 0.
// The counter a level adds to was reset a level before, and the one it
// resets was last read a level before, so one barrier a level orders
// them.  A second, plain launch then builds every label plane word from
// the levels of its word's visited vertices, one thread a word: no plane
// word is touched during the search.  The loop is bounded by max_depth =
// n + 1, so the kernel ends on any input.  Only integer atomics (OR, add)
// are used, and every output is an OR, a level or a count, so the
// outputs are the same on every run.  A block leaves only after a last
// cluster barrier, so no block's shared memory goes away while another
// may read it.
//
// Measured on an H100 SXM at 700 W (PERF.md section 6): one block with the
// map in shared memory beat clusters of 2-16 blocks at grid-1024^2 and on
// a 2045-vertex path (a level with one vertex of work ~1.5 us, against
// ~6 us for the two grid-wide barriers of the design this one replaced)
// and 8 blocks with the global map on rmat-s18 with a 400-vertex tail
// (a few very wide levels); 8 blocks with the global map took 46% of one
// block's time on a 112^3 lattice (hundreds of levels of 2-9 K
// vertices, each a few dependent passes for one block).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kLaneDegree = 32;   // larger out-lists are read by the warp
constexpr int kBatch = 4;         // out-ids a lane loads before it claims
constexpr int kGlobalCluster = 8;  // blocks when the map is in global memory
constexpr unsigned kFull = 0xffffffffu;

struct Search {
  uint32_t* map;           // the visited words: shared or global memory
  int q;                   // list entries kept in rank 0's shared memory
  int32_t* s_next;         // the next frontier: its first q entries there,
  int32_t* g_next;         // the rest in global memory (same index)
  int32_t* level;          // (n,) each claimed vertex's level
  int* count;              // claims of this level, in rank 0's shared memory
  int d;                   // the level being claimed

  // Claims the vertices ids[k] (negative: none) for level d: one integer
  // atomicOr each, all in flight; the ones whose bit this thread set go
  // on the next frontier list (one warp-aggregated atomicAdd on the
  // level's count) with their level.  Every lane of the warp calls it.
  __device__ __forceinline__ void claim(const int (&ids)[kBatch]) const {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;
    bool got[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      got[k] = false;
      if (ids[k] >= 0) {
        const uint32_t bit = 1u << (ids[k] & 31);
        got[k] = !(atomicOr(map + (ids[k] >> 5), bit) & bit);
      }
    }
    unsigned mask[kBatch];
    int total = 0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      mask[k] = __ballot_sync(kFull, got[k]);
      total += __popc(mask[k]);
    }
    if (total == 0) return;           // uniform
    int at = 0;
    if (lane == 0) at = atomicAdd(count, total);
    at = __shfl_sync(kFull, at, 0);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (got[k]) {
        const int i = at + __popc(mask[k] & below);
        if (i < q) s_next[i] = ids[k];
        else g_next[i] = ids[k];
        level[ids[k]] = d;
      }
      at += __popc(mask[k]);
    }
  }
};

__global__ void __launch_bounds__(kThreads, 1)
chain_bfs_kernel(const int32_t* __restrict__ out_off,   // (n+1,) CSR offsets
                 const int32_t* __restrict__ out_dst,   // (m,) out-neighbours
                 uint32_t* __restrict__ vw,             // (n_words,) out
                 int32_t* __restrict__ lists,           // (2*n,) scratch
                 int32_t* __restrict__ level,           // (n,) out
                 int32_t* __restrict__ depth_out,       // (1,) out
                 int src, int n, int n_words, int max_depth,
                 bool shared_map, int q) {
  // dynamic shared memory: the visited map (shared_map), then (rank 0's
  // are used) the first q entries of the two frontier lists
  extern __shared__ __align__(16) uint32_t s_dyn[];
  __shared__ int s_count[3];   // rank 0's: claims by level mod 3
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_threads = static_cast<int>(cluster.num_blocks()) * kThreads;
  const int tid = rank * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int* count = cluster.map_shared_rank(s_count, 0);
  const int map_words = shared_map ? n_words : 0;
  int32_t* s_lists = cluster.map_shared_rank(
      reinterpret_cast<int32_t*>(s_dyn + map_words), 0);
  uint32_t* map = shared_map ? s_dyn : vw;

  // init: visited = frontier = {src}, at level 0
  const int src_w = src >> 5;
  const uint32_t src_bit = 1u << (src & 31);
  for (int i = tid; i < n_words; i += n_threads)
    map[i] = i == src_w ? src_bit : 0u;
  if (tid == 0) {
    s_count[1] = 0;
    if (q > 0) s_lists[0] = src;
    else lists[0] = src;
    level[src] = 0;
  }
  cluster.sync();

  Search s{map, q, nullptr, nullptr, level, nullptr, 0};
  int depth = 0, nf = 1;
  while (true) {
    const int d = depth + 1;
    const int32_t* s_front = s_lists + (depth & 1) * q;
    const int32_t* g_front = lists + static_cast<size_t>(depth & 1) * n;
    s.d = d;
    s.count = count + d % 3;
    s.s_next = s_lists + (d & 1) * q;
    s.g_next = lists + static_cast<size_t>(d & 1) * n;
    if (tid == 0) s_count[(d + 1) % 3] = 0;   // rank 0; read a level ago
    for (int base = tid - lane; base < nf; base += n_threads) {   // uniform
      const int f = base + lane;
      int beg = 0, stop = 0;
      if (f < nf) {
        const int u = f < q ? s_front[f] : __ldcg(g_front + f);
        beg = __ldg(out_off + u);
        stop = __ldg(out_off + u + 1);
      }
      const bool by_lane = stop - beg <= kLaneDegree;
      int e = by_lane ? beg : stop;
      while (__any_sync(kFull, e < stop)) {
        int ids[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k)
          ids[k] = e + k < stop ? __ldg(out_dst + e + k) : -1;
        s.claim(ids);
        e += kBatch;
      }
      uint32_t hubs = __ballot_sync(kFull, !by_lane);
      while (hubs != 0) {               // uniform: same mask in every lane
        const int h = __ffs(hubs) - 1;
        hubs &= hubs - 1;
        const int hb = __shfl_sync(kFull, beg, h);
        const int he = __shfl_sync(kFull, stop, h);
        for (int b = hb; b < he; b += 32 * kBatch) {
          int ids[kBatch];
#pragma unroll
          for (int k = 0; k < kBatch; ++k) {
            const int at = b + 32 * k + lane;
            ids[k] = at < he ? __ldg(out_dst + at) : -1;
          }
          s.claim(ids);
        }
      }
    }
    cluster.sync();
    depth = d;
    nf = *static_cast<volatile int*>(count + d % 3);   // the same in all
    if (nf == 0 || depth >= max_depth) break;
  }
  if (shared_map) {
    for (int i = threadIdx.x; i < n_words; i += kThreads) vw[i] = s_dyn[i];
  }
  if (tid == 0) depth_out[0] = depth;
  cluster.sync();   // rank 0's counts and lists are read up to here
}

// The label planes from the levels: plane b of word w holds bit b of the
// level of each visited vertex of the word.  One thread a word.
__global__ void __launch_bounds__(256)
chain_planes_kernel(const uint32_t* __restrict__ vw,
                    const int32_t* __restrict__ level,
                    uint32_t* __restrict__ planes, int n, int n_words,
                    int n_planes) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= n_words) return;
  const uint32_t seen = __ldg(vw + w);
  uint32_t out[31];
#pragma unroll
  for (int b = 0; b < 31; ++b) out[b] = 0u;
  for (uint32_t rest = seen; rest != 0u; rest &= rest - 1u) {
    const int i = __ffs(rest) - 1;
    const uint32_t lv = static_cast<uint32_t>(__ldg(level + w * 32 + i));
#pragma unroll
    for (int b = 0; b < 31; ++b) out[b] |= ((lv >> b) & 1u) << i;
  }
  for (int b = 0; b < n_planes; ++b)
    planes[static_cast<size_t>(b) * n_words + w] = out[b];
}

}  // namespace

// The dynamic shared memory (bytes) one block of the kernel may hold on
// the current card: the opt-in limit less the kernel's static shared
// memory.  Returns the cudaError_t of the queries.
extern "C" int gt_chain_bfs_smem_limit(int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, chain_bfs_kernel);
  if (err == cudaSuccess)
    *bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(err);
}

// Runs one whole search from `src` on `stream`: with `shared_map`, on one
// block holding the visited map in its shared memory, else on a cluster
// of kGlobalCluster blocks with the map `vw` in global memory; rank 0
// holds the first `q` entries of each of the two frontier lists in its
// shared memory (the rest in `lists`, 2*n ints).  Then builds the label
// planes from the levels (`level`, n ints).
// Returns the cudaError_t of the first step that failed (0 on success)
// and names that step in *failed_step: 1 the shared-memory opt-in, 2 the
// cluster occupancy query, 3 no such cluster fits on the card (the error
// is then cudaErrorInvalidConfiguration), 4 the launches.
extern "C" int gt_chain_bfs(const void* out_off, const void* out_dst,
                            void* planes, void* vw, void* lists, void* level,
                            void* depth_out, int src, int n, int n_words,
                            int n_planes, int max_depth, int shared_map,
                            int q, void* stream, int* failed_step) {
  *failed_step = 0;
  if (q < 0 || n < 1 || n_planes < 1 || n_planes > 31) {
    *failed_step = 4;
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cluster = shared_map ? 1 : kGlobalCluster;
  const int smem = (shared_map ? 4 * n_words : 0) + 8 * q;
  cudaError_t err = cudaFuncSetAttribute(
      chain_bfs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    *failed_step = 1;
    return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fits = 0;
  err = cudaOccupancyMaxActiveClusters(&fits, chain_bfs_kernel, &cfg);
  if (err != cudaSuccess) {
    *failed_step = 2;
    return static_cast<int>(err);
  }
  if (fits < 1) {
    *failed_step = 3;
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  err = cudaLaunchKernelEx(
      &cfg, chain_bfs_kernel, static_cast<const int32_t*>(out_off),
      static_cast<const int32_t*>(out_dst), static_cast<uint32_t*>(vw),
      static_cast<int32_t*>(lists), static_cast<int32_t*>(level),
      static_cast<int32_t*>(depth_out), src, n, n_words, max_depth,
      shared_map != 0, q);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) {
    chain_planes_kernel<<<(n_words + 255) / 256, 256, 0, cfg.stream>>>(
        static_cast<const uint32_t*>(vw), static_cast<const int32_t*>(level),
        static_cast<uint32_t*>(planes), n, n_words, n_planes);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) *failed_step = 4;
  return static_cast<int>(err);
}
