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
// Design.  The level loop runs inside one cooperative launch, with two
// grid-wide barriers (cooperative_groups::this_grid().sync()) a level.
// The grid is at most the co-resident block count (occupancy times the
// SM count), so the launch either runs with every block resident or is
// refused (cudaErrorCooperativeLaunchTooLarge); there is no hand-made
// spin barrier.  The loop is bounded by max_depth = n + 1, so the kernel
// ends on any input.  Work per level is proportional to the frontier,
// not to n: the frontier is kept as a list of (word, bits) entries and
// the words that the level touches as a second list.
//   1. Push: one warp per frontier entry, one lane per set bit.  A lane
//      reads its vertex's out-edges (warp-wide for out-degrees above
//      kLaneDegree) and, for each destination not yet visited, ORs its
//      bit into the next-word map `nx`; the one thread whose atomicOr
//      finds the word empty appends the word to the touched list.
//   2. Barrier.
//   3. Word: one thread per touched word takes and clears `nx[w]`,
//      computes nfw = nx & ~vw, updates vw and the plane words of the
//      set bits of depth + 1, and appends (w, nfw) to the next frontier
//      list.  Each touched word appears once in the list, so vw and the
//      planes are updated with plain stores by their one owner.
//   4. Barrier; every thread reads the next frontier's length, the same
//      value in all of them, and leaves the loop when it is 0.
// The list lengths are counters double-buffered by level parity: each
// is reset in a phase in which no thread reads or bumps it, so no block
// can leave the loop while another still waits at a barrier.  Data that
// other blocks write is read through L2 (__ldcg), never from a stale
// L1 line.  Only integer atomics (OR, add, exchange) are used, so the
// outputs are the same on every run.
//
// What bounds it on the card: the latency of a level, not bytes.  A
// search moves each out-edge id and offset once (~17 MB at grid-1024^2,
// ~5 us at 3.35 TB/s), but a level is a chain of dependent L2 and HBM
// accesses plus two grid barriers, over thousands of levels.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kBlocksPerSm = 1;   // a grid barrier over fewer blocks costs less
constexpr int kLaneDegree = 32;   // larger out-lists are read by the warp
constexpr unsigned kFull = 0xffffffffu;

// counts[0..1]: frontier list length by level parity;
// counts[2..3]: touched list length by level parity.
constexpr int kFront = 0;
constexpr int kTouched = 2;

__device__ __forceinline__ void visit(int v, uint32_t* __restrict__ vw,
                                      uint32_t* __restrict__ nx,
                                      int32_t* __restrict__ touched,
                                      int32_t* __restrict__ touched_n) {
  const int w = v >> 5;
  const uint32_t bit = 1u << (v & 31);
  if ((__ldcg(vw + w) | __ldcg(nx + w)) & bit) return;
  if (atomicOr(nx + w, bit) == 0u) touched[atomicAdd(touched_n, 1)] = w;
}

__global__ void __launch_bounds__(kThreads)
chain_bfs_kernel(const int32_t* __restrict__ out_off,   // (n+1,) CSR offsets
                 const int32_t* __restrict__ out_dst,   // (m,) out-neighbours
                 uint32_t* __restrict__ planes,         // (n_planes*n_words,)
                 uint32_t* __restrict__ vw,             // (n_words,) visited
                 uint32_t* __restrict__ nx,             // (n_words,) scratch
                 int32_t* __restrict__ front_w,         // (n_words,) scratch
                 uint32_t* __restrict__ front_bits,     // (n_words,) scratch
                 int32_t* __restrict__ touched,         // (n_words,) scratch
                 int32_t* __restrict__ counts,          // (4,) scratch
                 int32_t* __restrict__ depth_out,       // (1,) out
                 int src, int n_words, int n_planes, int max_depth) {
  cg::grid_group grid = cg::this_grid();
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = tid >> 5;
  const int n_warps = n_threads >> 5;

  // init: frontier = visited = {src}; planes, nx and the counts zero
  const int src_w = src >> 5;
  const uint32_t src_bit = 1u << (src & 31);
  for (long long i = tid; i < static_cast<long long>(n_planes) * n_words;
       i += n_threads)
    planes[i] = 0u;
  for (int i = tid; i < n_words; i += n_threads) {
    vw[i] = i == src_w ? src_bit : 0u;
    nx[i] = 0u;
  }
  if (tid == 0) {
    front_w[0] = src_w;
    front_bits[0] = src_bit;
    counts[kFront] = 1;
    counts[kFront + 1] = 0;
    counts[kTouched] = 0;
    counts[kTouched + 1] = 0;
  }
  grid.sync();

  int depth = 0;
  while (depth < max_depth) {
    const int p = depth & 1;
    const int d = depth + 1;

    // 1. push from the frontier list
    const int nf = __ldcg(counts + kFront + p);
    for (int f = warp; f < nf; f += n_warps) {   // uniform across the warp
      const int w = __ldcg(front_w + f);
      const uint32_t bits = __ldcg(front_bits + f);
      const bool mine = (bits >> lane) & 1u;
      int beg = 0, end = 0;
      if (mine) {
        const int u = w * 32 + lane;
        beg = __ldg(out_off + u);
        end = __ldg(out_off + u + 1);
      }
      const bool by_lane = mine && end - beg <= kLaneDegree;
      if (by_lane) {
        for (int e = beg; e < end; ++e)
          visit(__ldg(out_dst + e), vw, nx, touched, counts + kTouched + p);
      }
      uint32_t hubs = __ballot_sync(kFull, mine && !by_lane);
      while (hubs != 0) {               // uniform: same mask in every lane
        const int h = __ffs(hubs) - 1;
        hubs &= hubs - 1;
        const int hb = __shfl_sync(kFull, beg, h);
        const int he = __shfl_sync(kFull, end, h);
        for (int e = hb + lane; e < he; e += 32)
          visit(__ldg(out_dst + e), vw, nx, touched, counts + kTouched + p);
      }
    }
    grid.sync();

    // 3. claim the touched words; build the next frontier list
    if (tid == 0) {
      counts[kFront + p] = 0;           // read by all before the barrier
      counts[kTouched + (p ^ 1)] = 0;   // read last level, bumped next
    }
    const int nt = __ldcg(counts + kTouched + p);
    for (int i = tid; i < nt; i += n_threads) {
      const int w = __ldcg(touched + i);
      const uint32_t seen = __ldcg(vw + w);
      const uint32_t fresh = atomicExch(nx + w, 0u) & ~seen;
      if (fresh != 0u) {
        vw[w] = seen | fresh;
        for (int b = 0; b < n_planes; ++b) {
          if ((d >> b) & 1) {
            uint32_t* pw = planes + static_cast<size_t>(b) * n_words + w;
            *pw = __ldcg(pw) | fresh;
          }
        }
        const int slot = atomicAdd(counts + kFront + (p ^ 1), 1);
        front_w[slot] = w;
        front_bits[slot] = fresh;
      }
    }
    grid.sync();

    depth = d;
    if (__ldcg(counts + kFront + (p ^ 1)) == 0) break;   // same in all
  }
  if (tid == 0) depth_out[0] = depth;
}

}  // namespace

// Runs one whole search from `src` on `stream`, with kBlocksPerSm blocks
// per SM (fewer if the occupancy limit is lower); the grid used is
// written to *grid_blocks.  Returns the cudaError_t of the checks and the launch
// (0 on success); the caller raises on any other value.
extern "C" int gt_chain_bfs(const void* out_off, const void* out_dst,
                            void* planes, void* vw, void* nx, void* front_w,
                            void* front_bits, void* touched, void* counts,
                            void* depth_out, int src, int n_words,
                            int n_planes, int max_depth, void* stream,
                            int* grid_blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, occ = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, chain_bfs_kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (occ < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int blocks = (occ < kBlocksPerSm ? occ : kBlocksPerSm) * sms;
  *grid_blocks = blocks;
  void* args[] = {&out_off, &out_dst, &planes, &vw, &nx, &front_w,
                  &front_bits, &touched, &counts, &depth_out, &src,
                  &n_words, &n_planes, &max_depth};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(chain_bfs_kernel),
                                    dim3(blocks), dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
