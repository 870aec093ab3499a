// One BFS level on word maps, for NVIDIA Hopper (sm_90a).
//
// Replaces: gunrockinst_tpu/ops/pallas_mega.py:422 `_make_step_kernel`
// (wrapper `MegaStepper`, pallas_mega.py:834).  Same function at the
// word-map interface (bit b of word w is vertex 32w+b):
//
//   touched[v] = OR over in-edges u->v of frontier bit u
//   nfw        = touched & reach & ~vw
//   vw'        = vw | nfw                     (in place)
//   planes'[b] = planes[b] | nfw  for each bit b set in d   (in place)
//   n_new      = popcount(nfw)                (device counter)
//
// `reach` is a superset of what the search can still claim (the
// source's connected component, or every vertex with an in-edge), so
// `& reach` changes nothing for inputs a search produces; it is the
// destination-side skip of the reference, taken per 32-vertex word
// instead of per 32K-vertex region.
//
// What bounds it on the card: bytes.  A full sweep at rmat-s20 reads
// ~31.4 M in-edge ids (4 B) plus the CSC offsets, ~130 MB, ~39 us at
// 3.35 TB/s; the word maps (135 KB each) stay in L2.  Two things cut
// the bytes a level must read, and the design takes both:
//   * a word whose reachable vertices are all visited is skipped
//     without reading its edges (the destination skip above);
//   * a vertex stops scanning its in-edges at the first frontier hit
//     (pull with early exit); after degree relabeling the hubs have the
//     lowest ids and sit first in every in-edge list.
// Design: one warp per destination word.  Each lane owns one candidate
// vertex and scans its in-edges itself when the in-degree is at most
// kLaneDegree; larger in-lists are scanned by the whole warp together,
// one vertex at a time, 32 coalesced ids per step and kUnroll steps in
// flight, with a warp vote for the early exit.  Each word is owned by
// one warp, so vw and the planes are updated with plain stores; the
// only atomics are one integer add per block for n_new.  There is no
// grid-wide barrier, no cooperative launch and no float atomic: the
// level loop runs on the host.
//
// Known slowness, left for later work: one lane walks a whole in-list
// of up to kLaneDegree ids while the other lanes of its warp may be
// done, and a warp with several hubs scans them one after another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLaneDegree = 32;   // larger in-lists are scanned by the warp
constexpr int kUnroll = 4;        // warp steps of 32 ids in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool frontier_bit(const uint32_t* __restrict__ fw,
                                             uint32_t u) {
  return (__ldg(fw + (u >> 5)) >> (u & 31u)) & 1u;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
mega_step_kernel(const int32_t* __restrict__ offsets,   // (n+1,) CSC offsets
                 const int32_t* __restrict__ in_src,    // (m,) in-neighbours
                 const uint32_t* __restrict__ fw,       // (n_words,) frontier
                 uint32_t* __restrict__ vw,             // (n_words,) visited
                 const uint32_t* __restrict__ reach,    // (n_words,)
                 uint32_t* __restrict__ planes,         // (n_planes*n_words,)
                 uint32_t* __restrict__ nfw,            // (n_words,) out
                 int32_t* __restrict__ n_new,           // (1,) out, zeroed
                 int n, int n_words, int n_planes, int d) {
  __shared__ int block_new;
  if (threadIdx.x == 0) block_new = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (word < n_words) {                 // uniform across the warp
    const uint32_t visited = vw[word];
    const uint32_t cand = reach[word] & ~visited;
    uint32_t found = 0;
    if (cand != 0) {                    // uniform across the warp
      const int v = word * 32 + lane;
      const bool mine = ((cand >> lane) & 1u) && v < n;
      int beg = 0, end = 0;
      if (mine) {
        beg = offsets[v];
        end = offsets[v + 1];
      }
      const bool by_lane = mine && end - beg <= kLaneDegree;
      bool hit = false;
      if (by_lane) {
        for (int e = beg; e < end; ++e) {
          if (frontier_bit(fw, static_cast<uint32_t>(in_src[e]))) {
            hit = true;
            break;
          }
        }
      }
      found = __ballot_sync(kFull, hit);
      uint32_t hubs = __ballot_sync(kFull, mine && !by_lane);
      while (hubs != 0) {               // uniform: same mask in every lane
        const int h = __ffs(hubs) - 1;
        hubs &= hubs - 1;
        const int hb = __shfl_sync(kFull, beg, h);
        const int he = __shfl_sync(kFull, end, h);
        for (int base = hb; base < he; base += 32 * kUnroll) {
          bool any = false;
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int e = base + k * 32 + lane;
            if (e < he) any |= frontier_bit(fw, static_cast<uint32_t>(in_src[e]));
          }
          if (__any_sync(kFull, any)) {
            found |= 1u << h;
            break;
          }
        }
      }
    }
    const uint32_t fresh = found & cand;
    if (lane == 0) {
      nfw[word] = fresh;
      if (fresh != 0) {
        vw[word] = visited | fresh;
        for (int b = 0; b < n_planes; ++b) {
          if ((d >> b) & 1) planes[static_cast<size_t>(b) * n_words + word] |= fresh;
        }
        atomicAdd(&block_new, __popc(fresh));
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_new != 0) atomicAdd(n_new, block_new);
}

}  // namespace

// Launches one level on `stream`.  Zeroes n_new first.  Returns the
// cudaError_t of the launch (0 on success); the caller raises on any
// other value.
extern "C" int gt_mega_step(const void* offsets, const void* in_src,
                            const void* fw, void* vw, const void* reach,
                            void* planes, void* nfw, void* n_new,
                            int n, int n_words, int n_planes, int d,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(n_new, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    mega_step_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(in_src),
        static_cast<const uint32_t*>(fw), static_cast<uint32_t*>(vw),
        static_cast<const uint32_t*>(reach), static_cast<uint32_t*>(planes),
        static_cast<uint32_t*>(nfw), static_cast<int32_t*>(n_new),
        n, n_words, n_planes, d);
  }
  return static_cast<int>(cudaGetLastError());
}
