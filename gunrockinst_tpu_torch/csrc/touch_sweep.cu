// Touched sweep on word maps, for NVIDIA Hopper (sm_90a).
//
// Replaces three TPU kernels that compute one function and differ only
// in their TPU tile placement:
//   gunrockinst_tpu/ops/pallas_advance_v3.py:372 `_packed_kernel_v3`
//     (with pallas_advance_v2.py:291 `_hub_kernel`; `PullSweeperV3` :391)
//   gunrockinst_tpu/ops/pallas_advance_v2.py:291 `_hub_kernel` and :317
//     `_packed_kernel` (`PullSweeperV2` :351)
//   gunrockinst_tpu/ops/pallas_advance.py:144 `_pull_kernel` and :191
//     `_pull_kernel_fused` (`PullSweeper` :246)
// At the word-map interface (bit b of word w is vertex 32w+b):
//
//   touched[v] = OR over in-edges u->v of frontier bit u
//   out        = touched               (plain)
//   out        = touched & ~vw         (fused: vw != nullptr)
//
// The fused form skips a word whose vertices are all visited without
// reading its edges, as `_pull_kernel_fused` skips a destination window
// with no unvisited vertex.
//
// What bounds it on the card: bytes.  A sweep reads the CSC offsets
// and, per candidate vertex, its in-edge ids up to the first frontier
// hit (all of them when there is none) plus the frontier words they
// point to; the word maps stay in L2.  At rmat-s20 a full read of the
// in-edge ids is ~126 MB, ~38 us at 3.35 TB/s.
// Design: `mega_step`'s pull without the reach mask, the planes and the
// count.  One warp per destination word.  Each lane owns one candidate
// vertex and scans its in-edges itself when the in-degree is at most
// kLaneDegree, stopping at the first frontier hit; larger in-lists are
// scanned by the whole warp together, 32 coalesced ids per step and
// kUnroll steps in flight, with a warp vote for the early exit.  Each
// output word is written by one lane with a plain store: no atomics.
//
// Known slowness, left for later work (as in mega_step): one lane walks
// a whole in-list of up to kLaneDegree ids while the others may be
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
touch_sweep_kernel(const int32_t* __restrict__ offsets,   // (n+1,) CSC offsets
                   const int32_t* __restrict__ in_src,    // (m,) in-neighbours
                   const uint32_t* __restrict__ fw,       // (n_words,) frontier
                   const uint32_t* __restrict__ vw,       // (n_words,) or null
                   uint32_t* __restrict__ out,            // (n_words,) out
                   int n, int n_words) {
  const int lane = threadIdx.x & 31;
  const int word = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (word >= n_words) return;          // uniform across the warp
  const int base = word * 32;
  uint32_t cand = 0;                    // the word's vertices below n
  if (base < n) cand = n - base >= 32 ? kFull : (1u << (n - base)) - 1u;
  if (vw != nullptr) cand &= ~__ldg(vw + word);
  uint32_t found = 0;
  if (cand != 0) {                      // uniform across the warp
    const int v = base + lane;
    const bool mine = (cand >> lane) & 1u;
    int beg = 0, end = 0;
    if (mine) {
      beg = __ldg(offsets + v);
      end = __ldg(offsets + v + 1);
    }
    const bool by_lane = mine && end - beg <= kLaneDegree;
    bool hit = false;
    if (by_lane) {
      for (int e = beg; e < end; ++e) {
        if (frontier_bit(fw, static_cast<uint32_t>(__ldg(in_src + e)))) {
          hit = true;
          break;
        }
      }
    }
    found = __ballot_sync(kFull, hit);
    uint32_t hubs = __ballot_sync(kFull, mine && !by_lane);
    while (hubs != 0) {                 // uniform: same mask in every lane
      const int h = __ffs(hubs) - 1;
      hubs &= hubs - 1;
      const int hb = __shfl_sync(kFull, beg, h);
      const int he = __shfl_sync(kFull, end, h);
      for (int b = hb; b < he; b += 32 * kUnroll) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int e = b + k * 32 + lane;
          if (e < he)
            any |= frontier_bit(fw, static_cast<uint32_t>(__ldg(in_src + e)));
        }
        if (__any_sync(kFull, any)) {
          found |= 1u << h;
          break;
        }
      }
    }
  }
  if (lane == 0) out[word] = found & cand;
}

}  // namespace

// Launches one sweep on `stream`; `vw` may be null (plain sweep).
// Returns the cudaError_t of the launch (0 on success); the caller
// raises on any other value.
extern "C" int gt_touch_sweep(const void* offsets, const void* in_src,
                              const void* fw, const void* vw, void* out,
                              int n, int n_words, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0) {
    touch_sweep_kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(in_src),
        static_cast<const uint32_t*>(fw), static_cast<const uint32_t*>(vw),
        static_cast<uint32_t*>(out), n, n_words);
  }
  return static_cast<int>(cudaGetLastError());
}
