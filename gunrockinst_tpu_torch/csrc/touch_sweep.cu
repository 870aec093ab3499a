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
// What bounds it on the card: the latency of dependent loads, not bytes.
// A sweep must read the CSC offsets and, per candidate vertex, its
// in-edge ids up to the first frontier hit (all of them when there is
// none) plus the frontier words they point to: at rmat-s20 from the
// level-2 frontier ~20 MB, ~6 us at 3.35 TB/s.  Each id is a load, and
// its frontier bit a second load that depends on it; one list with no
// hit (there, the source's own 63,727 in-edges) is walked to its end.
//
// Design: one cooperative launch of a persistent grid (one 1024-thread
// block per SM when the frontier fills shared memory), in two phases.
//   * The sweep: block b owns words b, b + B, ... (B blocks), kRound a
//     round.  Thread 0 first copies the first `staged` frontier words
//     into shared memory with bulk asynchronous copies (cp.async.bulk on
//     one mbarrier); a warp waits for them only before its first
//     frontier test.  Words at or past `staged` are read from L2 (above
//     ~1.5 M vertices with the card's full budget, or whenever the
//     caller caps it).  The wrapper stages nothing for the fused form,
//     which reads the frontier words of unvisited vertices only: there
//     the copy cost more than it saved (PERF.md section 6).  Each round,
//     the warps sort the round's words (visited words and offsets loaded
//     together) into a list of the candidates with an in-edge, then take
//     32 of them at a time, one a lane.  The 32 lists are walked together
//     (warp_walk.cuh's walk, which the level step shares) in steps of
//     kStep ids: each open list (ids left, no hit yet) gets
//     an equal quota of the step (kStep / open lists, at least 8), the
//     quotas are laid end to end, and lane l reads positions l, l + 32,
//     ... of that range, all kUnroll loads in flight before any bit is
//     tested.  So the first step probes the first few ids of every
//     vertex at once, and later steps give the lists still open larger
//     quotas.  A position finds its list through the window's head bits
//     (one warp OR-reduction) and a per-warp table in shared memory.  A
//     hit closes its vertex and sets its bit in the round's words in
//     shared memory, which the block stores once the round is done: one
//     plain store a word.
//   * The tail walk, after a grid barrier: a list longer than `head` ids
//     with no hit in its first `head` was handed on in pieces of at most
//     `chunk` ids (vertex, begin, end); the grid's warps share the pieces
//     (all of them on one piece when there is one), step through it
//     kStep ids at a time, stop once the vertex's bit is set, and set it
//     with an integer atomicOr.  The fused form covers every list with
//     `head` and has no tail walk: a plain launch, no barrier.
// OR is exact, so neither the walk order nor the warp that takes a
// vertex can show in the result.
//
// Known slowness, left for later work: a warp's steps wait on each other
// (a step's quotas depend on the hits of the one before), so a sweep is
// a chain of dependent round trips per warp; the grid-stepped routes
// sweep the unrelabeled CSC, whose hubs lie scattered over the words;
// the grid barrier before the tail walk is paid even when no list is
// open; on the levels where few vertices are unvisited the fused form's
// persistent rounds (loads, two block barriers, the store of the round's
// words) cost more than one warp a word did.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kCopyChunk = 32768;   // bytes per bulk copy instruction

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every thread of the block calls this once, first: thread 0 sets up
// `bar` and starts copying `bytes` (a multiple of 16) from 16-byte
// aligned global `src` to shared `dst`; the block then syncs.  Nothing is
// copied (and nobody may wait) when `bytes` is 0.
__device__ __forceinline__ void stage_begin(uint64_t* bar, void* dst,
                                            const void* src, uint32_t bytes) {
  if (threadIdx.x == 0) {
    const uint32_t mb = smem_addr(bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mb)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (bytes != 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(mb), "r"(bytes)
                   : "memory");
      for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
        const uint32_t len = bytes - off < kCopyChunk ? bytes - off
                                                      : kCopyChunk;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
            "l"(reinterpret_cast<uint64_t>(src) + off), "r"(len), "r"(mb)
            : "memory");
      }
    }
  }
  __syncthreads();
}

// Waits until the copies of stage_begin have landed (phase 0 of `bar`).
__device__ __forceinline__ void stage_wait(uint64_t* bar) {
  const uint32_t mb = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mb)
        : "memory");
  } while (!done);
}

// The dynamic shared memory one block of `kernel` may ask for on the
// current card: the opt-in limit less the kernel's static shared memory.
template <typename K>
cudaError_t dynamic_smem_limit(K* kernel, int* bytes) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    *bytes = optin - static_cast<int>(attr.sharedSizeBytes);
  return err;
}

// Grid of a persistent kernel: as many blocks of `threads` as fit on all
// SMs at once with `dyn` bytes of dynamic shared memory each, and no more
// than `useful`.  Opts the kernel in to `dyn` bytes first (the opt-in
// only ever grows, so a smaller budget launched later still fits); an
// opt-in the card refuses, or a grid of no block, is an error.  The
// answers are kept per kernel, device and size, so a sweep loop asks the
// runtime once.
template <typename K>
cudaError_t persistent_grid(K* kernel, int threads, int dyn, int useful,
                            int* blocks) {
  struct Entry {
    const void* fn;
    int dev, threads, dyn, value;   // threads < 0: the opt-in, in dyn
  };
  static Entry cache[32];
  static int filled = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int opted = -1, full = 0;
  for (int i = 0; i < filled; ++i) {
    Entry& e = cache[i];
    if (e.fn != fn || e.dev != dev) continue;
    if (e.threads < 0) opted = i;
    else if (e.threads == threads && e.dyn == dyn) full = e.value;
  }
  if (full != 0 && opted >= 0 && cache[opted].dyn >= dyn) {
    *blocks = full < useful ? full : useful;
    return cudaSuccess;
  }
  if (opted < 0 || cache[opted].dyn < dyn) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return err;
    if (opted < 0 && filled < 32) opted = filled++;
    if (opted >= 0) cache[opted] = Entry{fn, dev, -1, dyn, 0};
  }
  if (full == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, dyn);
    if (err != cudaSuccess) return err;
    if (per_sm <= 0) return cudaErrorInvalidConfiguration;
    full = per_sm * sms;
    if (filled < 32) cache[filled++] = Entry{fn, dev, threads, dyn, full};
  }
  *blocks = full < useful ? full : useful;
  return cudaSuccess;
}

constexpr int kWarps = 32;               // warps per block of the sweep
constexpr int kThreads = kWarps * 32;
constexpr int kRound = 256;              // words a block takes per round
constexpr int kRoundWords = kRound / kWarps;   // per warp, to sort
constexpr int kUnroll = 8;               // windows of 32 ids per step
constexpr int kStep = 32 * kUnroll;      // ids per warp step
constexpr unsigned kFull = 0xffffffffu;

// The sweep.  Block b owns words b, b + B, b + 2B, ... (B blocks), kRound
// of them a round.  First each warp sorts kRoundWords of the round's
// words, their visited words and offsets loaded together: the candidates
// with an in-edge go on the round's vertex list in shared memory.  Then
// the warps take 32 listed vertices at a time, one a lane, and walk
// their in-lists together (the quota walk below), the next 32 vertices'
// offsets in flight meanwhile; a hit sets the vertex's bit in the round's
// words in shared memory, which the block stores when the list is done.
// So lanes are not spent on visited or isolated vertices, a warp with
// heavy vertices takes fewer of them, and hub words far apart in id land
// in different blocks.  A list longer than `head` ids with no hit in its
// first `head` goes on the tail list for the tail walk, its remaining
// ids in pieces of at most `chunk` (vertex, begin, end), which the grid
// runs after a grid-wide barrier: the warps share the pieces,
// max(1, warps / pieces) warps to a piece, which read its ids kStep at a
// time in interleaved steps, stop when the vertex's bit is set (by them
// or another warp) and set it with an atomicOr.  So one list of tens of
// thousands of ids is walked by many warps even when every warp has a
// list of its own.  The tail count of this sweep is counters[parity];
// block 0 zeroes the other one, the next sweep's.  With no room for
// tail pieces (`room` 0: the fused form, whose `head` covers every
// list) there is no tail walk and no barrier, and the launch is a plain
// one.
__global__ void __launch_bounds__(kThreads, 1)
touch_sweep_kernel(const int32_t* __restrict__ offsets,   // (n+1,) CSC offsets
                   const int32_t* __restrict__ in_src,    // (m,) in-neighbours
                   const uint32_t* __restrict__ fw,       // (n_words,) frontier
                   const uint32_t* __restrict__ vw,       // (n_words,) or null
                   uint32_t* out,                         // (n_words,) out
                   int32_t* tails,                        // (3 * room,) out
                   int32_t* counters,                     // (2,)
                   int n, int n_words, int staged, int head, int chunk,
                   int room, int parity) {
  extern __shared__ __align__(16) uint32_t s_fw[];        // (staged,)
  __shared__ __align__(8) uint64_t bar;
  __shared__ int2 open_lists[kWarps][32];  // (lane, first edge - position)
  __shared__ int listed[kRound * 32];   // the round's vertices to walk
  __shared__ uint32_t touched[kRound];  // the round's output words
  __shared__ int n_listed, taken;
  stage_begin(&bar, s_fw, fw, 4u * staged);
  bool ready = staged == 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned upto = kFull >> (31 - lane);    // lanes 0..lane
  const unsigned below = upto >> 1;              // lanes 0..lane-1
  int2* table = open_lists[warp];
  const int stride = gridDim.x;
  int32_t* n_tails = counters + parity;
  if (blockIdx.x == 0 && threadIdx.x == 0) counters[1 - parity] = 0;

  for (int r0 = 0; blockIdx.x + stride * r0 < n_words; r0 += kRound) {
    __syncthreads();                    // the last round is stored
    if (threadIdx.x == 0) {
      n_listed = 0;
      taken = 0;
    }
    for (int j = threadIdx.x; j < kRound; j += kThreads) touched[j] = 0;
    __syncthreads();
    uint32_t cands[kRoundWords];
    int2 lists[kRoundWords];
#pragma unroll
    for (int i = 0; i < kRoundWords; ++i) {       // all loads in flight
      const int word = blockIdx.x + stride * (r0 + warp + kWarps * i);
      const int base = word * 32;
      cands[i] = 0;
      lists[i] = make_int2(0, 0);
      if (word < n_words && base < n) {
        cands[i] = n - base >= 32 ? kFull : (1u << (n - base)) - 1u;
        if (vw != nullptr) cands[i] &= ~__ldg(vw + word);
        if ((cands[i] >> lane) & 1u) {
          lists[i] = make_int2(__ldg(offsets + base + lane),
                               __ldg(offsets + base + lane + 1));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRoundWords; ++i) {
      const bool walk = ((cands[i] >> lane) & 1u) && lists[i].y > lists[i].x;
      const uint32_t mask = __ballot_sync(kFull, walk);
      int at = 0;
      if (lane == 0 && mask != 0) at = atomicAdd(&n_listed, __popc(mask));
      at = __shfl_sync(kFull, at, 0);
      const int word = blockIdx.x + stride * (r0 + warp + kWarps * i);
      if (walk) listed[at + __popc(mask & below)] = word * 32 + lane;
    }
    __syncthreads();
    const int count = n_listed;
    int at = __shfl_sync(kFull, lane == 0 ? atomicAdd(&taken, 32) : 0, 0);
    int v = at + lane < count ? listed[at + lane] : -1;
    int2 list = v >= 0 ? make_int2(__ldg(offsets + v), __ldg(offsets + v + 1))
                       : make_int2(0, 0);
    while (at < count) {                // uniform across the warp
      const int at_next =
          __shfl_sync(kFull, lane == 0 ? atomicAdd(&taken, 32) : 0, 0);
      const int v_next = at_next + lane < count ? listed[at_next + lane] : -1;
      const int2 list_next = v_next >= 0           // in flight during this walk
          ? make_int2(__ldg(offsets + v_next), __ldg(offsets + v_next + 1))
          : make_int2(0, 0);
      const int end = list.y;
      const int lim = end - list.x > head ? list.x + head : end;
      const uint32_t found = warp_walk::walk_lists<kUnroll>(
          in_src, list.x, lim, table,
          [&] {
            if (!ready) {               // uniform: the frontier copy landed
              stage_wait(&bar);
              ready = true;
            }
          },
          [&](const uint32_t (&ids)[kUnroll], const int (&owner)[kUnroll]) {
            uint32_t hit = 0;
#pragma unroll
            for (int k = 0; k < kUnroll; ++k) {
              if (owner[k] >= 0) {
                const uint32_t w = ids[k] >> 5;
                const uint32_t x = static_cast<int>(w) < staged
                                       ? s_fw[w] : __ldg(fw + w);
                if ((x >> (ids[k] & 31u)) & 1u) hit |= 1u << owner[k];
              }
            }
            return hit;
          });
      if ((found >> lane) & 1u) {
        atomicOr(touched + ((v >> 5) - blockIdx.x) / stride - r0,
                 1u << (v & 31));
      } else if (lim < end) {           // an open long list, in pieces
        const int pieces = (end - lim - 1) / chunk + 1;
        const int t = atomicAdd(n_tails, pieces);
        for (int j = 0; j < pieces && t + j < room; ++j) {   // always, as
          const int b = lim + j * chunk;  // n_tails starts at 0
          tails[3 * (t + j)] = v;
          tails[3 * (t + j) + 1] = b;
          tails[3 * (t + j) + 2] = end - b > chunk ? b + chunk : end;
        }
      }
      at = at_next;
      v = v_next;
      list = list_next;
    }
    __syncthreads();                    // every vertex of the round is done
    for (int j = threadIdx.x; j < kRound; j += kThreads) {
      const int word = blockIdx.x + stride * (r0 + j);
      if (word < n_words) out[word] = touched[j];
    }
  }
  if (!ready) stage_wait(&bar);     // the tail walk reads the copy too
  if (room == 0) return;            // no tail walk: a plain launch
  cg::this_grid().sync();

  const int count = min(__ldcg(n_tails), room);
  const int n_warps = gridDim.x * kWarps;
  const int g = blockIdx.x * kWarps + warp;
  if (count > 0) {
    const int per = n_warps / count > 1 ? n_warps / count : 1;
    const int groups = n_warps / per;
    for (int i = g / per; g < groups * per && i < count; i += groups) {
      const int v = __ldcg(tails + 3 * i);
      const int end = __ldcg(tails + 3 * i + 2);
      const uint32_t bit = 1u << (v & 31);
      uint32_t* word = out + (v >> 5);
      for (int b = __ldcg(tails + 3 * i + 1) + (g % per) * kStep; b < end;
           b += per * kStep) {
        if (__ldcg(word) & bit) break;  // uniform: found already
        uint32_t ids[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int e = b + 32 * k + lane;
          ids[k] = e < end ? static_cast<uint32_t>(__ldg(in_src + e)) : 0u;
        }
        bool any = false;
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (b + 32 * k + lane < end) {
            const uint32_t w = ids[k] >> 5;
            const uint32_t x = static_cast<int>(w) < staged ? s_fw[w]
                                                            : __ldg(fw + w);
            any |= (x >> (ids[k] & 31u)) & 1u;
          }
        }
        if (__any_sync(kFull, any)) {
          if (lane == 0) atomicOr(word, bit);
          break;
        }
      }
    }
  }
}

}  // namespace

// The dynamic shared memory (bytes) a sweep block may stage on the
// current card; the wrapper sizes `staged` from it.  Returns the
// cudaError_t of the query.
extern "C" int gt_touch_sweep_smem_limit(int* bytes) {
  return static_cast<int>(dynamic_smem_limit(touch_sweep_kernel, bytes));
}

// Launches one sweep on `stream`; `vw` may be null (plain sweep).  The
// first `staged` frontier words (a multiple of 4, at most n_words; fw
// 16-byte aligned when staged > 0) are copied to shared memory.
// In-lists longer than `head` (at least 1) are walked past their first
// `head` ids by the tail walk, in pieces of at most `chunk` (at least 1)
// ids, through `tails`, room for (vertex, begin, end) of `room` pieces
// (every piece of every such list), and `counters`, two ints, of which
// counters[parity] is 0 before the sweep; the sweep zeroes the other
// one, so the caller alternates `parity` from one sweep to the next.
// With room > 0 the launch is cooperative (the word sweep, a grid
// barrier, the tail walk); with room 0 no list may outgrow `head`, and
// it is a plain launch.  Returns the cudaError_t of the launch (0 on
// success); the caller raises on any other value.
extern "C" int gt_touch_sweep(const void* offsets, const void* in_src,
                              const void* fw, const void* vw, void* out,
                              void* tails, void* counters, int n, int n_words,
                              int staged, int head, int chunk, int room,
                              int parity, void* stream) {
  if (staged < 0 || staged > n_words || staged % 4 != 0 || head < 1 ||
      chunk < 1 || room < 0 ||
      (parity != 0 && parity != 1) ||
      (staged > 0 && (reinterpret_cast<uintptr_t>(fw) & 15u) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_words == 0) return static_cast<int>(cudaSuccess);
  int blocks = 0;
  cudaError_t err = persistent_grid(
      touch_sweep_kernel, kThreads, 4 * staged,
      (n_words + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (room == 0) {
    touch_sweep_kernel<<<blocks, kThreads, 4 * staged,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(in_src),
        static_cast<const uint32_t*>(fw), static_cast<const uint32_t*>(vw),
        static_cast<uint32_t*>(out), static_cast<int32_t*>(tails),
        static_cast<int32_t*>(counters), n, n_words, staged, head, chunk,
        room, parity);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&offsets, &in_src, &fw, &vw, &out, &tails, &counters,
                  &n, &n_words, &staged, &head, &chunk, &room, &parity};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(touch_sweep_kernel),
                                    dim3(blocks), dim3(kThreads), args,
                                    4 * staged,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
