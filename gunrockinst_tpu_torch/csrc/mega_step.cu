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
//   n_new      = popcount(nfw), and beside it the order the level took
//
// `reach` is a superset of what the search can still claim (the
// source's connected component, or every vertex with an in-edge), so
// `& reach` changes nothing for inputs a search produces; it is the
// destination-side skip of the reference, taken per 32-vertex word.
//
// What bounds it on the card: bytes on the wide levels, latency on the
// thin ones.  A full pull at rmat-s20 reads ~31.4 M in-edge ids plus the
// CSC offsets, ~130 MB, ~39 us at 3.35 TB/s; a push from a frontier
// reads only its out-lists.  The design takes, each level, the cheaper
// of the two orders of the same function, as the reference's
// `_PlanSet.level` picks frontier-ordered or destination-ordered work
// (gunrockinst_tpu/primitives/bfs_pallas.py:185-223):
//   * push: the frontier's out-edges; each destination v in reach & ~vw
//     takes old = atomicOr(&vw[w], bit), and only the thread that newly
//     set the bit ORs it into nfw, into the planes of d's set bits and
//     into the count.  Every output is an OR or a count, so the result
//     is the same on every run and equals the pull's.
//   * pull: each candidate (reach & ~vw) scans its in-edges up to the
//     first frontier hit; after degree relabeling the hubs have the
//     lowest ids and sit first in every in-list.
// The choice is made on the card, with no host round trip: every launch
// leaves, in a stats slot, the count of candidates after it, the
// out-edge total of the vertices it claimed (the next frontier) and the
// ids of those with more than kHub out-edges (hubs); the next launch
// reads them and every block takes the same branch (push when the
// frontier's out-edges are fewer than the candidates, `push_rule`).
// When the wrapper cannot vouch that the slot describes its input (the
// first level of a search, or any input it did not produce), a small
// stats kernel fills a slot first.
// A slot that does not describe fw (fw edited after the launch that
// filled it) costs time, never a bit.  The direction is only a choice
// between two orders of one function.  The hub list is made safe by
// numbering: each launch has its own number `seq`, stored in the slots
// it fills and in `hub_tag[u]` for every hub u it lists.  The push walks
// a listed hub only if fw holds it, and a frontier vertex leaves its own
// out-list to the hub walk only if hub_tag says the slot's launch listed
// it; every other frontier vertex is walked where it is found.
//
// Design of one launch (a plain launch, no grid barrier; the grid is
// sized to the words, a round of 32 to kRound words a block, capped at
// the co-resident blocks):
//   * Push.  First the out-lists of the listed hubs that fw holds, cut
//     into pieces of kStep ids that all the grid's warps share (the
//     level-1 source of rmat-s20 has 63,727 out-ids: no single warp walks
//     it).  Then each warp loads
//     32 frontier words at once (words far apart, so that a frontier of
//     consecutive words spreads over the warps), ballots the non-empty
//     ones and takes them one after another, one lane a set bit; the
//     lanes' out-lists are walked together by the warp-cooperative walk
//     of warp_walk.cuh (quotas, coalesced, kUnroll windows in flight), and
//     each window's destinations are claimed with their reach and visited
//     loads, then their atomics, all in flight.  nfw comes zeroed: the
//     launch before zeroed it (`zero_next`), and a push only ORs into it.
//   * Pull.  A block takes a round of words at a time: a warp for each
//     32 loads them from reach and vw in one coalesced load and lists the
//     round's candidates in shared memory; then all the block's warps
//     take 32 listed vertices at a time and walk their in-lists together
//     with the same warp-cooperative walk, stopping each at its first
//     frontier hit; a hit sets the vertex's bit in the round's words in
//     shared memory, which the scanning warps store once the round is
//     done (the nonzero nfw words, vw' and the plane words by their one
//     owner, plain stores).  A level with few candidates costs one coalesced load per
//     32 words.
//   * The direction taken goes to the int after n_new (kPush or kPull),
//     written by block 0 in every launch, so that the host's one read of
//     the level's count also says which order ran.
//   * Counts: each block adds its claims (to n_new and the out-slot), its
//     claimed out-edges and (in a pull) its candidates to the out-slot,
//     one reduction each, which nothing in the launch waits on; n_new
//     comes zeroed with nfw, and block 0 clears the slots that neither
//     this launch nor the next reads, so no counter needs a memset.
// The zeroing of the next call's nfw and n_new rides along in every
// launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "warp_walk.cuh"

namespace {

constexpr int kWarps = 16;                 // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kRound = 128;   // words a block takes per round, at most
constexpr int kMinRound = 32;   // ... and at least: one scanning warp
constexpr int kUnroll = 8;                 // windows of 32 ids per walk step
constexpr int kStep = 32 * kUnroll;        // ids per walk step
constexpr int kHub = kStep;   // a frontier vertex with more out-ids: a hub
constexpr int kHubCap = 1024;              // hubs a slot lists
constexpr unsigned kFull = 0xffffffffu;

// A stats slot (ints), filled by one launch for the next: the
// candidates before its claims, its claims, the out-edge total of the
// vertices it claimed (the next frontier), their hub count (may pass
// kHubCap: only the first kHubCap are listed), the direction it took,
// the launch's number, then the ids of the listed hubs.  The candidates
// the next level sees are kCand - kNew.
enum { kCand = 0, kNew = 1, kEdges = 2, kHubs = 3, kDir = 4, kSeq = 5,
       kList = 8 };
constexpr int kSlotInts = kList + kHubCap;
constexpr int kSlots = 4;
enum { kAuto = 0, kPush = 1, kPull = 2 };

// Push when the frontier's out-edges are fewer than the candidates
// (ops/mega.py::choose_direction is the same rule).
__device__ __forceinline__ bool push_rule(int edges, int cand) {
  return edges < cand;
}

struct Step {
  const int32_t* in_off;                 // (n+1,) CSC offsets
  const int32_t* in_src;                 // (m,) in-neighbours
  const int32_t* out_off;                // (n+1,) CSR offsets (== in_off:
  const int32_t* out_dst;                // (m,) out-neighbours  symmetric)
  const uint32_t* fw;                    // (n_words,) frontier
  uint32_t* vw;                          // (n_words,) visited, in place
  const uint32_t* reach;                 // (n_words,)
  uint32_t* planes;                      // (n_planes*n_words,) in place
  uint32_t* nfw;                         // (n_words,) out, comes zeroed
  int32_t* n_new;                        // (2,) out: claims, comes zeroed;
                                         // then the direction taken
  uint32_t* zero_next;                   // (n_words + 128,) zeroed here
  int32_t* slots;                        // (kSlots * kSlotInts,)
  int32_t* hub_tag;                      // (n,) the launch that listed u
  int in_slot, out_slot, seq;
  int start, start_cand;   // start >= 0: fw is {start}, with start_cand
                           // candidates; the in-slot is not read
  int round;               // words a block takes per pull round
  int n, n_words, n_planes, d, direction;
};

// The vertices < n of word w.
__device__ __forceinline__ uint32_t valid_bits(int w, int n) {
  const int base = w * 32;
  if (base >= n) return 0u;
  return n - base >= 32 ? kFull : (1u << (n - base)) - 1u;
}

// The claimed vertices u[k] of the warp's lanes (mine[k]), with
// out-lists od[k]: their out-edges count towards the next frontier's
// total, and the hubs go on the out-slot's list (one atomicAdd a warp),
// each tagged with the launch's number `seq`.  Every lane of the warp
// calls it.
template <int K, typename Id>
__device__ __forceinline__ void record(int32_t* out, int32_t* hub_tag,
                                       int seq, const bool (&mine)[K],
                                       const Id (&u)[K], const int2 (&od)[K],
                                       int& edges) {
  const int lane = threadIdx.x & 31;
  int n_hubs = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (mine[k]) {
      edges += od[k].y - od[k].x;
      n_hubs += od[k].y - od[k].x > kHub;
    }
  }
  int incl = n_hubs;                   // inclusive scan over the lanes
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  if (total == 0) return;              // uniform
  int h = 0;
  if (lane == 0) h = atomicAdd(out + kHubs, total);
  h = __shfl_sync(kFull, h, 0) + incl - n_hubs;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (mine[k] && od[k].y - od[k].x > kHub) {
      if (h < kHubCap) {
        out[kList + h] = static_cast<int32_t>(u[k]);
        hub_tag[u[k]] = seq;
      }
      ++h;
    }
  }
}

// Push claims of one window of destinations ids[k] (owner[k] < 0: none):
// the reach and visited loads, then the atomics, then the out-offsets of
// the vertices this thread claimed, each stage all in flight.  Every
// lane of the warp calls it.
__device__ __forceinline__ void push_claims(const Step& a, int32_t* out,
                                            const uint32_t (&ids)[kUnroll],
                                            const int (&owner)[kUnroll],
                                            int& claims, int& edges) {
  uint32_t want[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    want[k] = 0u;
    if (owner[k] >= 0) {
      const uint32_t w = ids[k] >> 5;
      want[k] = (1u << (ids[k] & 31u)) & __ldg(a.reach + w) & ~__ldcg(a.vw + w);
    }
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    if (want[k] != 0u && (atomicOr(a.vw + (ids[k] >> 5), want[k]) & want[k]))
      want[k] = 0u;
  }
  int2 od[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    od[k] = make_int2(0, 0);
    if (want[k] != 0u) {
      const uint32_t w = ids[k] >> 5;
      atomicOr(a.nfw + w, want[k]);
      for (int b = 0; b < a.n_planes; ++b) {
        if ((a.d >> b) & 1)
          atomicOr(a.planes + static_cast<size_t>(b) * a.n_words + w, want[k]);
      }
      od[k] = make_int2(__ldg(a.out_off + ids[k]), __ldg(a.out_off + ids[k] + 1));
    }
  }
  bool mine[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    mine[k] = want[k] != 0u;
    claims += mine[k];
  }
  record(out, a.hub_tag, a.seq, mine, ids, od, edges);
}

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(kFull, x);
}

__global__ void __launch_bounds__(kThreads)
mega_step_kernel(const Step a) {
  __shared__ int listed[kRound * 32];    // the round's candidates (pull)
  __shared__ uint32_t touched[kRound];   // the round's hits (pull)
  __shared__ int2 tables[kWarps][32];    // the walk's per-warp tables
  __shared__ int n_listed, taken, s_claims, s_edges, s_cand;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2* table = tables[warp];
  const int32_t* in = a.slots + a.in_slot * kSlotInts;
  int32_t* out = a.slots + a.out_slot * kSlotInts;
  // the input's stats: from the slot, or from the start vertex alone
  int in_cand, in_edges, hubs, in_seq = 0;
  if (a.start >= 0) {
    in_cand = a.start_cand;
    in_edges = __ldg(a.out_off + a.start + 1) - __ldg(a.out_off + a.start);
    hubs = in_edges > kHub ? 1 : 0;
  } else {
    in_cand = __ldcg(in + kCand) - __ldcg(in + kNew);
    in_edges = __ldcg(in + kEdges);
    hubs = min(__ldcg(in + kHubs), kHubCap);
    in_seq = __ldcg(in + kSeq);
  }
  int dir = a.direction;
  if (dir == kAuto)                      // the same in every block
    dir = push_rule(in_edges, in_cand) ? kPush : kPull;
  if (threadIdx.x == 0) {
    s_claims = 0;
    s_edges = 0;
    s_cand = 0;
    if (blockIdx.x == 0) {
      out[kDir] = dir;
      a.n_new[1] = dir;
      out[kSeq] = a.seq;
      for (int s = 0; s < kSlots; ++s) {   // read by no launch before the next
        if (s == a.in_slot || s == a.out_slot) continue;
        for (int i = 0; i < kList; ++i) a.slots[s * kSlotInts + i] = 0;
      }
    }
  }
  {
    uint4* z = reinterpret_cast<uint4*>(a.zero_next);
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.n_words / 4 + 32;
         i += gridDim.x * kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  int claims = 0, edges = 0, cand_count = 0;

  if (dir == kPush) {
    const int gw = warp * gridDim.x + blockIdx.x;   // neighbours: other SMs
    const int n_gw = gridDim.x * kWarps;
    auto claim = [&](const uint32_t (&ids)[kUnroll],
                     const int (&owner)[kUnroll]) {
      push_claims(a, out, ids, owner, claims, edges);
      return 0u;                         // a push visits every id
    };
    {
      int first = 0;                     // pieces of the hubs before h
      for (int h = 0; h < hubs; ++h) {
        const int u = a.start >= 0 ? a.start : __ldcg(in + kList + h);
        if (!((__ldg(a.fw + (u >> 5)) >> (u & 31)) & 1u)) continue;
        const int beg = __ldg(a.out_off + u);
        const int end = __ldg(a.out_off + u + 1);
        const int pieces = (end - beg + kStep - 1) / kStep;
        int p = (gw - first) % n_gw;
        if (p < 0) p += n_gw;
        for (; p < pieces; p += n_gw) {  // uniform across the warp
          const int b = beg + p * kStep;
          uint32_t ids[kUnroll];
          int owner[kUnroll];
#pragma unroll
          for (int k = 0; k < kUnroll; ++k) {
            const int e = b + 32 * k + lane;
            owner[k] = e < end ? lane : -1;
            ids[k] = e < end ? static_cast<uint32_t>(__ldg(a.out_dst + e)) : 0u;
          }
          claim(ids, owner);
        }
        first += pieces;
      }
    }
    // lane l of warp gw loads word gw + l * n_gw: a frontier of
    // consecutive words (a wavefront in breadth-first order) spreads over
    // many warps instead of queueing on one
    for (int base = gw; base < a.n_words; base += 32 * n_gw) {
      const int word = base + lane * n_gw;
      const uint32_t f = word < a.n_words
          ? __ldg(a.fw + word) & valid_bits(word, a.n) : 0u;
      uint32_t words = __ballot_sync(kFull, f != 0u);
      while (words != 0) {               // uniform
        const int j = __ffs(words) - 1;
        words &= words - 1;
        const uint32_t bits = __shfl_sync(kFull, f, j);
        int beg = 0, end = 0;
        if ((bits >> lane) & 1u) {
          const int u = (base + j * n_gw) * 32 + lane;
          beg = __ldg(a.out_off + u);
          end = __ldg(a.out_off + u + 1);
          if (end - beg > kHub && hubs > 0 &&
              (a.start >= 0 ? u == a.start
                            : __ldcg(a.hub_tag + u) == in_seq))
            end = beg;                   // a listed hub: walked above
        }
        warp_walk::walk_lists<kUnroll>(a.out_dst, beg, end, table, [] {},
                                       claim);
      }
    }
  } else {
    const bool same = a.out_off == a.in_off;
    const int scan_warps = a.round / 32;
    for (int r0 = blockIdx.x * a.round; r0 < a.n_words;
         r0 += gridDim.x * a.round) {
      __syncthreads();                   // the last round is stored
      if (threadIdx.x == 0) {
        n_listed = 0;
        taken = 0;
      }
      if (threadIdx.x < a.round) touched[threadIdx.x] = 0u;
      __syncthreads();
      const int word = r0 + threadIdx.x;   // scanning warps only
      uint32_t seen = 0u, cand = 0u;
      if (warp < scan_warps) {
        if (word < a.n_words) {
          seen = a.vw[word];
          cand = __ldg(a.reach + word) & ~seen & valid_bits(word, a.n);
        }
        const int c = __popc(cand);
        cand_count += c;
        int incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int t = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += t;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        int at = 0;
        if (lane == 0 && total != 0) at = atomicAdd(&n_listed, total);
        at = __shfl_sync(kFull, at, 0) + incl - c;
        for (uint32_t rest = cand; rest != 0u; rest &= rest - 1u)
          listed[at++] = word * 32 + __ffs(rest) - 1;
      }
      __syncthreads();
      const int count = n_listed;
      if (count == 0) continue;          // uniform: nothing to walk or store
      int at = __shfl_sync(kFull, lane == 0 ? atomicAdd(&taken, 32) : 0, 0);
      int v = at + lane < count ? listed[at + lane] : -1;
      int2 list = v >= 0 ? make_int2(__ldg(a.in_off + v), __ldg(a.in_off + v + 1))
                         : make_int2(0, 0);
      while (at < count) {               // uniform across the warp
        const int at_next =
            __shfl_sync(kFull, lane == 0 ? atomicAdd(&taken, 32) : 0, 0);
        const int v_next = at_next + lane < count ? listed[at_next + lane] : -1;
        const int2 list_next = v_next >= 0   // in flight during this walk
            ? make_int2(__ldg(a.in_off + v_next), __ldg(a.in_off + v_next + 1))
            : make_int2(0, 0);
        const uint32_t found = warp_walk::walk_lists<kUnroll>(
            a.in_src, list.x, list.y, table, [] {},
            [&](const uint32_t (&ids)[kUnroll], const int (&owner)[kUnroll]) {
              uint32_t hit = 0u;
#pragma unroll
              for (int k = 0; k < kUnroll; ++k) {
                if (owner[k] >= 0 &&
                    ((__ldg(a.fw + (ids[k] >> 5)) >> (ids[k] & 31u)) & 1u))
                  hit |= 1u << owner[k];
              }
              return hit;
            });
        const bool hit = (found >> lane) & 1u;   // a candidate: claimed
        int2 od = list;
        if (hit) {
          atomicOr(touched + (v >> 5) - r0, 1u << (v & 31));
          if (!same)
            od = make_int2(__ldg(a.out_off + v), __ldg(a.out_off + v + 1));
        }
        const bool mine[1] = {hit};
        const int us[1] = {v};
        const int2 ods[1] = {od};
        record(out, a.hub_tag, a.seq, mine, us, ods, edges);
        at = at_next;
        v = v_next;
        list = list_next;
      }
      __syncthreads();
      if (warp < scan_warps && word < a.n_words) {
        const uint32_t fresh = touched[threadIdx.x] & cand;
        if (fresh != 0u) {               // nfw came zeroed
          a.nfw[word] = fresh;
          a.vw[word] = seen | fresh;
          for (int b = 0; b < a.n_planes; ++b) {
            if ((a.d >> b) & 1)
              a.planes[static_cast<size_t>(b) * a.n_words + word] |= fresh;
          }
          claims += __popc(fresh);
        }
      }
    }
  }

  claims = warp_sum(claims);
  edges = warp_sum(edges);
  cand_count = warp_sum(cand_count);
  if (lane == 0) {
    if (claims) atomicAdd(&s_claims, claims);
    if (edges) atomicAdd(&s_edges, edges);
    if (cand_count) atomicAdd(&s_cand, cand_count);
  }
  __syncthreads();
  if (threadIdx.x == 0) {             // reductions only: nothing waits on them
    if (s_claims) {
      atomicAdd(a.n_new, s_claims);
      atomicAdd(out + kNew, s_claims);
    }
    if (s_edges) atomicAdd(out + kEdges, s_edges);
    if (dir == kPush && blockIdx.x == 0) s_cand += in_cand;
    if (s_cand) atomicAdd(out + kCand, s_cand);
  }
}

// The stats of an input the wrapper did not produce, into a cleared
// slot: the candidates (reach & ~vw), the frontier's out-edge total and
// its hubs (no claims), under the launch number `seq`.  Each warp loads
// 32 words of each map at once.
__global__ void __launch_bounds__(kThreads)
mega_stats_kernel(const Step a, int slot, int seq) {
  __shared__ int s_edges, s_cand;
  const int lane = threadIdx.x & 31;
  int32_t* out = a.slots + slot * kSlotInts;
  if (threadIdx.x == 0) {
    s_edges = 0;
    s_cand = 0;
    if (blockIdx.x == 0) out[kSeq] = seq;
  }
  __syncthreads();
  int edges = 0, cand = 0;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_gw = gridDim.x * kWarps;
  for (int g0 = gw * 32; g0 < a.n_words; g0 += n_gw * 32) {
    const int word = g0 + lane;
    uint32_t f = 0u;
    if (word < a.n_words) {
      const uint32_t valid = valid_bits(word, a.n);
      cand += __popc(__ldg(a.reach + word) & ~__ldg(a.vw + word) & valid);
      f = __ldg(a.fw + word) & valid;
    }
    uint32_t words = __ballot_sync(kFull, f != 0u);
    while (words != 0) {                 // uniform
      const int j = __ffs(words) - 1;
      words &= words - 1;
      const uint32_t bits = __shfl_sync(kFull, f, j);
      const bool mine = (bits >> lane) & 1u;
      const int u = (g0 + j) * 32 + lane;
      int2 od = make_int2(0, 0);
      if (mine) od = make_int2(__ldg(a.out_off + u), __ldg(a.out_off + u + 1));
      const bool mines[1] = {mine};
      const int us[1] = {u};
      const int2 ods[1] = {od};
      record(out, a.hub_tag, seq, mines, us, ods, edges);
    }
  }
  edges = warp_sum(edges);
  cand = warp_sum(cand);
  if (lane == 0) {
    if (edges) atomicAdd(&s_edges, edges);
    if (cand) atomicAdd(&s_cand, cand);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_edges) atomicAdd(out + kEdges, s_edges);
    if (s_cand) atomicAdd(out + kCand, s_cand);
  }
}

// Blocks of `kernel` that fit on the card at once, asked once per device.
cudaError_t resident_blocks(const void* kernel, int* blocks) {
  static const void* fn[2] = {nullptr, nullptr};
  static int dev_of[2] = {-1, -1}, value[2] = {0, 0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < 2; ++i) {
    if (fn[i] == kernel && dev_of[i] == dev) {
      *blocks = value[i];
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  const int i = fn[0] == kernel || fn[0] == nullptr ? 0 : 1;
  fn[i] = kernel;
  dev_of[i] = dev;
  value[i] = *blocks;
  return cudaSuccess;
}

}  // namespace

// Ints of the stats slots the wrapper allocates (zeroed, once).
extern "C" int gt_mega_slot_ints() { return kSlots * kSlotInts; }

// Launches one level on `stream`.  `direction`: 0 by the stats of the
// input, 1 push, 2 pull.  The input's stats: with start >= 0, fw is the
// start vertex alone and `start_cand` the candidates (in_slot is then
// unread); else slot `in_slot`, which with stats_slot >= 0 (then equal to
// in_slot, a cleared slot) the stats kernel fills first, as launch
// number seq - 1.  The level's stats go to `out_slot`, which must be
// cleared, as launch number `seq`; the launch clears every slot but
// in_slot and out_slot.  `hub_tag` (n ints) holds the numbers of the
// launches that listed each hub; `seq` must differ from every number
// there but those of the slot in_slot (the wrapper counts up by two).
// `nfw` (n_words ints) and `n_new[0]` must come zeroed; `n_new[1]` gets
// the direction taken (1 push, 2 pull);
// `zero_next` (n_words + 128 ints, 16-byte aligned) is zeroed for the
// next call's.  Returns the cudaError_t of the launches (0 on success);
// the caller raises on any other value.
extern "C" int gt_mega_step(const void* in_off, const void* in_src,
                            const void* out_off, const void* out_dst,
                            const void* fw, void* vw, const void* reach,
                            void* planes, void* nfw, void* zero_next,
                            void* n_new, void* slots, void* hub_tag,
                            int seq, int in_slot, int out_slot,
                            int stats_slot, int start,
                            int start_cand, int n, int n_words,
                            int n_planes, int d, int direction, void* stream) {
  if (in_slot < 0 || in_slot >= kSlots || out_slot < 0 ||
      out_slot >= kSlots || in_slot == out_slot ||
      (stats_slot >= 0 && (stats_slot != in_slot || start >= 0)) ||
      start >= n || direction < 0 ||
      direction > 2 || n_words % 128 != 0 || seq < 2 ||
      zero_next == nullptr ||
      (reinterpret_cast<uintptr_t>(zero_next) & 15u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Step a{static_cast<const int32_t*>(in_off),
         static_cast<const int32_t*>(in_src),
         static_cast<const int32_t*>(out_off),
         static_cast<const int32_t*>(out_dst),
         static_cast<const uint32_t*>(fw),
         static_cast<uint32_t*>(vw),
         static_cast<const uint32_t*>(reach),
         static_cast<uint32_t*>(planes),
         static_cast<uint32_t*>(nfw),
         static_cast<int32_t*>(n_new),
         static_cast<uint32_t*>(zero_next),
         static_cast<int32_t*>(slots),
         static_cast<int32_t*>(hub_tag),
         in_slot, out_slot, seq, start, start_cand, kRound, n, n_words,
         n_planes, d, direction};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stats_slot >= 0) {
    int cap = 0;
    err = resident_blocks(reinterpret_cast<const void*>(mega_stats_kernel),
                          &cap);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int want = (n_words / 32 + kWarps - 1) / kWarps;
    mega_stats_kernel<<<want < cap ? want : cap, kThreads, 0, s>>>(
        a, stats_slot, seq - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int cap = 0;
  err = resident_blocks(reinterpret_cast<const void*>(mega_step_kernel), &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  // rounds of kRound words, or fewer down to kMinRound while that leaves
  // fewer blocks than two an SM: a small graph still spreads its pull
  // over the card
  int round = kRound;
  while (round > kMinRound && (n_words + round - 1) / round < cap / 2)
    round /= 2;
  a.round = round;
  const int want = (n_words + round - 1) / round;
  mega_step_kernel<<<want < cap ? want : cap, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
