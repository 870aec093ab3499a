// One Jacobi sweep of a min or add combine over in-edges, for NVIDIA
// Hopper (sm_90a).
//
// Replaces: gunrockinst_tpu/ops/pallas_value.py:608 `_make_value_kernel`
// (wrapper `ValueStepper`, pallas_value.py:1013), and through
// ops/spmv.py the pull-SpMV gunrockinst_tpu/ops/pallas_spmv.py:273
// `_hub_kernel` and :296 `_packed_kernel`.  Same function at the
// per-vertex interface: values are vertex-major 32-bit words holding f32
// or i32 bits, changed maps are word maps (bit b of word w is vertex
// 32w+b).  For every vertex v:
//
//   cand(u->v) = vals[u] (+ w[e] or + const_w)      one f32 add, rounded
//                                                   to nearest
//   gated      : cand counts only when bit u of ch is set (use_active)
//   init       = vals[v] (min) or 0 (add)
//   out[v]     = comb(init, comb over the in-edges u->v of cand)
//   changed[v] = init > out[v]    (min, compared as f32 or i32; the add
//                                  sweep tracks nothing)
//   n_changed  = popcount(changed)                (device counter)
//   edges      = out-edges of the changed vertices (min, device counter:
//                the work of the next sweep, which the route rule reads)
//
// comb is min over f32 or i32 (identity +inf or INT32_MAX) or add over
// f32 (identity 0).  The TPU kernel's zero_acc and track_changed follow
// the mode in every caller, so here the combine carries them.  Jacobi:
// every candidate reads `vals`, the round-start snapshot, and the result
// goes to a separate buffer `out`.
//
// Unlike the TPU kernel, the ungated add sweep sums over every in-edge:
// the TPU kernel also skips the sources of each 4096-vertex region whose
// `ch` row is zero, which changes nothing when the values of those
// sources are zero, as PageRank's contributions are.
//
// What bounds it on the card: bytes.  A dense sweep at rmat-s20 must read
// the ~31.4 M in-edge ids (4 B each, ~126 MB) and the CSC offsets (4 MB);
// ~42 us at 3.35 TB/s.  But a gated sweep only needs the edges of its
// active sources, and most rounds of SSSP, CC and BC have few: SSSP's
// first round has one.  So a sweep takes one of three routes, all giving
// the same bits:
//   * dense: the pull over every destination word (below);
//   * push (min only): the active sources walk their out-edges (the
//     out-CSR) and put each candidate into `best[v]` with an integer
//     atomicMin, which is the float order on the bits of non-negative
//     floats and +inf (the wrapper takes this route only when no value
//     or weight can be negative, -0.0 or NaN); a plain pass then writes
//     out[v] = min(vals[v], best[v]), resets best to the identity, and
//     writes the changed map and both counts.  best is kept all-identity
//     between sweeps, so the push needs no copy of vals first;
//   * touched: the active sources walk their out-edges and set the bit
//     of each destination word they reach (integer atomicOr); then the
//     dense pull runs over the touched words only, with its fold
//     unchanged, and every other word writes its init (vals[v] for min,
//     0 for add).  An untouched word has no active in-edge, so its init
//     is the dense pull's result too, and a touched word's vertices get
//     the dense pull's bits: f32 sums stay free of float atomics.
// An active source with more than kHub out-edges (a hub) is not walked by
// one warp: it is listed, with its pieces of kPiece ids numbered by the
// same 64-bit atomic as the list, and a second kernel hands the pieces
// of all listed hubs out to the warps of the grid in contiguous runs.
// The route is picked by the wrapper (ops/value.py::choose_route) when it
// knows the active sources' out-edge total, or on the card: from the
// counts the previous sweep left (when ch is its changed map) or from a
// stats kernel, every kernel of the sweep reading the same word, so all
// blocks take the same branch.  Each sweep adds one to the per-device
// tally of the route it took and records it for the wrapper.
//
// The dense pull: in-edges are walked by three kinds of work, so that no
// warp walks much more than the others (after degree relabeling the
// first destination words hold every hub):
//   * a vertex with at most kLaneDegree in-edges: its own lane, in the
//     warp of its destination word;
//   * up to `long_degree` in-edges: the whole warp of its word, one such
//     vertex at a time, 32 coalesced ids per step, kUnroll steps in
//     flight;
//   * more (a "long" vertex): its in-list is cut into chunks of at most
//     `long_degree` edges (chunk_begin/chunk_end, built once per graph
//     by ops/value.py), one warp per chunk writes the chunk's partial,
//     and a second kernel, one warp per long vertex, combines the
//     partials of its chunks and writes its value and changed bit.
// Each lane folds its candidates in edge order and a warp ends with a
// fixed shuffle tree, so every destination is combined in one fixed
// order and an f32 add sweep gives the same bits on every run; there
// is no float atomic.  The main kernel owns each word: `out` and the
// changed word are plain stores.  The integer atomics are one add per
// block for each count and one OR per changed long vertex into its
// changed word, after the main kernel stored it.  A gated candidate
// whose ch bit is clear never reads its value or its weight.
//
// The chunks of the long lists and, on a touched route known at launch,
// the words are handed out grid-stride over at most the blocks that fit
// the card at once: a block per 8 chunks launched tens of thousands of
// blocks, whose start-up cost a thin sweep paid though it skipped them.
//
// Known slowness, left for later work: one lane walks a whole in-list of
// up to kLaneDegree ids while the other lanes of its warp may be done,
// each lane's id loads and value gathers forming one chain of dependent
// loads.  A dense pull whose id stream went through shared memory by
// bulk copies (3 stages of 256 ids a warp) gave the same bits but took
// 1.6-2.3x as long (PERF.md), and was not kept.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kLaneDegree = 32;   // larger in-lists are walked by the warp
constexpr int kUnroll = 4;        // ids in flight per lane (pull)
constexpr int kPushUnroll = 8;    // windows of 32 out-ids per walk step
constexpr int kPiece = 32 * kPushUnroll;   // ids of one hub piece
constexpr int kHub = kPiece;      // an active source with more: a hub
constexpr int kHubCap = 1 << 16;  // hubs listed; later ones walk alone
constexpr unsigned kFull = 0xffffffffu;

// flags, as ops/value.py passes them
constexpr int kUseActive = 1;
constexpr int kConstW = 2;

// routes (ops/value.py::ROUTES, from 1)
enum { kAuto = 0, kDense = 1, kPush = 2, kTouched = 3 };

// The scratch of a stepper (ints): the route taken; then two sets, used
// by sparse sweeps in turn, of the stats of ch (active sources, their
// out-edges), the hub counter (64 bits: hubs listed << 32 | pieces
// numbered) and the touched map (one bit per destination word); then the
// hub list (vertex, first piece).  A sparse sweep uses one set and
// zeroes the other for the next, so no sweep needs a memset of them.
enum { kRouteAt = 0, kStats = 2, kHubCtr = 6, kHead = 10 };

__host__ __device__ constexpr int touched_ints(int n_words) {
  return (n_words + 31) / 32;
}

// kFromZero: init is the identity, not vals[v]; kTracks: emit changed.
struct MinF32 {
  using T = float;
  static constexpr bool kFloat = true;
  static constexpr bool kFromZero = false;
  static constexpr bool kTracks = true;
  static constexpr int32_t kIdentBits = 0x7f800000;
  __device__ static T ident() { return __int_as_float(0x7f800000); }
  __device__ static T comb(T a, T b) { return b < a ? b : a; }
  __device__ static T load(int32_t x) { return __int_as_float(x); }
  __device__ static int32_t bits(T x) { return __float_as_int(x); }
};
struct MinI32 {
  using T = int32_t;
  static constexpr bool kFloat = false;
  static constexpr bool kFromZero = false;
  static constexpr bool kTracks = true;
  static constexpr int32_t kIdentBits = 0x7fffffff;
  __device__ static T ident() { return 0x7fffffff; }
  __device__ static T comb(T a, T b) { return b < a ? b : a; }
  __device__ static T load(int32_t x) { return x; }
  __device__ static int32_t bits(T x) { return x; }
};
struct AddF32 {
  using T = float;
  static constexpr bool kFloat = true;
  static constexpr bool kFromZero = true;
  static constexpr bool kTracks = false;
  static constexpr int32_t kIdentBits = 0;
  __device__ static T ident() { return 0.0f; }
  __device__ static T comb(T a, T b) { return __fadd_rn(a, b); }
  __device__ static T load(int32_t x) { return __int_as_float(x); }
  __device__ static int32_t bits(T x) { return __float_as_int(x); }
};

struct Sweep {
  const int32_t* offsets;      // (n+1,) CSC offsets
  const int32_t* in_src;       // (m,) in-neighbours
  const float* w;              // (m,) CSC-order weights, or null
  const int32_t* out_off;      // (n+1,) out-CSR offsets, or null
  const int32_t* out_dst;      // (m,) out-neighbours
  const float* out_w;          // (m,) out-order weights, or null
  const uint32_t* ch;          // (n_words,) or null
  const int32_t* vals;         // (32*n_words,)
  int32_t* out;                // (32*n_words,)
  uint32_t* chout;             // (n_words,)
  int32_t* counts;             // (2,) n_changed, edges
  const int32_t* stats;        // (2,) ch's active sources, their out-edges
  int32_t* scratch;            // the stepper's scratch (above)
  uint32_t* touched;           // this sweep's set ...
  unsigned long long* hub_ctr;
  uint32_t* touched_next;      // ... and the next sparse sweep's
  unsigned long long* hub_ctr_next;
  int32_t* stats_next;
  int32_t* hubs;               // the hub list, after the touched maps
  int32_t* best;               // (32*n_words,) all identity, or null
  int32_t* tally;              // (4,) sweeps per route, per device
  const int32_t* chunk_begin;  // (n_chunks,)
  const int32_t* chunk_end;    // (n_chunks,)
  const int32_t* chunk_v;      // (n_chunks,) the long vertex of each chunk
  const int32_t* long_v;       // (n_long,)
  const int32_t* long_chunk;   // (n_long+1,)
  int32_t* partials;           // (n_chunks,) scratch
  int n, n_words, n_chunks, n_long, long_degree, flags, route;
  int push_limit, touched_limit, chunk_blocks, touched_n;
  float const_w;
};

// The sweep's route: the forced one, or by the out-edge total of ch's
// active sources (ops/value.py::choose_route).  Every kernel of a sweep
// reads the same word, which no kernel of the sweep writes: through the
// read-only path, so that an SM's blocks find it in L1 and do not all
// queue on one L2 address.
__device__ __forceinline__ int decide(const Sweep& a) {
  if (a.route != kAuto) return a.route;
  const int edges = __ldg(a.stats + 1);
  if (edges < a.push_limit) return kPush;
  if (edges < a.touched_limit) return kTouched;
  return kDense;
}

__device__ __forceinline__ void record(const Sweep& a, int route) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.scratch[kRouteAt] = route;
    atomicAdd(a.tally + route, 1);
  }
}

// Whether word `word` is touched, read after the marking kernels.
__device__ __forceinline__ bool word_touched(const Sweep& a, int word) {
  return (__ldg(a.touched + (word >> 5)) >> (word & 31)) & 1u;
}

// The vertices < n of word w.
__device__ __forceinline__ uint32_t valid_bits(int w, int n) {
  const int base = w * 32;
  if (base >= n) return 0u;
  return n - base >= 32 ? kFull : (1u << (n - base)) - 1u;
}

__device__ __forceinline__ bool active_bit(const uint32_t* __restrict__ ch,
                                           uint32_t u) {
  return (__ldg(ch + (u >> 5)) >> (u & 31u)) & 1u;
}

__device__ __forceinline__ int warp_sum(int x) {
  return __reduce_add_sync(kFull, x);
}

// The candidate of edge e from source u, or the identity when the
// source is gated off.  Weights exist only for the f32 combines.
template <typename Op>
__device__ __forceinline__ typename Op::T candidate(
    const int32_t* __restrict__ vals, const float* __restrict__ w,
    const uint32_t* __restrict__ ch, int flags, float const_w, int e,
    uint32_t u) {
  using T = typename Op::T;
  if ((flags & kUseActive) && !active_bit(ch, u)) return Op::ident();
  T x = Op::load(__ldg(vals + u));
  if constexpr (Op::kFloat) {
    if (w != nullptr) {
      x = __fadd_rn(x, __ldg(w + e));
    } else if (flags & kConstW) {
      x = __fadd_rn(x, const_w);
    }
  }
  return x;
}

// Lane 0's partial combined with those of lanes 1..31 in a fixed tree
// (off = 16, 8, 4, 2, 1), broadcast to every lane.
template <typename Op>
__device__ __forceinline__ typename Op::T warp_tree(typename Op::T part) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part = Op::comb(part, __shfl_down_sync(kFull, part, off));
  }
  return __shfl_sync(kFull, part, 0);
}

// The comb of the candidates of edges [beg, end), walked by the whole
// warp: lane l folds edges beg + l, beg + l + 32, ... in order, then a
// fixed tree.  Every lane returns the result.
template <typename Op>
__device__ __forceinline__ typename Op::T warp_walk(
    const int32_t* __restrict__ in_src, const int32_t* __restrict__ vals,
    const float* __restrict__ w, const uint32_t* __restrict__ ch,
    int flags, float const_w, int beg, int end, int lane) {
  using T = typename Op::T;
  T part = Op::ident();
  for (int base = beg; base < end; base += 32 * kUnroll) {
    uint32_t u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int e = base + k * 32 + lane;
      u[k] = e < end ? static_cast<uint32_t>(in_src[e]) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int e = base + k * 32 + lane;
      if (e < end) {
        part = Op::comb(part, candidate<Op>(vals, w, ch, flags, const_w, e,
                                            u[k]));
      }
    }
  }
  return warp_tree<Op>(part);
}

// ---- the dense pull (and the touched route's pull) ----------------------

// The chunks of the long in-lists, grid-stride over the first
// chunk_blocks blocks: one warp per chunk writes the chunk's partial.
// On the touched route the chunks of a vertex in an untouched word are
// skipped.  Every lane of the warp calls it.
template <typename Op>
__device__ __forceinline__ void chunk_walks(const Sweep& a, bool filter) {
  const int lane = threadIdx.x & 31;
  for (int c = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       c < a.n_chunks; c += a.chunk_blocks * kWarpsPerBlock) {
    if (filter && !word_touched(a, a.chunk_v[c] >> 5)) continue;
    const typename Op::T part = warp_walk<Op>(
        a.in_src, a.vals, a.w, a.ch, a.flags, a.const_w, a.chunk_begin[c],
        a.chunk_end[c], lane);
    if (lane == 0) a.partials[c] = Op::bits(part);
  }
}

// Blocks [0, chunk_blocks): the chunks (`chunk_walks`).  The other
// blocks: one warp per destination word (grid-stride when the grid is
// smaller than the words), which writes out[] and the changed word of
// every vertex of the word that is not long.  On the touched route a
// word whose bit is clear writes its init and an empty changed word.
template <typename Op>
__global__ void __launch_bounds__(kThreads) pull_kernel(const Sweep a) {
  using T = typename Op::T;
  const int route = decide(a);
  if (route == kPush) return;
  record(a, route);
  const bool filter = route == kTouched;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < a.chunk_blocks) {
    chunk_walks<Op>(a, filter);
    return;                             // the whole block returns
  }

  __shared__ int block_changed, block_edges;
  if (threadIdx.x == 0) {
    block_changed = 0;
    block_edges = 0;
  }
  __syncthreads();
  int changed_sum = 0, edges_sum = 0;
  const int n_ww = (gridDim.x - a.chunk_blocks) * kWarpsPerBlock;
  for (int word = (blockIdx.x - a.chunk_blocks) * kWarpsPerBlock + warp;
       word < a.n_words; word += n_ww) {        // uniform across the warp
    const int v = word * 32 + lane;
    if (filter && !word_touched(a, word)) {     // an untouched word
      a.out[v] = Op::kFromZero ? Op::kIdentBits : a.vals[v];
      if (lane == 0) a.chout[word] = 0u;
      continue;
    }
    const bool real = v < a.n;
    int beg = 0, end = 0;
    if (real) {
      beg = a.offsets[v];
      end = a.offsets[v + 1];
    }
    const int deg = end - beg;
    const bool is_long = real && deg > a.long_degree;
    T acc = Op::ident();
    if (real && deg <= kLaneDegree) {
      for (int e0 = beg; e0 < end; e0 += kUnroll) {
        uint32_t u[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          u[k] = e0 + k < end ? static_cast<uint32_t>(a.in_src[e0 + k]) : 0u;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (e0 + k < end) {
            acc = Op::comb(acc, candidate<Op>(a.vals, a.w, a.ch, a.flags,
                                              a.const_w, e0 + k, u[k]));
          }
        }
      }
    }
    uint32_t mid = __ballot_sync(kFull, real && deg > kLaneDegree &&
                                            !is_long);
    while (mid != 0) {                  // uniform: same mask in every lane
      const int h = __ffs(mid) - 1;
      mid &= mid - 1;
      const T part = warp_walk<Op>(a.in_src, a.vals, a.w, a.ch, a.flags,
                                   a.const_w, __shfl_sync(kFull, beg, h),
                                   __shfl_sync(kFull, end, h), lane);
      if (lane == h) acc = part;
    }
    bool changed = false;
    if (!is_long) {                     // long vertices: finish kernel
      const T init = Op::kFromZero ? Op::ident() : Op::load(a.vals[v]);
      const T next = Op::comb(init, acc);
      a.out[v] = Op::bits(next);
      changed = Op::kTracks && real && init > next;
    }
    const uint32_t cw = __ballot_sync(kFull, changed);
    int edges = 0;
    if (changed && a.out_off != nullptr)
      edges = __ldg(a.out_off + v + 1) - __ldg(a.out_off + v);
    edges = warp_sum(edges);
    if (lane == 0) {
      a.chout[word] = cw;
      changed_sum += __popc(cw);
      edges_sum += edges;
    }
  }
  if (lane == 0 && changed_sum != 0) {
    atomicAdd(&block_changed, changed_sum);
    atomicAdd(&block_edges, edges_sum);
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_changed != 0) {
    atomicAdd(a.counts, block_changed);
    atomicAdd(a.counts + 1, block_edges);
  }
}

// One warp per long vertex: combines the partials of its chunks (lane l
// folds chunks l, l + 32, ... in order, then a fixed tree), then writes
// its value, ORs its changed bit into the word the main kernel stored,
// and counts it.  On the touched route a vertex of an untouched word is
// skipped (the main kernel wrote its init).
template <typename Op>
__global__ void __launch_bounds__(kThreads) finish_kernel(const Sweep a) {
  using T = typename Op::T;
  const int route = decide(a);
  if (route == kPush) return;
  __shared__ int block_changed, block_edges;
  if (threadIdx.x == 0) {
    block_changed = 0;
    block_edges = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       i < a.n_long; i += gridDim.x * kWarpsPerBlock) {   // uniform
    const int v = a.long_v[i];
    if (!(route == kTouched && !word_touched(a, v >> 5))) {
      T part = Op::ident();
      for (int c = a.long_chunk[i] + lane; c < a.long_chunk[i + 1]; c += 32) {
        part = Op::comb(part, Op::load(a.partials[c]));
      }
      part = warp_tree<Op>(part);
      if (lane == 0) {
        const T init = Op::kFromZero ? Op::ident() : Op::load(a.vals[v]);
        const T next = Op::comb(init, part);
        a.out[v] = Op::bits(next);
        if (Op::kTracks && init > next) {
          atomicOr(a.chout + (v >> 5), 1u << (v & 31));
          atomicAdd(&block_changed, 1);
          if (a.out_off != nullptr)
            atomicAdd(&block_edges,
                      __ldg(a.out_off + v + 1) - __ldg(a.out_off + v));
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_changed != 0) {
    atomicAdd(a.counts, block_changed);
    atomicAdd(a.counts + 1, block_edges);
  }
}

// ---- the out-edge walks of the push and touched routes ------------------

// The warp-cooperative walk of the lanes' out-lists (lane l owns
// positions [cur, lim)): each step gives every open list an equal quota
// of 32 * K positions (at least K), lays the quotas end to end, and lane
// l takes positions l, l + 32, ... of that range; `visit(pos, owner)`
// sees them (owner -1: none).  The same walk as csrc/warp_walk.cuh's,
// handing out positions rather than ids, and with no early stop.  Every
// lane of the warp calls it.
template <int K, typename Visit>
__device__ __forceinline__ void walk_positions(int cur, int lim, int2* table,
                                               Visit&& visit) {
  constexpr int kStep = 32 * K;
  const int lane = threadIdx.x & 31;
  const unsigned upto = kFull >> (31 - lane);    // lanes 0..lane
  const unsigned below = upto >> 1;              // lanes 0..lane-1
  uint32_t open = __ballot_sync(kFull, cur < lim);
  while (open != 0) {                 // uniform: same mask in every lane
    const bool mine = (open >> lane) & 1u;
    const int quota = kStep / __popc(open);
    const int len = mine ? min(lim - cur, quota) : 0;
    int incl = len;                   // inclusive scan of the quotas
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    const int first = incl - len;     // this list's first position
    if (mine) table[__popc(open & below)] = make_int2(lane, cur - first);
    __syncwarp();
    int pos[K], owner[K];
    int before = 0;                   // lists that start in earlier windows
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int w0 = 32 * k;
      const uint32_t heads = __reduce_or_sync(
          kFull, mine && first >= w0 && first < w0 + 32
                     ? 1u << (first - w0) : 0u);
      const int p = w0 + lane;
      owner[k] = -1;
      pos[k] = 0;
      if (p < total) {
        const int2 t = table[before + __popc(heads & upto) - 1];
        owner[k] = t.x;
        pos[k] = t.y + p;
      }
      before += __popc(heads);
    }
    visit(pos, owner);
    cur += len;
    open = __ballot_sync(kFull, mine && cur < lim);
    __syncwarp();                     // the table is rewritten next step
  }
}

// Push: the candidates of the out-edges at pos[k] (owner[k] >= 0) from
// the owner lanes' sources, whose values xu the lanes hold, into best[]
// by integer atomicMin; a candidate no smaller than best's value (read
// from L2; best only falls) takes no atomic.  Loads of each stage all in
// flight.  Every lane of the warp calls it.
template <typename Op>
__device__ __forceinline__ void push_window(const Sweep& a,
                                            const int (&pos)[kPushUnroll],
                                            const int (&owner)[kPushUnroll],
                                            typename Op::T xu) {
  using T = typename Op::T;
  int v[kPushUnroll];
  int32_t cb[kPushUnroll];
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k)
    v[k] = owner[k] >= 0 ? __ldg(a.out_dst + pos[k]) : -1;
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k) {
    T c = __shfl_sync(kFull, xu, owner[k] & 31);
    if constexpr (Op::kFloat) {
      if (a.out_w != nullptr) {
        c = __fadd_rn(c, owner[k] >= 0 ? __ldg(a.out_w + pos[k]) : 0.0f);
      } else if (a.flags & kConstW) {
        c = __fadd_rn(c, a.const_w);
      }
    }
    cb[k] = Op::bits(c);
  }
  int32_t cur[kPushUnroll];
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k)
    cur[k] = v[k] >= 0 ? __ldcg(a.best + v[k]) : INT32_MIN;
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k)
    if (cb[k] < cur[k]) atomicMin(a.best + v[k], cb[k]);
}

// Touched: the destination words of the out-edges at pos[k] get their
// bit in the touched map (integer atomicOr, skipped when the bit reads
// set already).
__device__ __forceinline__ void mark_window(const Sweep& a,
                                            const int (&pos)[kPushUnroll],
                                            const int (&owner)[kPushUnroll]) {
  int word[kPushUnroll];
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k)
    word[k] = owner[k] >= 0 ? __ldg(a.out_dst + pos[k]) >> 5 : -1;
  uint32_t seen[kPushUnroll];
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k)
    seen[k] = word[k] >= 0 ? __ldcg(a.touched + (word[k] >> 5)) : kFull;
#pragma unroll
  for (int k = 0; k < kPushUnroll; ++k) {
    const uint32_t bit = 1u << (word[k] & 31);
    if (!(seen[k] & bit)) atomicOr(a.touched + (word[k] >> 5), bit);
  }
}

// The pieces of hub u's out-list: kPiece ids each.
__device__ __forceinline__ int pieces_of(int beg, int end) {
  return (end - beg + kPiece - 1) / kPiece;
}

// Push or touched, part 1: the out-lists of the active sources that are
// not hubs, walked by the warp that finds them.  Lane l of warp gw
// loads ch word gw + l * n_gw, so consecutive active words spread over
// many warps.  A hub is listed with its first piece number; one that
// finds the list full is walked here.
template <typename Op>
__global__ void __launch_bounds__(kThreads) scatter_kernel(const Sweep a) {
  using T = typename Op::T;
  // the first kernel of every sparse sweep: it zeroes the counts (added
  // to by later kernels only) and the next sparse sweep's set
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.counts[0] = 0;
    a.counts[1] = 0;
    a.stats_next[0] = 0;
    a.stats_next[1] = 0;
    *a.hub_ctr_next = 0ull;
  }
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < a.touched_n;
       i += gridDim.x * kThreads)
    a.touched_next[i] = 0u;
  const int route = decide(a);
  if (route == kDense) return;
  const bool mark = route == kTouched;
  __shared__ int2 tables[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int2* table = tables[warp];
  const int gw = warp * gridDim.x + blockIdx.x;
  const int n_gw = gridDim.x * kWarpsPerBlock;
  unsigned long long* ctr = a.hub_ctr;
  for (int base = gw; base < a.n_words; base += 32 * n_gw) {
    const int word = base + lane * n_gw;
    const uint32_t f = word < a.n_words
        ? __ldg(a.ch + word) & valid_bits(word, a.n) : 0u;
    uint32_t words = __ballot_sync(kFull, f != 0u);
    while (words != 0) {               // uniform
      const int j = __ffs(words) - 1;
      words &= words - 1;
      const uint32_t bits = __shfl_sync(kFull, f, j);
      int beg = 0, end = 0;
      T xu = Op::ident();
      if ((bits >> lane) & 1u) {
        const int u = (base + j * n_gw) * 32 + lane;
        beg = __ldg(a.out_off + u);
        end = __ldg(a.out_off + u + 1);
        if (end - beg > kHub) {
          const unsigned long long old = atomicAdd(
              ctr, (1ull << 32) | static_cast<unsigned>(pieces_of(beg, end)));
          const int h = static_cast<int>(old >> 32);
          if (h < kHubCap) {
            a.hubs[2 * h] = u;
            a.hubs[2 * h + 1] = static_cast<int>(old & 0xffffffffu);
            end = beg;                 // its pieces: hub_kernel
          }
        }
        if (!mark && end > beg) xu = Op::load(__ldg(a.vals + u));
      }
      walk_positions<kPushUnroll>(
          beg, end, table,
          [&](const int (&pos)[kPushUnroll], const int (&owner)[kPushUnroll]) {
            if (mark) {
              mark_window(a, pos, owner);
            } else {
              push_window<Op>(a, pos, owner, xu);
            }
          });
    }
  }
}

// Push or touched, part 2: the pieces of the listed hubs, numbered 0 ..
// P-1 in list order, cut into one contiguous run per warp of the grid;
// a warp finds the hub of its first piece by binary search and walks on.
template <typename Op>
__global__ void __launch_bounds__(kThreads) hub_kernel(const Sweep a) {
  using T = typename Op::T;
  const int route = decide(a);
  if (route == kDense) return;
  const bool mark = route == kTouched;
  const unsigned long long ctr = __ldg(a.hub_ctr);
  const int listed = min(static_cast<int>(ctr >> 32), kHubCap);
  if (listed == 0) return;
  long long total = static_cast<long long>(ctr & 0xffffffffu);
  if (static_cast<int>(ctr >> 32) > kHubCap) {   // pieces of listed hubs only
    const int u = a.hubs[2 * (kHubCap - 1)];
    total = a.hubs[2 * (kHubCap - 1) + 1] +
            pieces_of(__ldg(a.out_off + u), __ldg(a.out_off + u + 1));
  }
  const int lane = threadIdx.x & 31;
  const long long gw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long n_gw = gridDim.x * kWarpsPerBlock;
  const int p0 = static_cast<int>(total * gw / n_gw);
  const int p1 = static_cast<int>(total * (gw + 1) / n_gw);
  if (p0 >= p1) return;                 // uniform across the warp
  int lo = 0, hi = listed - 1;          // the last hub whose first piece <= p0
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.hubs[2 * mid + 1] <= p0) lo = mid; else hi = mid - 1;
  }
  int h = lo, u = a.hubs[2 * h], first = a.hubs[2 * h + 1];
  int next = h + 1 < listed ? a.hubs[2 * h + 3] : static_cast<int>(total);
  int beg = __ldg(a.out_off + u), end = __ldg(a.out_off + u + 1);
  T xu = mark ? Op::ident() : Op::load(__ldg(a.vals + u));
  for (int p = p0; p < p1; ++p) {
    while (p >= next) {                 // uniform: the next hub
      ++h;
      u = a.hubs[2 * h];
      first = next;
      next = h + 1 < listed ? a.hubs[2 * h + 3] : static_cast<int>(total);
      beg = __ldg(a.out_off + u);
      end = __ldg(a.out_off + u + 1);
      if (!mark) xu = Op::load(__ldg(a.vals + u));
    }
    const int e0 = beg + (p - first) * kPiece;
    int pos[kPushUnroll], owner[kPushUnroll];
#pragma unroll
    for (int k = 0; k < kPushUnroll; ++k) {
      pos[k] = e0 + 32 * k + lane;
      owner[k] = pos[k] < end ? lane : -1;
    }
    if (mark) {
      mark_window(a, pos, owner);
    } else {
      push_window<Op>(a, pos, owner, xu);
    }
  }
}

// Push, last: out[v] = min(vals[v], best[v]) on the integer bits, best
// reset to the identity, the changed map (compared in the combine's own
// type) and both counts.  One warp per word, grid-stride.
template <typename Op>
__global__ void __launch_bounds__(kThreads) compare_kernel(const Sweep a) {
  if (decide(a) != kPush) return;
  record(a, kPush);
  __shared__ int block_changed, block_edges;
  if (threadIdx.x == 0) {
    block_changed = 0;
    block_edges = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int changed_sum = 0, edges_sum = 0;
  for (int word = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       word < a.n_words; word += gridDim.x * kWarpsPerBlock) {
    const int v = word * 32 + lane;
    const int32_t x = a.vals[v];
    const int32_t b = a.best[v];
    const int32_t o = b < x && v < a.n ? b : x;
    a.out[v] = o;
    if (b != Op::kIdentBits) a.best[v] = Op::kIdentBits;
    const bool changed = v < a.n && Op::load(x) > Op::load(o);
    const uint32_t cw = __ballot_sync(kFull, changed);
    if (changed)
      edges_sum += __ldg(a.out_off + v + 1) - __ldg(a.out_off + v);
    if (lane == 0) {
      a.chout[word] = cw;
      changed_sum += __popc(cw);
    }
  }
  changed_sum = warp_sum(changed_sum);
  edges_sum = warp_sum(edges_sum);
  if (lane == 0 && changed_sum != 0) {
    atomicAdd(&block_changed, changed_sum);
    atomicAdd(&block_edges, edges_sum);
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_changed != 0) {
    atomicAdd(a.counts, block_changed);
    atomicAdd(a.counts + 1, block_edges);
  }
}

// The set bits of ch (the padding's too) and the out-edge total of the
// active sources, into result (2,), which comes zeroed.  One thread per word; a run of set bits costs two
// offset loads.
__global__ void __launch_bounds__(kThreads)
stats_kernel(const int32_t* __restrict__ out_off,
             const uint32_t* __restrict__ ch, int32_t* result, int n,
             int n_words) {
  __shared__ int s_count, s_edges;
  if (threadIdx.x == 0) {
    s_count = 0;
    s_edges = 0;
  }
  __syncthreads();
  int count = 0, edges = 0;
  for (int word = blockIdx.x * kThreads + threadIdx.x; word < n_words;
       word += gridDim.x * kThreads) {
    const uint32_t all = __ldg(ch + word);
    uint32_t f = all & valid_bits(word, n);
    count += __popc(all);             // padding bits too: `any(ch != 0)`
    while (f != 0u) {
      const int b = __ffs(f) - 1;
      const uint32_t run = ~(f >> b);    // the set run from bit b
      const int len = run == 0u ? 32 - b : __ffs(run) - 1;
      const int u = word * 32 + b;
      edges += __ldg(out_off + u + len) - __ldg(out_off + u);
      f &= len + b >= 32 ? 0u : ~0u << (len + b);
    }
  }
  count = warp_sum(count);
  edges = warp_sum(edges);
  if ((threadIdx.x & 31) == 0 && count != 0) {
    atomicAdd(&s_count, count);
    atomicAdd(&s_edges, edges);
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_count != 0) {
    atomicAdd(result, s_count);
    atomicAdd(result + 1, s_edges);
  }
}

// Blocks of `kernel` that fit on the card at once, asked once per kernel
// and device.
cudaError_t resident_blocks(const void* kernel, int* blocks) {
  constexpr int kCache = 16;
  static const void* fn[kCache] = {};
  static int dev_of[kCache], value[kCache];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i) {
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
  const int i = used < kCache ? used++ : 0;
  fn[i] = kernel;
  dev_of[i] = dev;
  value[i] = *blocks;
  return cudaSuccess;
}

int capped(int want, int cap) { return want < 1 ? 1 : (want < cap ? want : cap); }

template <typename Op>
cudaError_t launch(const Sweep& a, bool run_stats, cudaStream_t s) {
  const int r = a.route;
  cudaError_t err;
  int cap = 0;
  if (run_stats) {
    err = resident_blocks(reinterpret_cast<const void*>(stats_kernel), &cap);
    if (err != cudaSuccess) return err;
    stats_kernel<<<capped((a.n_words + kThreads - 1) / kThreads, cap),
                   kThreads, 0, s>>>(a.out_off, a.ch,
                                     const_cast<int32_t*>(a.stats), a.n,
                                     a.n_words);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (r != kDense) {
    err = resident_blocks(reinterpret_cast<const void*>(scatter_kernel<Op>),
                          &cap);
    if (err != cudaSuccess) return err;
    scatter_kernel<Op><<<capped((a.n_words + kWarpsPerBlock - 1) /
                                    kWarpsPerBlock, cap),
                         kThreads, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = resident_blocks(reinterpret_cast<const void*>(hub_kernel<Op>), &cap);
    if (err != cudaSuccess) return err;
    hub_kernel<Op><<<cap, kThreads, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (r != kPush) {
    // the chunks, and on a known touched route the words, grid-stride
    // over at most the blocks that fit at once: a block per 8 chunks
    // would launch tens of thousands of blocks that a thin sweep skips
    err = resident_blocks(reinterpret_cast<const void*>(pull_kernel<Op>),
                          &cap);
    if (err != cudaSuccess) return err;
    Sweep b = a;
    b.chunk_blocks = a.n_chunks > 0
        ? capped((a.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock, cap) : 0;
    const int word_blocks = (a.n_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
    pull_kernel<Op><<<b.chunk_blocks +
                          (r == kTouched ? capped(word_blocks, cap)
                                         : word_blocks),
                      kThreads, 0, s>>>(b);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (a.n_long > 0) {
      finish_kernel<Op><<<capped((a.n_long + kWarpsPerBlock - 1) /
                                     kWarpsPerBlock, cap),
                          kThreads, 0, s>>>(b);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  if (Op::kTracks && (r == kAuto || r == kPush)) {
    err = resident_blocks(reinterpret_cast<const void*>(compare_kernel<Op>),
                          &cap);
    if (err != cudaSuccess) return err;
    compare_kernel<Op><<<capped((a.n_words + kWarpsPerBlock - 1) /
                                    kWarpsPerBlock, cap),
                         kThreads, 0, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Ints of a stepper's scratch for n_words destination words: the header,
// the touched map and the hub list.
extern "C" int gt_value_scratch_ints(int n_words) {
  return kHead + 2 * touched_ints(n_words) + 2 * kHubCap;
}

// The active sources of the word map ch (n_words words over n vertices)
// and their out-edge total under the out-offsets out_off, into result
// (2 ints), on `stream`.  Returns the cudaError_t (0 on success).
extern "C" int gt_value_stats(const void* out_off, const void* ch,
                              void* result, int n, int n_words,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(result, 0, 2 * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int cap = 0;
  err = resident_blocks(reinterpret_cast<const void*>(stats_kernel), &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<<<capped((n_words + kThreads - 1) / kThreads, cap), kThreads,
                 0, s>>>(static_cast<const int32_t*>(out_off),
                         static_cast<const uint32_t*>(ch),
                         static_cast<int32_t*>(result), n, n_words);
  return static_cast<int>(cudaGetLastError());
}

// Launches one sweep on `stream`.  p (pointers): 0 offsets, 1 in_src,
// 2 CSC weights, 3 out_off, 4 out_dst, 5 out-order weights, 6 ch, 7 vals,
// 8 out, 9 chout, 10 counts (2 ints: n_changed and the changed vertices'
// out-edges; zeroed by the sweep), 11 the stats of ch (2 ints: the counts
// the previous sweep returned) or null, 12 scratch (gt_value_scratch_ints
// ints, zeroed when made; kHead ints for a stepper whose every sweep is
// dense), 13 best (all identity) or null, 14 tally (4 ints),
// 15 chunk_begin, 16 chunk_end, 17 chunk_v, 18 long_v, 19 long_chunk,
// 20 partials.  iv (ints): 0 n, 1 n_words, 2 n_chunks, 3 n_long,
// 4 long_degree, 5 op (0 min f32, 1 min i32, 2 add f32), 6 flags,
// 7 route (0 auto, 1 dense, 2 push, 3 touched), 8 the push limit and
// 9 the touched limit (auto: push while the active out-edges are fewer
// than the first, else touched while fewer than the second, else dense),
// 10 the scratch set this sweep uses if it is not dense (0 or 1; the
// caller flips it after each such sweep).  Weights and the kConstW flag
// apply to the f32 combines only; `ch` may be null unless kUseActive is
// set.  The vertices with more than `long_degree` in-edges are `long_v`
// (ascending); long vertex i owns chunks long_chunk[i] ..
// long_chunk[i+1]-1, chunk c being the in-edges [chunk_begin[c],
// chunk_end[c]) of vertex chunk_v[c].  Returns the cudaError_t of the
// launches (0 on success); the caller raises on any other value.
extern "C" int gt_value_sweep(void* const* p, const int* iv,
                              float const_w, void* stream) {
  Sweep a{};
  a.offsets = static_cast<const int32_t*>(p[0]);
  a.in_src = static_cast<const int32_t*>(p[1]);
  a.w = static_cast<const float*>(p[2]);
  a.out_off = static_cast<const int32_t*>(p[3]);
  a.out_dst = static_cast<const int32_t*>(p[4]);
  a.out_w = static_cast<const float*>(p[5]);
  a.ch = static_cast<const uint32_t*>(p[6]);
  a.vals = static_cast<const int32_t*>(p[7]);
  a.out = static_cast<int32_t*>(p[8]);
  a.chout = static_cast<uint32_t*>(p[9]);
  a.counts = static_cast<int32_t*>(p[10]);
  a.scratch = static_cast<int32_t*>(p[12]);
  a.best = static_cast<int32_t*>(p[13]);
  a.tally = static_cast<int32_t*>(p[14]);
  a.chunk_begin = static_cast<const int32_t*>(p[15]);
  a.chunk_end = static_cast<const int32_t*>(p[16]);
  a.chunk_v = static_cast<const int32_t*>(p[17]);
  a.long_v = static_cast<const int32_t*>(p[18]);
  a.long_chunk = static_cast<const int32_t*>(p[19]);
  a.partials = static_cast<int32_t*>(p[20]);
  a.n = iv[0];
  a.n_words = iv[1];
  a.n_chunks = iv[2];
  a.n_long = iv[3];
  a.long_degree = iv[4];
  const int op = iv[5];
  a.flags = iv[6];
  a.route = iv[7];
  a.push_limit = iv[8];
  a.touched_limit = iv[9];
  a.const_w = const_w;
  const bool sparse = a.route != kDense;
  const bool gated = (a.flags & kUseActive) != 0;
  if (a.route < kAuto || a.route > kTouched || op < 0 || op > 2 ||
      (gated && a.ch == nullptr) ||
      (op == 1 && (a.w != nullptr || (a.flags & kConstW))) ||
      a.long_degree < kLaneDegree || a.n_words % 32 != 0 ||
      a.scratch == nullptr || a.tally == nullptr ||
      (sparse && (!gated || a.out_off == nullptr || a.out_dst == nullptr)) ||
      (a.route == kPush && (op == 2 || a.best == nullptr)) ||
      (a.route == kAuto && a.push_limit > 0 &&
       (op == 2 || a.best == nullptr)) ||
      (a.w != nullptr && a.out_w == nullptr &&
       (a.route == kPush || (a.route == kAuto && a.push_limit > 0)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int set = iv[10], next = 1 - set;
  if (set < 0 || set > 1) return static_cast<int>(cudaErrorInvalidValue);
  a.touched_n = touched_ints(a.n_words);
  a.touched = reinterpret_cast<uint32_t*>(a.scratch + kHead +
                                          set * a.touched_n);
  a.touched_next = reinterpret_cast<uint32_t*>(a.scratch + kHead +
                                               next * a.touched_n);
  a.hub_ctr = reinterpret_cast<unsigned long long*>(a.scratch + kHubCtr +
                                                    2 * set);
  a.hub_ctr_next = reinterpret_cast<unsigned long long*>(
      a.scratch + kHubCtr + 2 * next);
  a.stats_next = a.scratch + kStats + 2 * next;
  a.hubs = a.scratch + kHead + 2 * a.touched_n;
  const bool run_stats = a.route == kAuto && p[11] == nullptr;
  a.stats = run_stats ? a.scratch + kStats + 2 * set
                      : static_cast<const int32_t*>(p[11]);
  if (a.route == kAuto && a.stats == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (!sparse) {                        // a sparse sweep's scatter zeroes it
    err = cudaMemsetAsync(a.counts, 0, 2 * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (op) {
    case 0:
      err = launch<MinF32>(a, run_stats, s);
      break;
    case 1:
      err = launch<MinI32>(a, run_stats, s);
      break;
    default:
      err = launch<AddF32>(a, run_stats, s);
      break;
  }
  return static_cast<int>(err);
}
