// One Jacobi sweep of a min or add combine over in-edges, for NVIDIA
// Hopper (sm_90a).
//
// Replaces: gunrockinst_tpu/ops/pallas_value.py:608 `_make_value_kernel`
// (wrapper `ValueStepper`, pallas_value.py:1013).  Same function at the
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
//
// comb is min over f32 or i32 (identity +inf or INT32_MAX) or add over
// f32 (identity 0).  The TPU kernel's zero_acc and track_changed follow
// the mode in every caller, so here the combine carries them.  Jacobi: every candidate reads `vals`, the
// round-start snapshot, and the result goes to a separate buffer `out`.
//
// Unlike the TPU kernel, the ungated add sweep sums over every in-edge:
// the TPU kernel also skips the sources of each 4096-vertex region whose
// `ch` row is zero, which changes nothing when the values of those
// sources are zero, as PageRank's contributions are.
//
// What bounds it on the card: bytes.  A sweep at rmat-s20 must read the
// ~31.4 M in-edge ids (4 B each, ~126 MB) and the CSC offsets (4 MB),
// plus the weights of the active edges when weights are per edge; the
// value and changed maps (4 MB and 135 KB) are gathered at random but
// stay in the 50 MB L2.  ~42 us at 3.35 TB/s.
// Design: in-edges are walked by three kinds of work, so that no warp
// walks much more than the others (after degree relabeling the first
// destination words hold every hub, and a first design that gave each
// word's hubs to the word's warp ran one warp over millions of ids):
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
// block for n_changed and one OR per changed long vertex into its
// changed word, after the main kernel stored it.  A gated candidate
// whose ch bit is clear never reads its value or its weight.
//
// Known slowness, left for later work: every sweep reads all in-edge
// ids, even in a min round where few sources changed (a push from the
// changed sources with an integer atomicMin on non-negative f32 bits
// would be exact); one lane walks a whole in-list of up to kLaneDegree
// ids while the other lanes of its warp may be done.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kLaneDegree = 32;   // larger in-lists are walked by the warp
constexpr int kUnroll = 4;        // ids in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// flags, as ops/value.py passes them
constexpr int kUseActive = 1;
constexpr int kConstW = 2;

// kFromZero: init is the identity, not vals[v]; kTracks: emit changed.
struct MinF32 {
  using T = float;
  static constexpr bool kFloat = true;
  static constexpr bool kFromZero = false;
  static constexpr bool kTracks = true;
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
  __device__ static T ident() { return 0.0f; }
  __device__ static T comb(T a, T b) { return __fadd_rn(a, b); }
  __device__ static T load(int32_t x) { return __int_as_float(x); }
  __device__ static int32_t bits(T x) { return __float_as_int(x); }
};

__device__ __forceinline__ bool active_bit(const uint32_t* __restrict__ ch,
                                           uint32_t u) {
  return (__ldg(ch + (u >> 5)) >> (u & 31u)) & 1u;
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

// Blocks [0, chunk_blocks): one warp per chunk of a long in-list, which
// writes the chunk's partial.  Blocks from chunk_blocks on: one warp per
// destination word, which writes out[] and the changed word of every
// vertex of the word that is not long.
template <typename Op>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
value_step_kernel(const int32_t* __restrict__ offsets,  // (n+1,) CSC offsets
                  const int32_t* __restrict__ in_src,   // (m,) in-neighbours
                  const float* __restrict__ w,          // (m,) or null
                  const uint32_t* __restrict__ ch,      // (n_words,) or null
                  const int32_t* __restrict__ vals,     // (32*n_words,)
                  int32_t* __restrict__ out,            // (32*n_words,)
                  uint32_t* __restrict__ chout,         // (n_words,)
                  int32_t* __restrict__ n_changed,      // (1,), zeroed
                  const int32_t* __restrict__ chunk_begin,  // (n_chunks,)
                  const int32_t* __restrict__ chunk_end,    // (n_chunks,)
                  int32_t* __restrict__ partials,       // (n_chunks,) out
                  int n, int n_words, int n_chunks, int chunk_blocks,
                  int long_degree, int flags, float const_w) {
  using T = typename Op::T;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    const int c = blockIdx.x * kWarpsPerBlock + warp;
    if (c < n_chunks) {                 // uniform across the warp
      const T part = warp_walk<Op>(in_src, vals, w, ch, flags, const_w,
                                   chunk_begin[c], chunk_end[c], lane);
      if (lane == 0) partials[c] = Op::bits(part);
    }
    return;                             // the whole block returns
  }

  __shared__ int block_changed;
  if (threadIdx.x == 0) block_changed = 0;
  __syncthreads();
  const int word = (blockIdx.x - chunk_blocks) * kWarpsPerBlock + warp;
  if (word < n_words) {                 // uniform across the warp
    const int v = word * 32 + lane;
    const bool real = v < n;
    int beg = 0, end = 0;
    if (real) {
      beg = offsets[v];
      end = offsets[v + 1];
    }
    const int deg = end - beg;
    const bool is_long = real && deg > long_degree;
    T acc = Op::ident();
    if (real && deg <= kLaneDegree) {
      for (int e0 = beg; e0 < end; e0 += kUnroll) {
        uint32_t u[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          u[k] = e0 + k < end ? static_cast<uint32_t>(in_src[e0 + k]) : 0u;
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          if (e0 + k < end) {
            acc = Op::comb(acc, candidate<Op>(vals, w, ch, flags, const_w,
                                              e0 + k, u[k]));
          }
        }
      }
    }
    uint32_t mid = __ballot_sync(kFull, real && deg > kLaneDegree &&
                                            !is_long);
    while (mid != 0) {                  // uniform: same mask in every lane
      const int h = __ffs(mid) - 1;
      mid &= mid - 1;
      const T part = warp_walk<Op>(in_src, vals, w, ch, flags, const_w,
                                   __shfl_sync(kFull, beg, h),
                                   __shfl_sync(kFull, end, h), lane);
      if (lane == h) acc = part;
    }
    bool changed = false;
    if (!is_long) {                     // long vertices: finish kernel
      const T init = Op::kFromZero ? Op::ident() : Op::load(vals[v]);
      const T next = Op::comb(init, acc);
      out[v] = Op::bits(next);
      changed = Op::kTracks && real && init > next;
    }
    const uint32_t cw = __ballot_sync(kFull, changed);
    if (lane == 0) {
      chout[word] = cw;
      if (cw != 0) atomicAdd(&block_changed, __popc(cw));
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_changed != 0) {
    atomicAdd(n_changed, block_changed);
  }
}

// One warp per long vertex: combines the partials of its chunks (lane l
// folds chunks l, l + 32, ... in order, then a fixed tree), then writes
// its value, ORs its changed bit into the word the main kernel stored,
// and counts it.
template <typename Op>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
value_finish_kernel(const int32_t* __restrict__ long_v,     // (n_long,)
                    const int32_t* __restrict__ long_chunk, // (n_long+1,)
                    const int32_t* __restrict__ partials,   // (n_chunks,)
                    const int32_t* __restrict__ vals,
                    int32_t* __restrict__ out,
                    uint32_t* __restrict__ chout,
                    int32_t* __restrict__ n_changed,
                    int n_long) {
  using T = typename Op::T;
  __shared__ int block_changed;
  if (threadIdx.x == 0) block_changed = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i < n_long) {                     // uniform across the warp
    T part = Op::ident();
    for (int c = long_chunk[i] + lane; c < long_chunk[i + 1]; c += 32) {
      part = Op::comb(part, Op::load(partials[c]));
    }
    part = warp_tree<Op>(part);
    if (lane == 0) {
      const int v = long_v[i];
      const T init = Op::kFromZero ? Op::ident() : Op::load(vals[v]);
      const T next = Op::comb(init, part);
      out[v] = Op::bits(next);
      if (Op::kTracks && init > next) {
        atomicOr(chout + (v >> 5), 1u << (v & 31));
        atomicAdd(&block_changed, 1);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_changed != 0) {
    atomicAdd(n_changed, block_changed);
  }
}

struct Lists {            // the chunked long in-lists (ops/value.py)
  const int32_t* chunk_begin;
  const int32_t* chunk_end;
  const int32_t* long_v;
  const int32_t* long_chunk;
  int32_t* partials;
  int n_chunks, n_long, long_degree;
};

template <typename Op>
cudaError_t launch(const void* offsets, const void* in_src, const void* w,
                   const void* ch, const void* vals, void* out, void* chout,
                   void* n_changed, const Lists& L, int n, int n_words,
                   int flags, float const_w, cudaStream_t s) {
  const int chunk_blocks = (L.n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int word_blocks = (n_words + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (chunk_blocks + word_blocks > 0) {
    value_step_kernel<Op><<<chunk_blocks + word_blocks, kWarpsPerBlock * 32,
                            0, s>>>(
        static_cast<const int32_t*>(offsets),
        static_cast<const int32_t*>(in_src), static_cast<const float*>(w),
        static_cast<const uint32_t*>(ch), static_cast<const int32_t*>(vals),
        static_cast<int32_t*>(out), static_cast<uint32_t*>(chout),
        static_cast<int32_t*>(n_changed), L.chunk_begin, L.chunk_end,
        L.partials, n, n_words, L.n_chunks, chunk_blocks, L.long_degree,
        flags, const_w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (L.n_long > 0) {
    value_finish_kernel<Op><<<(L.n_long + kWarpsPerBlock - 1) /
                                  kWarpsPerBlock,
                              kWarpsPerBlock * 32, 0, s>>>(
        L.long_v, L.long_chunk, L.partials,
        static_cast<const int32_t*>(vals), static_cast<int32_t*>(out),
        static_cast<uint32_t*>(chout), static_cast<int32_t*>(n_changed),
        L.n_long);
  }
  return cudaGetLastError();
}

}  // namespace

// Launches one sweep on `stream`.  `op`: 0 min f32, 1 min i32, 2 add
// f32.  `weights` (per edge) and the kConstW flag apply to
// the f32 combines only; `ch` may be null unless kUseActive is set.
// The vertices with more than `long_degree` in-edges are `long_v`
// (ascending); long vertex i owns chunks long_chunk[i] ..
// long_chunk[i+1]-1, chunk c being the in-edges [chunk_begin[c],
// chunk_end[c]); `partials` is scratch of one word per chunk.  Zeroes
// n_changed first.  Returns the cudaError_t of the launches (0 on
// success); the caller raises on any other value.
extern "C" int gt_value_step(const void* offsets, const void* in_src,
                             const void* weights, const void* ch,
                             const void* vals, void* out, void* chout,
                             void* n_changed, const void* chunk_begin,
                             const void* chunk_end, const void* long_v,
                             const void* long_chunk, void* partials,
                             int n, int n_words, int n_chunks, int n_long,
                             int long_degree, int op, int flags,
                             float const_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (((flags & kUseActive) && ch == nullptr) ||
      (op == 1 && (weights != nullptr || (flags & kConstW))) ||
      long_degree < kLaneDegree) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Lists L{static_cast<const int32_t*>(chunk_begin),
                static_cast<const int32_t*>(chunk_end),
                static_cast<const int32_t*>(long_v),
                static_cast<const int32_t*>(long_chunk),
                static_cast<int32_t*>(partials), n_chunks, n_long,
                long_degree};
  cudaError_t err = cudaMemsetAsync(n_changed, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (op) {
    case 0:
      err = launch<MinF32>(offsets, in_src, weights, ch, vals, out, chout,
                           n_changed, L, n, n_words, flags, const_w, s);
      break;
    case 1:
      err = launch<MinI32>(offsets, in_src, weights, ch, vals, out, chout,
                           n_changed, L, n, n_words, flags, const_w, s);
      break;
    case 2:
      err = launch<AddF32>(offsets, in_src, weights, ch, vals, out, chout,
                           n_changed, L, n, n_words, flags, const_w, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
