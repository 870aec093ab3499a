// The min-id predecessor pass of BFS and SSSP, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package builds its post-hoc preds with
// XLA's scatter-min, and the port ran the same chain of library ops
// (`ops/preds.py::min_preds_reference`: a destination per CSC edge,
// per-edge gathers, `index_reduce_` "amin").  For every search id v < n
// and the CSC (offsets, in_src):
//
//   pred(v)  = min { input_id[u] : u in in_src[offsets[v]:offsets[v+1]],
//                                  achieves(u, v) },  -1 where none
//   out[input_id[v]] = pred(v)                     (straight into input ids)
//
// with achieves, picked by the type of the values:
//   int32 labels (BFS):   lu != INF32 && lv == lu + 1
//   f32 distances (SSSP): isfinite(du) && isfinite(dv)
//                         && du + w == dv   (one f32 add, rounded to
//                         nearest; w per edge in CSC order, or const_w)
// A vertex whose own value can have no predecessor (BFS: unreached or
// label 0, the source; SSSP: a distance that is not finite) writes -1 and
// reads none of its in-list.  BFS labels are taken to be >= 0 or INF32.
//
// What bounds it on the card: bytes.  One read of the in-lists of the
// vertices that can have a predecessor (4 B an id, plus SSSP's 4 B
// weight), the offsets, the values and the ids (4 B a vertex each), and
// one write of out: at g500-kron-s21 (63.5 M in-edges) about 0.08 ms
// for BFS and 0.16 ms for SSSP at 3.35 TB/s.  The values and the ids are
// gathered at random but fit the 50 MB L2 (8 MB each at 2 M vertices);
// the in-lists stream past it (evict-first loads).
//
// The library chain it replaces spent 7-9 ms at that size: after the
// degree sort every in-edge of a hub is one run of the same destination,
// so `index_reduce_`'s atomics had whole warps fighting over one word.
// Here no two warps combine into one word with atomics:
//   * one warp per destination word (32 consecutive vertices) walks the
//     in-lists of its vertices of at most `long_degree` in-edges laid end
//     to end, 32 * kUnroll ids a step, each lane finding the vertex of its
//     position by a search over the lanes' list starts; each lane folds
//     its run of positions of one vertex in a register and hands it to
//     that vertex's word of the warp's shared memory with one atomicMin;
//   * a longer in-list is cut into chunks of at most `chunk` ids
//     (`ops/value.py::long_lists`, built once per graph), one warp per
//     chunk; a vertex of one chunk writes its result there, the others
//     write the chunk's min to `partials`, and a second kernel, one warp
//     per vertex of several chunks, combines them and writes its result.
// Integer min is order-free, so every run gives the same bits.  An id is
// gathered only for an edge that passes the test.
//
// A second entry, gt_plane_labels, gives the BFS pass its labels where the
// search left them: it decodes a search's label planes and visited words
// (search ids, on the card) into the int32 labels the pass reads, so that
// the host's labels need not be uploaded again.  Bytes bound it too: one
// read of the planes it decodes and of the visited words (4 B a word
// each), one write of 4 B a vertex: at 2^21 vertices and 3 planes about
// 3 us at 3.35 TB/s.  One thread a vertex: the 32 lanes of a warp share
// one word, so each plane word is one broadcast load and the warp's
// labels one coalesced 128 B store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 4;               // ids in flight per lane
constexpr int kStep = 32 * kUnroll;      // positions of one walk step
constexpr unsigned kFull = 0xffffffffu;
constexpr int32_t kInf32 = 0x7fffffff;   // INF32 labels; the min's identity

struct Args {
  const int32_t* offsets;      // (n+1,) CSC offsets
  const int32_t* in_src;       // (m,) in-neighbours
  const int32_t* vals;         // (>= n,) i32 labels or f32 bits
  const float* w;              // (m,) CSC-order weights, or null
  const int32_t* input_id;     // (n,) the input id of each search id
  const int32_t* chunk_begin;  // (n_chunks,)
  const int32_t* chunk_end;    // (n_chunks,)
  const int32_t* chunk_v;      // (n_chunks,) the long vertex of each chunk
  const int32_t* long_v;       // (n_long,)
  const int32_t* long_chunk;   // (n_long+1,) the first chunk of each
  const int32_t* multi;        // (n_multi,) the long vertices (indices
                               // into long_v) with more than one chunk
  int32_t* partials;           // (n_chunks,) scratch
  int32_t* out;                // (n,) preds in input ids
  int n, n_words, n_chunks, n_multi, long_degree, chunk;
  float const_w;
};

// BFS over int32 labels.
struct Labels {
  __device__ static bool dead(int32_t lv) { return lv == kInf32 || lv == 0; }
  __device__ static bool achieves(int32_t lu, int32_t lv, const Args&,
                                  int) {
    // lu + 1 would wrap at INF32, where the first test already fails
    return lu != kInf32 &&
           static_cast<uint32_t>(lu) + 1u == static_cast<uint32_t>(lv);
  }
};

// SSSP over f32 distances (the bits of one).
__device__ __forceinline__ bool finite_bits(int32_t x) {
  return (x & 0x7f800000) != 0x7f800000;
}

struct Dists {
  __device__ static bool dead(int32_t dv) { return !finite_bits(dv); }
  __device__ static bool achieves(int32_t du, int32_t dv, const Args& a,
                                  int e) {
    const float w = a.w != nullptr ? __ldcs(a.w + e) : a.const_w;
    return finite_bits(du) &&
           __fadd_rn(__int_as_float(du), w) == __int_as_float(dv);
  }
};

// The least input id of the passing edges among this lane's positions
// e = beg + lane, beg + lane + 32, ... < end of one in-list whose owner
// holds `xv`; kInf32 where none.
template <typename P>
__device__ __forceinline__ int32_t lane_min(const Args& a, int beg, int end,
                                            int32_t xv, int lane) {
  int32_t best = kInf32;
  for (int base = beg + lane; base < end; base += kStep) {
    int32_t u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int e = base + 32 * k;
      u[k] = e < end ? __ldcs(a.in_src + e) : 0;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int e = base + 32 * k;
      if (e < end && P::achieves(__ldg(a.vals + u[k]), xv, a, e)) {
        best = min(best, __ldg(a.input_id + u[k]));
      }
    }
  }
  return best;
}

__device__ __forceinline__ void put(const Args& a, int v, int32_t best) {
  a.out[__ldg(a.input_id + v)] = best == kInf32 ? -1 : best;
}

// One warp per chunk of a long in-list.  Every lane of the warp calls it.
template <typename P>
__device__ __forceinline__ void chunk_warp(const Args& a, int c, int lane) {
  const int v = a.chunk_v[c];
  const int32_t xv = __ldg(a.vals + v);
  int32_t best = kInf32;
  if (!P::dead(xv)) {
    best = lane_min<P>(a, a.chunk_begin[c], a.chunk_end[c], xv, lane);
  }
  best = __reduce_min_sync(kFull, best);
  if (lane == 0) {
    if (a.offsets[v + 1] - a.offsets[v] <= a.chunk) {
      put(a, v, best);                    // its only chunk
    } else {
      a.partials[c] = best;
    }
  }
}

// One warp per destination word: the in-lists of its vertices of at most
// long_degree in-edges (none where the vertex is dead), laid end to end.
// Every lane of the warp calls it.
template <typename P>
__device__ __forceinline__ void word_warp(const Args& a, int word, int lane,
                                          int32_t* acc) {
  const int v = word * 32 + lane;
  const bool real = v < a.n;
  int beg = 0, deg = 0;
  int32_t xv = kInf32;
  if (real) {
    beg = a.offsets[v];
    deg = a.offsets[v + 1] - beg;
    xv = __ldg(a.vals + v);
  }
  const bool is_long = deg > a.long_degree;
  const int len = real && !is_long && !P::dead(xv) ? deg : 0;
  int incl = len;                         // inclusive scan of the lengths
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int start = incl - len;           // this lane's first position
  const int shift = beg - start;          // position -> edge
  acc[lane] = kInf32;
  __syncwarp();
  for (int base = 0; base < total; base += kStep) {   // uniform
    int e[kUnroll], owner[kUnroll];
    int32_t u[kUnroll], xo[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int p = base + 32 * k + lane;
      int o = 0;                          // the last lane starting <= p
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        if (__shfl_sync(kFull, start, o + s) <= p) o += s;
      }
      owner[k] = p < total ? o : -1;
      e[k] = p + __shfl_sync(kFull, shift, o);
      xo[k] = __shfl_sync(kFull, xv, o);
      u[k] = p < total ? __ldcs(a.in_src + e[k]) : 0;
    }
    int run_owner = -1;                   // positions rise with k, so a
    int32_t run = kInf32;                 // lane's owners never fall
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (owner[k] < 0) continue;
      if (owner[k] != run_owner) {
        if (run != kInf32) atomicMin(acc + run_owner, run);
        run_owner = owner[k];
        run = kInf32;
      }
      if (P::achieves(__ldg(a.vals + u[k]), xo[k], a, e[k])) {
        run = min(run, __ldg(a.input_id + u[k]));
      }
    }
    if (run != kInf32) atomicMin(acc + run_owner, run);
  }
  __syncwarp();
  if (real && !is_long) put(a, v, acc[lane]);
  __syncwarp();                           // acc is rewritten next word
}

// Warps [0, n_chunks): the chunks; then one warp per destination word.
template <typename P>
__global__ void __launch_bounds__(kThreads) preds_kernel(const Args a) {
  __shared__ int32_t acc[kWarpsPerBlock][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long w =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (w < a.n_chunks) {
    chunk_warp<P>(a, static_cast<int>(w), lane);
  } else if (w - a.n_chunks < a.n_words) {
    word_warp<P>(a, static_cast<int>(w - a.n_chunks), lane, acc[warp]);
  }
}

// One warp per long vertex of several chunks: the min of its chunks'
// partials.
__global__ void __launch_bounds__(kThreads) finish_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (j >= a.n_multi) return;             // uniform across the warp
  const int i = a.multi[j];
  int32_t best = kInf32;
  for (int c = a.long_chunk[i] + lane; c < a.long_chunk[i + 1]; c += 32) {
    best = min(best, a.partials[c]);
  }
  best = __reduce_min_sync(kFull, best);
  if (lane == 0) put(a, a.long_v[i], best);
}

template <typename P>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long warps =
      static_cast<long long>(a.n_chunks) + static_cast<long long>(a.n_words);
  if (warps > 0) {
    const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
    preds_kernel<P><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        a);
  }
  if (a.n_multi > 0) {
    finish_kernel<<<(a.n_multi + kWarpsPerBlock - 1) / kWarpsPerBlock,
                    kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// out[v] for every v < 32 * n_words: bits 0 .. n_bits-1 of the label
// from planes 0 .. n_bits-1 (plane b is the n_words words at b * n_words)
// where v < n and its visited bit is set, else kInf32; 0 at psrc.  Planes
// at and above n_bits are not read: they may hold anything.
__global__ void __launch_bounds__(kThreads)
plane_labels_kernel(const uint32_t* __restrict__ planes,
                    const uint32_t* __restrict__ vw, int32_t* __restrict__ out,
                    int n, int n_words, int n_bits, int psrc) {
  const long long v =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= static_cast<long long>(n_words) * 32) return;
  const int w = static_cast<int>(v >> 5);
  const int bit = static_cast<int>(v & 31);
  int32_t label = kInf32;
  if (v < n && ((__ldg(vw + w) >> bit) & 1u)) {
    uint32_t lv = 0u;
    for (int b = 0; b < n_bits; ++b) {
      lv |= ((__ldg(planes + static_cast<size_t>(b) * n_words + w) >> bit) &
             1u) << b;
    }
    label = static_cast<int32_t>(lv);
  }
  if (v == psrc) label = 0;
  out[v] = label;
}

}  // namespace

// Writes out[input_id[v]] for every v < n on `stream` (two launches at
// most; nothing is synchronised).  f32: the values are f32 distances
// (weights per edge, or const_w where w is null), else int32 labels.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int gt_min_preds(const void* offsets, const void* in_src,
                            const void* vals, const void* w,
                            const void* input_id, const void* chunk_begin,
                            const void* chunk_end, const void* chunk_v,
                            const void* long_v, const void* long_chunk,
                            const void* multi, void* partials, void* out,
                            int n, int n_chunks, int n_multi, int long_degree,
                            int chunk, int f32, float const_w, void* stream) {
  if (n < 0 || n_chunks < 0 || n_multi < 0 || long_degree < 0 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.offsets = static_cast<const int32_t*>(offsets);
  a.in_src = static_cast<const int32_t*>(in_src);
  a.vals = static_cast<const int32_t*>(vals);
  a.w = static_cast<const float*>(w);
  a.input_id = static_cast<const int32_t*>(input_id);
  a.chunk_begin = static_cast<const int32_t*>(chunk_begin);
  a.chunk_end = static_cast<const int32_t*>(chunk_end);
  a.chunk_v = static_cast<const int32_t*>(chunk_v);
  a.long_v = static_cast<const int32_t*>(long_v);
  a.long_chunk = static_cast<const int32_t*>(long_chunk);
  a.multi = static_cast<const int32_t*>(multi);
  a.partials = static_cast<int32_t*>(partials);
  a.out = static_cast<int32_t*>(out);
  a.n = n;
  a.n_words = (n + 31) / 32;
  a.n_chunks = n_chunks;
  a.n_multi = n_multi;
  a.long_degree = long_degree;
  a.chunk = chunk;
  a.const_w = const_w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(f32 ? launch<Dists>(a, s) : launch<Labels>(a, s));
}

// Writes the (32 * n_words,) int32 labels `out` of a search's label planes
// (n_bits planes of n_words words each, read) and visited words (n_words)
// on `stream` (one launch; nothing is synchronised): see
// plane_labels_kernel.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int gt_plane_labels(const void* planes, const void* vw, void* out,
                               int n, int n_words, int n_bits, int psrc,
                               void* stream) {
  if (n < 0 || n_words < 0 || static_cast<long long>(n) > 32LL * n_words ||
      n_bits < 0 || n_bits > 31 || psrc < 0 || psrc >= n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long threads = 32LL * n_words;
  if (threads > 0) {
    plane_labels_kernel<<<static_cast<unsigned>((threads + kThreads - 1) /
                                                kThreads),
                          kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(planes),
        static_cast<const uint32_t*>(vw), static_cast<int32_t*>(out), n,
        n_words, n_bits, psrc);
  }
  return static_cast<int>(cudaGetLastError());
}
