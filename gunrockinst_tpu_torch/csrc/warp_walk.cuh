// The warp-cooperative walk of 32 id lists at once, shared by the
// touched sweep (touch_sweep.cu) and the level step (mega_step.cu).
//
// Each lane owns one list, ids [cur, lim) of `src` (none when cur >=
// lim).  The warp walks the open lists (ids left, no hit yet) together
// in steps of 32 * kUnroll positions: each open list gets an equal quota
// of the step (kStep / open lists, at least kUnroll), the quotas are laid
// end to end, and lane l reads positions l, l + 32, ... of that range,
// all kUnroll loads in flight before any id is visited.  So the first
// step probes the first few ids of every list at once, and later steps
// give the lists still open larger quotas.  A position finds its list
// through the window's head bits (one warp OR-reduction) and `table`,
// the warp's 32 entries of shared memory.  Then `prep()` runs once (the
// touched sweep waits there for its staged frontier), and `visit(ids,
// owner)` sees the step's ids (owner -1: no id) and returns the lanes
// whose lists it hit, as a mask; a hit closes its list.  Returns the
// mask of the lanes whose lists were hit.  Every lane of the warp calls
// it, with its own list.

#pragma once

#include <cstdint>

namespace warp_walk {

constexpr unsigned kFull = 0xffffffffu;

template <int kUnroll, typename Prep, typename Visit>
__device__ __forceinline__ uint32_t walk_lists(const int32_t* __restrict__ src,
                                               int cur, int lim, int2* table,
                                               Prep&& prep, Visit&& visit) {
  constexpr int kStep = 32 * kUnroll;
  const int lane = threadIdx.x & 31;
  const unsigned upto = kFull >> (31 - lane);    // lanes 0..lane
  const unsigned below = upto >> 1;              // lanes 0..lane-1
  uint32_t found = 0;
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
    uint32_t ids[kUnroll];
    int owner[kUnroll];
    int before = 0;                   // lists that start in earlier windows
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int w0 = 32 * k;
      const uint32_t heads = __reduce_or_sync(
          kFull, mine && first >= w0 && first < w0 + 32
                     ? 1u << (first - w0) : 0u);
      const int p = w0 + lane;
      owner[k] = -1;
      ids[k] = 0;
      if (p < total) {
        const int2 t = table[before + __popc(heads & upto) - 1];
        owner[k] = t.x;
        ids[k] = static_cast<uint32_t>(__ldg(src + t.y + p));
      }
      before += __popc(heads);
    }
    prep();
    uint32_t hit = __reduce_or_sync(kFull, visit(ids, owner));
    found |= hit;
    cur += len;
    open = __ballot_sync(kFull, mine && cur < lim && !((hit >> lane) & 1u));
    __syncwarp();                     // the table is rewritten next step
  }
  return found;
}

}  // namespace warp_walk
