"""Value sweep: the Hopper kernel `csrc/value_step.cu`, its wrapper, its
plain PyTorch versions and its launch counter.

Counterpart of the JAX package's `ops/pallas_value.py::ValueStepper`
(kernel `_make_value_kernel`, pallas_value.py:608).  One call runs one
Jacobi sweep over the in-edges of an n-vertex graph:

    cand(u->v) = vals[u] (+ w[e] or + const_w)       f32 adds
    gated      : cand counts only when bit u of ch is set (use_active)
    init       = vals[v] (min) or 0 (add)
    out[v]     = comb(init, comb over in-edges u->v of cand)
    changed[v] = init > out[v]  (min; the add sweep tracks nothing)
    n_changed  = popcount(changed)

with comb = min over f32 or i32 (identity +inf or INT32_MAX) or add
over f32 (identity 0), the three combinations the JAX callers use.
Every JAX caller ties the TPU kernel's `zero_acc` and `track_changed`
to the mode (on for add and off for min, and the other way round), so
here the mode sets them; only `use_active` is a free choice.

Values are vertex-major: an (n_pad,) int32 tensor holding f32 or i32
bits, n_pad = 32 * n_words, in place of the TPU kernel's word-row-major
layout; changed maps are word maps (`ops/words.py`).  The TPU plan
(hub/packed tiles, 4096-vertex regions, DMA super-regions, VMEM and
SMEM budgets, `value_fits`) does not carry over: the kernel reads the
graph's CSC directly, the same device CSC the BFS step kernel reads.

A sweep takes one of three routes (`ROUTES`), which give the same bits:

  * "dense": the pull over every destination word (`sweep_reference`);
  * "push" (min only): the active sources walk their out-edges and put
    each candidate into its destination with an integer atomicMin
    (`push_reference`).  The integer order of the bits is the float
    order only for non-negative floats and +inf, so an f32 stepper
    takes the push only when built with per-edge weights none of which
    is negative, -0.0 or NaN, or with a `const_w` >= +0.0
    (`push_ok`); the values it sweeps must then hold no negative, -0.0
    or NaN value either (+inf is fine), as SSSP's distances do;
  * "touched": the active sources' out-edges mark the destination words
    they reach, and the dense pull runs over those words only; every
    other word writes its init (`touched_reference`).

`choose_route` picks one from the out-edge total of the active sources
against a share of m, measured on the card (PUSH_SHARE,
TOUCHED_SHARE, TOUCHED_SHARE_ADD); an ungated sweep is always dense.
The choice costs no host round trip: a min sweep sums its changed
vertices' out-degrees beside n_changed, in one small device buffer, and
`fixpoint`, which reads n_changed once a round anyway, reads both and
picks the next route on the host; a `sweep(route=None)` on the card
decides on the card, from the counts the stepper's previous sweep left
when ch is the changed map it returned, else from a stats kernel
launched first.  `route=` forces a route, for the smoke run and the
tests only.  A route never hands a sweep to another: a failure raises.

The out-edge CSR that the push and touched routes walk is an optional
constructor argument (`out_edges`, a callable, as the BFS step kernel
takes it: `SearchGraph.reverse` for a forward sweep, the forward CSC
for a reverse one); otherwise it is built once per stepper by a stable
sort of `in_src`, which also permutes per-edge weights into out-edge
order (a stepper with per-edge weights always builds its own: a graph
of symmetric structure may carry asymmetric weights).

On the card, in-lists longer than the stepper's `long_degree` (default
LONG_DEGREE) are cut into chunks of at most that many edges
(`long_lists`, built once per stepper), walked by one warp each, and
combined per vertex in a second kernel: after degree relabeling the
first destination words hold every hub, and a warp per word would walk
millions of ids alone.

One difference at the interface: the TPU kernel skips every 4096-vertex
source region whose `ch` row is zero, in the ungated add sweep too.  The
port's ungated add sweep sums over every in-edge.  The two agree when
the values of sources whose ch bit is clear are zero, as PageRank's
contributions are, and always when every ch bit is set.

The wrapper launches the kernels for CUDA tensors and takes the plain
version of the route chosen only for CPU tensors.  It never updates in
place: the result goes to a new or a caller-given buffer distinct from
`vals`, so every candidate reads the round-start snapshot.  Each sweep
launched counts as `launch.value_step.<route>` (`utils/trace.py`;
`auto` where the card picks the route); the card also tallies them per
route and device (`route_launches`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.words import (pack_bitmap, unpack_bitmap,
                                             word_rows)
from gunrockinst_tpu_torch.utils import trace

MODES = ("min", "add")
ROUTES = ("dense", "push", "touched")
LONG_DEGREE = 128   # longer in-lists are cut into chunks of this many edges
MIN_LONG_DEGREE = 32    # the kernel's lane walk covers up to 32 in-edges
I32_MAX = 2**31 - 1
# The route rule's shares of m: a gated sweep whose active sources have
# fewer out-edges than PUSH_SHARE * m pushes (min), else fewer than
# TOUCHED_SHARE * m (min) or TOUCHED_SHARE_ADD * m (add) takes the
# touched route, else the dense one.  Measured at rmat-s20 on an H100
# (`chip_smoke.py` phase 6 and the replayed rounds of phases 7, 8 and
# 18; PERF.md): the push beat the dense pull at 9.5-10.5% of m
# and lost at 11%; the touched route beat it at 583-648 out-edges and
# lost at 2761 (0.0087% of m).
PUSH_SHARE = 0.10
TOUCHED_SHARE = 0.00005
TOUCHED_SHARE_ADD = 0.00005
# flags of csrc/value_step.cu
_USE_ACTIVE, _CONST_W = 1, 2
_AUTO = 0           # route codes: 0 auto, then ROUTES from 1
_CODES = {route: i + 1 for i, route in enumerate(ROUTES)}
_HEAD_INTS = 10     # value_step.cu's kHead: the scratch of a dense stepper

_tallies: Dict[torch.device, torch.Tensor] = {}


def _lib():
    lib = _build.load("value_step")
    if lib.gt_value_sweep.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gt_value_sweep.argtypes = [ptr, ptr, ctypes.c_float, ptr]
        lib.gt_value_sweep.restype = i32
        lib.gt_value_stats.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
        lib.gt_value_stats.restype = i32
        lib.gt_value_scratch_ints.argtypes = [i32]
        lib.gt_value_scratch_ints.restype = i32
    return lib


def _identity(mode: str, f32: bool):
    """The comb identity: +inf or INT32_MAX for min, 0 for add."""
    if mode == "min":
        return float("inf") if f32 else I32_MAX
    return 0.0 if f32 else 0


def _tally(device: torch.device) -> torch.Tensor:
    t = _tallies.get(device)
    if t is None:
        t = _tallies[device] = torch.zeros(4, dtype=torch.int32,
                                           device=device)
    return t


def route_launches() -> Dict[str, int]:
    """Sweeps launched per route on every card since the last
    `reset_route_launches`, as the card tallied them (a host sync)."""
    total = dict.fromkeys(ROUTES, 0)
    for t in _tallies.values():
        for route, count in zip(ROUTES, t[1:].tolist()):
            total[route] += count
    return total


def reset_route_launches() -> None:
    for t in _tallies.values():
        t.zero_()


def choose_route(active_edges: int, m: int, *, mode: str, gated: bool,
                 push_ok: bool) -> str:
    """The route of a sweep whose active sources have `active_edges`
    out-edges, on a graph of m edges: "push" (min, when `push_ok`) below
    PUSH_SHARE * m, else "touched" below TOUCHED_SHARE * m (min) or
    TOUCHED_SHARE_ADD * m (add), else "dense"; an ungated sweep is always
    dense.  value_step.cu's `decide` is the same rule."""
    push_limit, touched_limit = route_limits(m, mode=mode, gated=gated,
                                             push_ok=push_ok)
    if active_edges < push_limit:
        return "push"
    if active_edges < touched_limit:
        return "touched"
    return "dense"


def route_limits(m: int, *, mode: str, gated: bool,
                 push_ok: bool) -> Tuple[int, int]:
    """(push limit, touched limit) in out-edges: a sweep pushes while its
    active out-edges are fewer than the first, else takes the touched
    route while fewer than the second."""
    if not gated:
        return 0, 0
    push = int(PUSH_SHARE * m) if push_ok and mode == "min" else 0
    share = TOUCHED_SHARE if mode == "min" else TOUCHED_SHARE_ADD
    return push, max(push, int(share * m))


def long_lists(offsets: torch.Tensor, long_degree: int,
               chunk: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The in-lists longer than `long_degree`, cut into chunks of at most
    `chunk` edges (default `long_degree`): (long_v (L,) ascending vertex
    ids, long_chunk (L+1,) the first chunk of each, chunk_begin and
    chunk_end (C,) the edge range of each chunk), int32 on the device of
    `offsets`."""
    size = long_degree if chunk is None else chunk
    dev = offsets.device
    deg = (offsets[1:] - offsets[:-1]).long()
    long_v = torch.nonzero(deg > long_degree).squeeze(1)
    n_chunks = (deg[long_v] + size - 1) // size
    long_chunk = torch.zeros(long_v.numel() + 1, dtype=torch.int64,
                             device=dev)
    torch.cumsum(n_chunks, 0, out=long_chunk[1:])
    owner = torch.repeat_interleave(
        torch.arange(long_v.numel(), device=dev), n_chunks)
    first = offsets[long_v].long()[owner]
    begin = first + (torch.arange(owner.numel(), device=dev)
                     - long_chunk[owner]) * size
    end = torch.minimum(begin + size,
                        offsets[long_v + 1].long()[owner])
    return tuple(t.to(torch.int32).contiguous()
                 for t in (long_v, long_chunk, begin, end))


def edge_dst_of(offsets: torch.Tensor) -> torch.Tensor:
    """Destination of every CSC edge, int64."""
    n = offsets.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                   (offsets[1:] - offsets[:-1]).long())


def out_csr_of(offsets: torch.Tensor, in_src: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The out-edge CSR of the CSC (offsets, in_src), by a stable sort of
    in_src: (out_off (n+1,) int32, out_dst (m,) int32, order (m,) int64,
    the CSC edge id of each out-edge)."""
    n = offsets.shape[0] - 1
    order = torch.sort(in_src.long(), stable=True).indices
    counts = torch.bincount(in_src.long(), minlength=n)
    off = torch.zeros(n + 1, dtype=torch.int64, device=offsets.device)
    off[1:] = torch.cumsum(counts, 0)
    return (off.to(torch.int32),
            edge_dst_of(offsets)[order].to(torch.int32).contiguous(), order)


def active_stats(out_off: torch.Tensor, ch: torch.Tensor
                 ) -> Tuple[int, int]:
    """Plain version of the stats kernel: (the set bits of ch, padding
    included, the out-edge total of the active sources < n)."""
    n = out_off.shape[0] - 1
    bits = unpack_bitmap(ch, ch.numel() * 32)
    deg = (out_off[1:] - out_off[:-1]).long()
    return int(bits.sum()), int(deg[bits[:n]].sum())


def _out_edges_of(out_off: torch.Tensor, out_dst: torch.Tensor,
                  ch: torch.Tensor):
    """(source, destination, out-edge position) of every out-edge of the
    active sources < n, as int64 tensors."""
    n = out_off.shape[0] - 1
    act = torch.nonzero(unpack_bitmap(ch, n)).squeeze(1)
    beg, end = out_off[act].long(), out_off[act + 1].long()
    span = end - beg
    first = torch.repeat_interleave(beg - torch.cumsum(span, 0) + span,
                                    span)
    pos = first + torch.arange(first.numel(), device=ch.device)
    return (torch.repeat_interleave(act, span), out_dst[pos].long(), pos)


def sweep_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                    vals: torch.Tensor, ch: Optional[torch.Tensor], *,
                    mode: str, f32: bool,
                    weights: Optional[torch.Tensor] = None,
                    const_w: Optional[float] = None,
                    use_active: bool = True,
                    dst: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one dense sweep: gathers vals at every
    in-edge's source, adds the weight, masks by the source's ch bit,
    reduces per destination (`scatter_reduce` amin or sum) and compares.
    Returns (out (n_pad,) int32 bits, changed words (rows, 128) int32,
    n_changed (1,) int32) as new tensors.  `dst` is the destination of
    each CSC edge, recomputed from `offsets` when not given."""
    n = offsets.shape[0] - 1
    n_pad = vals.shape[0]
    dtype = torch.float32 if f32 else torch.int32
    if dst is None:
        dst = edge_dst_of(offsets)
    x = vals.view(dtype)
    src = in_src.long()
    cand = x[src]
    if weights is not None:
        cand = cand + weights
    elif const_w is not None:
        cand = cand + torch.tensor(const_w, dtype=dtype)
    ident = _identity(mode, f32)
    if use_active:
        cand = torch.where(unpack_bitmap(ch, n_pad)[src], cand,
                           torch.tensor(ident, dtype=dtype))
    red = torch.full((n_pad,), ident, dtype=dtype, device=vals.device)
    red.scatter_reduce_(0, dst.long(), cand,
                        "amin" if mode == "min" else "sum")
    if mode == "min":
        new = torch.minimum(x, red)
        changed = x > new
    else:                       # starts from 0 and tracks nothing
        new = torch.zeros_like(red) + red
        changed = torch.zeros_like(new, dtype=torch.bool)
    changed[n:] = False
    return (new.view(torch.int32), pack_bitmap(changed, n_pad // 32),
            changed.sum().to(torch.int32).reshape(1))


def push_reference(out_off: torch.Tensor, out_dst: torch.Tensor,
                   vals: torch.Tensor, ch: torch.Tensor, *, f32: bool,
                   out_w: Optional[torch.Tensor] = None,
                   const_w: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the push route of a min sweep: the
    candidates of the active sources' out-edges (the out-CSR out_off,
    out_dst; out_w the weights in out-edge order, or one const_w),
    reduced onto a copy of vals by a `scatter_reduce` amin of their int32
    bits, as the kernel's integer atomicMin does; then the changed map
    (vals > out in the values' own type).  Equal to `sweep_reference`'s
    bits when no value or weight is negative, -0.0 or NaN; not
    otherwise.  Returns (out, changed words, n_changed) as new tensors."""
    n = out_off.shape[0] - 1
    n_pad = vals.shape[0]
    dtype = torch.float32 if f32 else torch.int32
    src, dst, pos = _out_edges_of(out_off, out_dst, ch)
    cand = vals.view(dtype)[src]
    if out_w is not None:
        cand = cand + out_w[pos]
    elif const_w is not None:
        cand = cand + torch.tensor(const_w, dtype=dtype)
    out = vals.clone()
    out.scatter_reduce_(0, dst, cand.view(torch.int32), "amin")
    changed = vals.view(dtype) > out.view(dtype)
    changed[n:] = False
    return (out, pack_bitmap(changed, n_pad // 32),
            changed.sum().to(torch.int32).reshape(1))


def touched_words(out_off: torch.Tensor, out_dst: torch.Tensor,
                  ch: torch.Tensor) -> torch.Tensor:
    """(n_words,) bool: the destination words that the active sources'
    out-edges reach."""
    _, dst, _ = _out_edges_of(out_off, out_dst, ch)
    hit = torch.zeros(ch.numel(), dtype=torch.bool, device=ch.device)
    hit[dst >> 5] = True
    return hit


def touched_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                      out_off: torch.Tensor, out_dst: torch.Tensor,
                      vals: torch.Tensor, ch: torch.Tensor, *, mode: str,
                      f32: bool, weights: Optional[torch.Tensor] = None,
                      const_w: Optional[float] = None,
                      dst: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the touched route of a gated sweep: the
    dense plain version, with the words that no active source's
    out-edge reaches written to their init (vals for min, 0 for add).
    Returns (out, changed words, n_changed) as new tensors."""
    new, _, _ = sweep_reference(offsets, in_src, vals, ch, mode=mode,
                                f32=f32, weights=weights, const_w=const_w,
                                use_active=True, dst=dst)
    n = offsets.shape[0] - 1
    n_pad = vals.shape[0]
    keep = touched_words(out_off, out_dst, ch).repeat_interleave(32)
    init = vals if mode == "min" else torch.zeros_like(vals)
    new = torch.where(keep, new, init)
    dtype = torch.float32 if f32 else torch.int32
    if mode == "min":
        changed = vals.view(dtype) > new.view(dtype)
    else:
        changed = torch.zeros(n_pad, dtype=torch.bool, device=vals.device)
    changed[n:] = False
    return (new, pack_bitmap(changed, n_pad // 32),
            changed.sum().to(torch.int32).reshape(1))


class ValueStepper:
    """One value sweep per call over the in-edges of an n-vertex graph.

    `offsets` (n+1,) and `in_src` (m,) are the graph's CSC (the CSR of
    its transpose) as int32 tensors on the device that the sweeps run
    on; they are shared, not copied.  `weights` (m,) f32 in CSC order,
    or one `const_w`, is added to every candidate (f32 combines only).
    mode "min" | "add"; f32: values are f32 bits, else i32; use_active:
    gate candidates on the sources' ch bits.  A min sweep starts from
    vals[v] and emits the changed map; an add sweep starts from 0 and
    emits an empty one.  `out_edges`, when given, returns the graph's
    out-edge CSR (offsets (n+1,), destinations (m,)) as int32 tensors on
    the device, for the push and touched routes of a gated stepper
    without per-edge weights; otherwise it is built at first need.
    `long_degree` is the in-degree above which the card walks an in-list
    in chunks (a tuning knob; any value from MIN_LONG_DEGREE up gives
    the same result).

    An f32 min stepper takes the push route only when `push_ok`: built
    with per-edge weights none of which is negative, -0.0 or NaN, or
    with const_w >= +0.0.  Its sweeps' values must then hold no
    negative, -0.0 or NaN value (+inf is fine); an i32 min stepper
    pushes any values."""

    def __init__(self, offsets: torch.Tensor, in_src: torch.Tensor, *,
                 mode: str, f32: bool,
                 weights: Optional[torch.Tensor] = None,
                 const_w: Optional[float] = None,
                 use_active: bool = True,
                 long_degree: int = LONG_DEGREE,
                 out_edges: Optional[Callable[[], Tuple[torch.Tensor,
                                                        torch.Tensor]]]
                 = None):
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} is not one of {MODES}")
        for name, t in (("offsets", offsets), ("in_src", in_src)):
            if (t.dtype != torch.int32 or t.dim() != 1
                    or not t.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous 1-D int32 "
                                 "tensor")
        if in_src.device != offsets.device:
            raise ValueError("offsets and in_src lie on different devices")
        if not f32 and mode == "add":
            raise ValueError("the add sweep is f32 only")
        if not f32 and (weights is not None or const_w is not None):
            raise ValueError("weights apply to the f32 combines only")
        if weights is not None and (
                weights.dtype != torch.float32
                or tuple(weights.shape) != tuple(in_src.shape)
                or not weights.is_contiguous()
                or weights.device != offsets.device):
            raise ValueError("weights must be a contiguous f32 tensor "
                             "shaped like in_src, on its device")
        if weights is not None and const_w is not None:
            raise ValueError("give per-edge weights or const_w, not both")
        if weights is not None and out_edges is not None:
            raise ValueError("a stepper with per-edge weights builds its "
                             "own out-edge order; give no out_edges")
        if long_degree < MIN_LONG_DEGREE:
            raise ValueError(f"long_degree must be at least "
                             f"{MIN_LONG_DEGREE}")
        n = offsets.shape[0] - 1
        self.n = n
        self.m = int(in_src.shape[0])
        self.rows = word_rows(n)
        self.n_words = self.rows * 128
        self.n_pad = self.n_words * 32
        self.offsets, self.in_src, self.weights = offsets, in_src, weights
        self.const_w = None if const_w is None else float(const_w)
        self.mode, self.f32 = mode, bool(f32)
        self.use_active = bool(use_active)
        self.long_degree = int(long_degree)
        self.device = offsets.device
        self.push_ok = mode == "min" and self._pushable()
        self._out_edges = out_edges
        self._out = None        # (out_off, out_dst, out_w)
        self._dst = None
        self._state = None      # the card's buffers and call arrays
        self._set = 0           # the scratch set of the next sparse sweep
        self._last = None       # (chout, counts, stream) of the last sweep
        self._cpu_route = None

    def _pushable(self) -> bool:
        """Whether the integer atomicMin of the push is the float min on
        every candidate (the values' precondition aside)."""
        if not self.f32:
            return True
        if self.weights is not None:
            w = self.weights
            return not bool((torch.signbit(w) | torch.isnan(w)).any())
        c = self.const_w
        return c is not None and not math.isnan(c) and math.copysign(
            1.0, c) > 0

    def limits(self) -> Tuple[int, int]:
        """(push limit, touched limit): `route_limits` of this stepper."""
        return route_limits(self.m, mode=self.mode, gated=self.use_active,
                            push_ok=self.push_ok)

    def choose_route(self, active_edges: int) -> str:
        """The route of a sweep whose active sources have `active_edges`
        out-edges (`choose_route`)."""
        return choose_route(active_edges, self.m, mode=self.mode,
                            gated=self.use_active, push_ok=self.push_ok)

    def edge_dst(self) -> torch.Tensor:
        """Destination of every CSC edge (for the plain version)."""
        if self._dst is None:
            self._dst = edge_dst_of(self.offsets)
        return self._dst

    def out_csr(self) -> Tuple[torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
        """(out-offsets (n+1,), out-destinations (m,), weights in out-edge
        order (m,) or None) on the device: what the push and touched
        routes walk."""
        if self._out is None:
            if self._out_edges is not None:
                off, dst = self._out_edges()
                self._out = (off, dst, None)
            else:
                off, dst, order = out_csr_of(self.offsets, self.in_src)
                w = (None if self.weights is None
                     else self.weights[order].contiguous())
                self._out = (off, dst, w)
        return self._out

    def reference(self, vals: torch.Tensor, ch: Optional[torch.Tensor],
                  route: str = "dense"):
        """The plain version of `sweep` by `route` on the same inputs."""
        if route == "dense":
            return sweep_reference(
                self.offsets, self.in_src, vals, ch, mode=self.mode,
                f32=self.f32, weights=self.weights, const_w=self.const_w,
                use_active=self.use_active, dst=self.edge_dst())
        self._check_route(route)
        out_off, out_dst, out_w = self.out_csr()
        if route == "push":
            return push_reference(out_off, out_dst, vals, ch, f32=self.f32,
                                  out_w=out_w, const_w=self.const_w)
        return touched_reference(
            self.offsets, self.in_src, out_off, out_dst, vals, ch,
            mode=self.mode, f32=self.f32, weights=self.weights,
            const_w=self.const_w, dst=self.edge_dst())

    def _check_route(self, route: Optional[str]) -> None:
        if route is None:
            return
        if route not in ROUTES:
            raise ValueError(f"route must be one of {ROUTES} or None, not "
                             f"{route!r}")
        if route != "dense" and not self.use_active:
            raise ValueError("an ungated sweep has the dense route only")
        if route == "push" and not self.push_ok:
            raise ValueError("this stepper cannot push: the push is a min "
                             "sweep, over f32 only with per-edge weights "
                             "that are all >= +0.0 or a const_w >= +0.0")

    def _check(self, vals, ch, out):
        named = [("vals", vals)] + [(k, t) for k, t in (("ch", ch),
                                                        ("out", out))
                                    if t is not None]
        for name, t in named:
            if t.dtype != torch.int32 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous int32 "
                                 "tensor")
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the graph on "
                                 f"{self.device}")
        for name, t in (("vals", vals), ("out", out)):
            if t is not None and tuple(t.shape) != (self.n_pad,):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected ({self.n_pad},)")
        if ch is None:
            if self.use_active:
                raise ValueError("a gated sweep needs the ch word map")
        elif tuple(ch.shape) != (self.rows, 128):
            raise ValueError(f"ch has shape {tuple(ch.shape)}, expected "
                             f"({self.rows}, 128)")
        if len({t.data_ptr() for _, t in named}) != len(named):
            raise ValueError("vals, ch and out must be distinct buffers")

    def stats(self, ch: torch.Tensor) -> Tuple[int, int]:
        """(the set bits of ch, the out-edge total of its active sources)
        with one host read; on the card by the stats kernel."""
        out_off = self.out_csr()[0]
        if ch.device.type == "cpu":
            trace.count("host_read")
            return active_stats(out_off, ch)
        result = torch.empty(2, dtype=torch.int32, device=ch.device)
        err = _lib().gt_value_stats(
            out_off.data_ptr(), ch.data_ptr(), result.data_ptr(), self.n,
            self.n_words, _build.raw_stream(self.device.index))
        if err != 0:
            raise RuntimeError(f"value_step stats launch failed: CUDA "
                               f"error {err}")
        trace.count("launch.value_stats")
        count, edges = trace.d2h(result).tolist()
        return count, edges

    def last_route(self) -> str:
        """The route the last sweep took; on the card this reads the
        kernel's record (a host sync).  For the smoke run and the
        tests."""
        if self.device.type == "cpu":
            if self._cpu_route is None:
                raise RuntimeError("no sweep has run yet")
            return self._cpu_route
        if self._state is None:
            raise RuntimeError("no sweep has run yet")
        return ROUTES[int(self._state[0][0].item()) - 1]   # kRouteAt

    def sweep(self, vals: torch.Tensor, ch: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None,
              route: Optional[str] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One sweep: returns (out (n_pad,) int32 bits, changed words
        (rows, 128) int32, n_changed (1,) int32 on the device).  `out`,
        when given, receives the result and must not alias `vals`.
        `route` ("dense", "push", "touched") forces a route, for the
        smoke run and the tests; every route gives the same bits.  On
        the card the chunk partials and the route scratch belong to the
        stepper, so one stepper runs one sweep at a time (PyTorch's
        current stream orders them)."""
        new, chout, counts = self._sweep(vals, ch, out, route)
        return new, chout, counts[:1]

    def _sweep(self, vals, ch, out, route):
        """`sweep`, returning the (2,) counts: n_changed and the changed
        vertices' out-edge total (0 for add)."""
        self._check(vals, ch, out)
        self._check_route(route)
        if vals.device.type == "cpu":
            return self._cpu_sweep(vals, ch, out, route)
        if vals.device.type != "cuda":
            raise ValueError(f"no value kernel for device {vals.device}")
        return self._launch(vals, ch, out, route)

    def _cpu_sweep(self, vals, ch, out, route):
        if route is None:
            route = ("dense" if not self.use_active else
                     self.choose_route(self.stats(ch)[1]))
        new, chout, n_changed = self.reference(vals, ch, route)
        edges = 0
        if self.mode == "min" and int(n_changed):
            out_off = self.out_csr()[0]
            deg = (out_off[1:] - out_off[:-1]).long()
            edges = int(deg[unpack_bitmap(chout, self.n)].sum())
        self._cpu_route = route
        counts = torch.tensor([int(n_changed), edges], dtype=torch.int32)
        if out is None:
            return new, chout, counts
        out.copy_(new)
        return out, chout, counts

    def _setup(self):
        """The card's per-stepper buffers, made at the first sweep: the
        chunked long lists, the out-edge CSR (gated steppers), the
        scratch, the all-identity `best` of the push, and the C call's
        argument arrays with every pointer that stays the same."""
        long_v, long_chunk, begin, end = long_lists(self.offsets,
                                                    self.long_degree)
        chunk_v = torch.repeat_interleave(
            long_v, (long_chunk[1:] - long_chunk[:-1]).long()).to(
                torch.int32)
        partials = torch.empty(max(begin.numel(), 1), dtype=torch.int32,
                               device=self.device)
        lib = _lib()
        out_off = out_dst = out_w = None
        if self.use_active:
            out_off, out_dst, out_w = self.out_csr()
            ints = lib.gt_value_scratch_ints(self.n_words)
        else:
            ints = _HEAD_INTS
        scratch = torch.zeros(ints, dtype=torch.int32, device=self.device)
        best = None
        if self.push_ok:
            best = torch.full((self.n_pad,), I32_MAX, dtype=torch.int32,
                              device=self.device)
            if self.f32:
                best.fill_(0x7f800000)          # the bits of +inf

        def ptr(t):
            return 0 if t is None else t.data_ptr()

        # slots 6-11 (ch, vals, out, chout, counts, the stats of ch) and
        # ints 7 (route) and 10 (scratch set) change per call
        ptrs = (ctypes.c_void_p * 21)(
            self.offsets.data_ptr(), self.in_src.data_ptr(),
            ptr(self.weights), ptr(out_off), ptr(out_dst), ptr(out_w),
            0, 0, 0, 0, 0, 0, scratch.data_ptr(), ptr(best),
            _tally(self.device).data_ptr(), begin.data_ptr(),
            end.data_ptr(), chunk_v.data_ptr(), long_v.data_ptr(),
            long_chunk.data_ptr(), partials.data_ptr())
        push_limit, touched_limit = self.limits()
        op = 2 if self.mode == "add" else (0 if self.f32 else 1)
        flags = ((_USE_ACTIVE if self.use_active else 0)
                 | (_CONST_W if self.const_w is not None else 0))
        args = (ctypes.c_int * 11)(
            self.n, self.n_words, begin.numel(), long_v.numel(),
            self.long_degree, op, flags, _AUTO, push_limit, touched_limit,
            0)
        keep = (long_v, long_chunk, begin, end, chunk_v, partials, best)
        self._state = (scratch, keep, ptrs, args, lib.gt_value_sweep,
                       ctypes.c_float(0.0 if self.const_w is None
                                      else self.const_w))

    def _launch(self, vals, ch, out, route, chout=None, counts=None):
        """One sweep on the card into out, chout and counts (new tensors
        where not given); `route` None: decided on the card."""
        if self._state is None:
            self._setup()
        scratch, _, ptrs, args, fn, const_w = self._state
        stream = _build.raw_stream(self.device.index)
        if out is None:
            out = torch.empty_like(vals)
        if chout is None:
            chout = torch.empty((self.rows, 128), dtype=torch.int32,
                                device=self.device)
        if counts is None:
            counts = torch.empty(2, dtype=torch.int32, device=self.device)
        in_stats = 0
        if route is None and not self.use_active:
            route = "dense"
        if route is None:
            code = _AUTO
            last = self._last
            if last is not None and ch is last[0] and stream == last[2]:
                in_stats = last[1].data_ptr()   # its changed map's counts
        else:
            code = _CODES[route]
        ptrs[6] = 0 if ch is None else ch.data_ptr()
        ptrs[7] = vals.data_ptr()
        ptrs[8] = out.data_ptr()
        ptrs[9] = chout.data_ptr()
        ptrs[10] = counts.data_ptr()
        ptrs[11] = in_stats
        args[7] = code
        args[10] = self._set
        err = fn(ptrs, args, const_w, stream)
        if err != 0:
            scratch.zero_()
            self._set = 0
            raise RuntimeError(f"value_step kernel launch failed: CUDA "
                               f"error {err}")
        if code != _CODES["dense"]:
            self._set ^= 1
        trace.count(f"launch.value_step.{route or 'auto'}")
        self._last = (chout, counts, stream)
        return out, chout, counts

    def fixpoint(self, vals: torch.Tensor, ch: torch.Tensor, limit: int,
                 route: Optional[str] = None) -> Tuple[torch.Tensor, int]:
        """Sweeps from (vals, ch) until one changes nothing or `limit`
        sweeps ran, with one host read per sweep of its changed count and
        its changed vertices' out-edge total, which picks the next
        sweep's route (`route` forces one, for the smoke run and the
        tests), and two buffers used in turn (Jacobi rounds).  Returns
        the final values and the number of sweeps, the last, unchanged
        one included (the reference's `lax.while_loop` count); 0 when
        `ch` has no set bit, since the reference tests `any(ch != 0)`
        before its first sweep (the read of ch's stats, in place of that
        test, picks the first route)."""
        self._check(vals, ch, None)
        self._check_route(route)
        count, edges = self.stats(ch)
        if count == 0:
            return vals, 0
        spare = torch.empty_like(vals)
        if vals.device.type == "cpu":
            sweep = self._cpu_sweep
        else:               # two sets of outputs used in turn, no checks
            bufs = [(torch.empty((self.rows, 128), dtype=torch.int32,
                                 device=self.device),
                     torch.empty(2, dtype=torch.int32, device=self.device))
                    for _ in range(2)]

            def sweep(vals, ch, out, route):
                return self._launch(vals, ch, out, route, *bufs[it % 2])
        it = 0
        while it < limit:
            with trace.span("gt.driver.round"):
                out, ch, counts = sweep(vals, ch, spare,
                                        route or self.choose_route(edges))
                vals, spare = out, vals
                it += 1
                n_changed, edges = trace.d2h(counts).tolist()
            if n_changed == 0:
                break
        return vals, it
