"""Value sweep: the Hopper kernel `csrc/value_step.cu`, its wrapper, its
plain PyTorch version and its launch counter.

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

The wrapper launches the kernel for CUDA tensors and takes the plain
version, `sweep_reference`, only for CPU tensors.  It never updates in
place: the result goes to a new or a caller-given buffer distinct from
`vals`, so every candidate reads the round-start snapshot.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.words import (pack_bitmap, unpack_bitmap,
                                             word_rows)

# Launches of the CUDA kernel; the plain version does not count.
launches = 0

MODES = ("min", "add")
LONG_DEGREE = 128   # longer in-lists are cut into chunks of this many edges
MIN_LONG_DEGREE = 32    # the kernel's lane walk covers up to 32 in-edges
I32_MAX = 2**31 - 1
# flags of csrc/value_step.cu
_USE_ACTIVE, _CONST_W = 1, 2


def _kernel_fn():
    fn = _build.load("value_step").gt_value_step
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 13 + [i32] * 7
                       + [ctypes.c_float, ptr])
        fn.restype = i32
    return fn


def _identity(mode: str, f32: bool):
    """The comb identity: +inf or INT32_MAX for min, 0 for add."""
    if mode == "min":
        return float("inf") if f32 else I32_MAX
    return 0.0 if f32 else 0


def long_lists(offsets: torch.Tensor, long_degree: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """The in-lists longer than `long_degree`, cut into chunks of at most
    `long_degree` edges: (long_v (L,) ascending vertex ids, long_chunk
    (L+1,) the first chunk of each, chunk_begin and chunk_end (C,) the
    edge range of each chunk), int32 on the device of `offsets`."""
    dev = offsets.device
    deg = (offsets[1:] - offsets[:-1]).long()
    long_v = torch.nonzero(deg > long_degree).squeeze(1)
    n_chunks = (deg[long_v] + long_degree - 1) // long_degree
    long_chunk = torch.zeros(long_v.numel() + 1, dtype=torch.int64,
                             device=dev)
    torch.cumsum(n_chunks, 0, out=long_chunk[1:])
    owner = torch.repeat_interleave(
        torch.arange(long_v.numel(), device=dev), n_chunks)
    first = offsets[long_v].long()[owner]
    begin = first + (torch.arange(owner.numel(), device=dev)
                     - long_chunk[owner]) * long_degree
    end = torch.minimum(begin + long_degree,
                        offsets[long_v + 1].long()[owner])
    return tuple(t.to(torch.int32).contiguous()
                 for t in (long_v, long_chunk, begin, end))


def sweep_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                    vals: torch.Tensor, ch: Optional[torch.Tensor], *,
                    mode: str, f32: bool,
                    weights: Optional[torch.Tensor] = None,
                    const_w: Optional[float] = None,
                    use_active: bool = True,
                    dst: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one sweep: gathers vals at every in-edge's
    source, adds the weight, masks by the source's ch bit, reduces per
    destination (`scatter_reduce` amin or sum) and compares.  Returns
    (out (n_pad,) int32 bits, changed words (rows, 128) int32,
    n_changed (1,) int32) as new tensors.  `dst` is the destination of
    each CSC edge, recomputed from `offsets` when not given."""
    n = offsets.shape[0] - 1
    n_pad = vals.shape[0]
    dtype = torch.float32 if f32 else torch.int32
    if dst is None:
        dst = torch.repeat_interleave(
            torch.arange(n, device=offsets.device),
            (offsets[1:] - offsets[:-1]).long())
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


class ValueStepper:
    """One value sweep per call over the in-edges of an n-vertex graph.

    `offsets` (n+1,) and `in_src` (m,) are the graph's CSC (the CSR of
    its transpose) as int32 tensors on the device that the sweeps run
    on; they are shared, not copied.  `weights` (m,) f32 in CSC order,
    or one `const_w`, is added to every candidate (f32 combines only).
    mode "min" | "add"; f32: values are f32 bits, else i32; use_active:
    gate candidates on the sources' ch bits.  A min sweep starts from
    vals[v] and emits the changed map; an add sweep starts from 0 and
    emits an empty one.  `long_degree` is the in-degree above which the
    card walks an in-list in chunks (a tuning knob; any value from
    MIN_LONG_DEGREE up gives the same result)."""

    def __init__(self, offsets: torch.Tensor, in_src: torch.Tensor, *,
                 mode: str, f32: bool,
                 weights: Optional[torch.Tensor] = None,
                 const_w: Optional[float] = None,
                 use_active: bool = True,
                 long_degree: int = LONG_DEGREE):
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
        if long_degree < MIN_LONG_DEGREE:
            raise ValueError(f"long_degree must be at least "
                             f"{MIN_LONG_DEGREE}")
        n = offsets.shape[0] - 1
        self.n = n
        self.rows = word_rows(n)
        self.n_words = self.rows * 128
        self.n_pad = self.n_words * 32
        self.offsets, self.in_src, self.weights = offsets, in_src, weights
        self.const_w = None if const_w is None else float(const_w)
        self.mode, self.f32 = mode, bool(f32)
        self.use_active = bool(use_active)
        self.long_degree = int(long_degree)
        self.device = offsets.device
        self._dst = None
        self._lists = None      # long_lists and their partials, on CUDA

    def edge_dst(self) -> torch.Tensor:
        """Destination of every CSC edge (for the plain version)."""
        if self._dst is None:
            self._dst = torch.repeat_interleave(
                torch.arange(self.n, device=self.device),
                (self.offsets[1:] - self.offsets[:-1]).long())
        return self._dst

    def reference(self, vals: torch.Tensor, ch: Optional[torch.Tensor]):
        """The plain version of `sweep` on the same inputs."""
        return sweep_reference(
            self.offsets, self.in_src, vals, ch, mode=self.mode,
            f32=self.f32, weights=self.weights, const_w=self.const_w,
            use_active=self.use_active, dst=self.edge_dst())

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

    def sweep(self, vals: torch.Tensor, ch: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One sweep: returns (out (n_pad,) int32 bits, changed words
        (rows, 128) int32, n_changed (1,) int32 on the device).  `out`,
        when given, receives the result and must not alias `vals`.  On
        the card the chunk partials are scratch of the stepper, so one
        stepper runs one sweep at a time (PyTorch's current stream
        orders them)."""
        global launches
        self._check(vals, ch, out)
        if vals.device.type == "cpu":
            new, chout, n_changed = self.reference(vals, ch)
            if out is None:
                return new, chout, n_changed
            out.copy_(new)
            return out, chout, n_changed
        if vals.device.type != "cuda":
            raise ValueError(f"no value kernel for device {vals.device}")
        if out is None:
            out = torch.empty_like(vals)
        if self._lists is None:
            lists = long_lists(self.offsets, self.long_degree)
            partials = torch.empty(max(lists[2].numel(), 1),
                                   dtype=torch.int32, device=self.device)
            self._lists = (*lists, partials)
        long_v, long_chunk, begin, end, partials = self._lists
        chout = torch.empty((self.rows, 128), dtype=torch.int32,
                            device=vals.device)
        n_changed = torch.empty(1, dtype=torch.int32, device=vals.device)
        op = 2 if self.mode == "add" else (0 if self.f32 else 1)
        flags = ((_USE_ACTIVE if self.use_active else 0)
                 | (_CONST_W if self.const_w is not None else 0))
        err = _kernel_fn()(
            self.offsets.data_ptr(), self.in_src.data_ptr(),
            None if self.weights is None else self.weights.data_ptr(),
            None if ch is None else ch.data_ptr(),
            vals.data_ptr(), out.data_ptr(), chout.data_ptr(),
            n_changed.data_ptr(), begin.data_ptr(), end.data_ptr(),
            long_v.data_ptr(), long_chunk.data_ptr(), partials.data_ptr(),
            self.n, self.n_words, begin.numel(), long_v.numel(),
            self.long_degree, op, flags,
            0.0 if self.const_w is None else self.const_w,
            torch.cuda.current_stream(vals.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"value_step kernel launch failed: CUDA "
                               f"error {err}")
        launches += 1
        return out, chout, n_changed

    def fixpoint(self, vals: torch.Tensor, ch: torch.Tensor, limit: int
                 ) -> Tuple[torch.Tensor, int]:
        """Sweeps from (vals, ch) until one changes nothing or `limit`
        sweeps ran, with one host read of the changed count per sweep
        and two buffers used in turn (Jacobi rounds).  Returns the final
        values and the number of sweeps, the last, unchanged one
        included (the reference's `lax.while_loop` count); 0 when `ch`
        has no set bit, since the reference tests `any(ch != 0)` before
        its first sweep."""
        if not bool(ch.any()):
            return vals, 0
        spare = torch.empty_like(vals)
        it = 0
        while it < limit:
            out, ch, n_changed = self.sweep(vals, ch, out=spare)
            vals, spare = out, vals
            it += 1
            if int(n_changed.item()) == 0:
                break
        return vals, it
