"""Min-id predecessors: the Hopper kernel `csrc/min_preds.cu`, its
wrapper, its plain PyTorch version and its launch counter.

After a BFS or SSSP search the predecessors are rebuilt from the final
values over the graph's CSC (offsets (n+1,), in_src (m,), in search
ids): for every vertex v < n

    pred[v] = least input id of the in-neighbours u with achieves(u, v),
              -1 where there is none (the oracles' min-id tie-break)

with achieves picked by the dtype of the values: int32 BFS labels,
`lu != INF32 and lv == lu + 1`; float32 SSSP distances, `isfinite(du)
and isfinite(dv) and du + w == dv` (one float32 add, w per CSC edge or
one constant).  The result comes back in input ids: `out[input_id[v]]
= pred[v]`, where `input_id` maps each search id to its input id.

No TPU kernel stands behind the pass: the JAX package's post-hoc preds
are XLA's scatter-min, which `min_preds_reference` repeats (a
destination per CSC edge, per-edge gathers, `index_reduce_` "amin").
On the card that chain took 7-9 ms at g500-kron-s21 against a byte
bound near 0.1 ms (PERF.md), most of it in `index_reduce_`'s atomics on
the hubs' words.  The kernel walks each in-list once, with no per-edge
temporary and no atomic shared between warps: in-lists of at most
`long_degree` ids by one warp per 32 consecutive vertices, longer ones
in chunks of at most `chunk` ids, one warp each, combined per vertex by
a second kernel.  The chunk plan (`value.long_lists`) and `input_id`
are built once per graph (`plan`).

The BFS labels can come from where the search left them: `plane_labels`
decodes a search's label planes and visited words, in search ids on the
device, into the int32 labels the pass reads (the second entry of
`csrc/min_preds.cu`), so that the host's labels are not uploaded again.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors; it raises on a refused launch, and counts
each launch as `launch.min_preds` or `launch.plane_labels`
(`utils/trace.py`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from gunrockinst_tpu_torch.ops import _build
from gunrockinst_tpu_torch.ops.value import MIN_LONG_DEGREE, long_lists
from gunrockinst_tpu_torch.utils import trace

INF32 = 2**31 - 1
LONG_DEGREE = MIN_LONG_DEGREE   # longer in-lists are walked in chunks ...
CHUNK = 1024                    # ... of at most this many ids


def _kernel_fn():
    fn = _build.load("min_preds").gt_min_preds
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 13 + [i32] * 6 + [ctypes.c_float, ptr]
        fn.restype = i32
    return fn


def _labels_fn():
    fn = _build.load("min_preds").gt_plane_labels
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        fn.restype = i32
    return fn


@dataclasses.dataclass
class PredsPlan:
    """What the pass needs of a graph beyond its CSC, built once:
    `input_id` (n,) int32, the input id of each search id; the in-lists
    longer than `long_degree`, cut into chunks of at most `chunk` ids
    (`value.long_lists`), with the vertex of each chunk (`chunk_v`) and
    the long vertices of more than one chunk (`multi`, indices into
    `long_v`).  All int32, on the device of the CSC."""

    n: int
    input_id: torch.Tensor
    long_degree: int
    chunk: int
    long_v: torch.Tensor
    long_chunk: torch.Tensor
    chunk_begin: torch.Tensor
    chunk_end: torch.Tensor
    chunk_v: torch.Tensor
    multi: torch.Tensor


def plan(offsets: torch.Tensor, perm: Optional[torch.Tensor] = None,
         long_degree: int = LONG_DEGREE, chunk: int = CHUNK) -> PredsPlan:
    """The plan of the CSC `offsets` (n+1,): `perm` (n,) maps each input
    id to its search id (None: the two are the same).  `long_degree` (at
    least MIN_LONG_DEGREE) and `chunk` are tuning knobs, for the smoke
    run and the tests; any values give the same result."""
    if long_degree < MIN_LONG_DEGREE:
        raise ValueError(f"long_degree must be at least {MIN_LONG_DEGREE}")
    if chunk < 1:
        raise ValueError("chunk must be at least 1")
    dev = offsets.device
    n = offsets.shape[0] - 1
    if perm is None:
        input_id = torch.arange(n, dtype=torch.int32, device=dev)
    else:
        if tuple(perm.shape) != (n,) or perm.device != dev:
            raise ValueError(f"perm must have shape ({n},) on {dev}")
        input_id = torch.empty(n, dtype=torch.int32, device=dev)
        input_id[perm.long()] = torch.arange(n, dtype=torch.int32,
                                             device=dev)
    long_v, long_chunk, begin, end = long_lists(offsets, long_degree, chunk)
    per_v = (long_chunk[1:] - long_chunk[:-1]).long()
    chunk_v = torch.repeat_interleave(long_v, per_v)
    multi = torch.nonzero(per_v > 1).squeeze(1)
    return PredsPlan(n, input_id, int(long_degree), int(chunk), long_v,
                     long_chunk, begin, end,
                     chunk_v.to(torch.int32).contiguous(),
                     multi.to(torch.int32).contiguous())


def achieves(vals: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
             weights: Optional[torch.Tensor] = None,
             const_w: Optional[float] = None) -> torch.Tensor:
    """Whether each CSC edge u->v achieves v's value: one bool per edge,
    by the dtype of `vals` (int32 labels or float32 distances)."""
    if vals.dtype == torch.int32:
        lu = vals[u]
        # lu + 1 wraps at INF32, where the first test already fails
        return (lu != INF32) & (vals[v] == lu + 1)
    du, dv = vals[u], vals[v]
    w = weights if weights is not None else torch.tensor(
        const_w, dtype=torch.float32, device=vals.device)
    return torch.isfinite(du) & torch.isfinite(dv) & (du + w == dv)


def min_preds_reference(offsets: torch.Tensor, in_src: torch.Tensor,
                        vals: torch.Tensor, input_id: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        const_w: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of the pass: an int32 destination per CSC
    edge, `achieves` over every edge, `index_reduce_` "amin" of the
    sources' input ids per destination.  Returns (n,) int32 preds in
    input ids, a new tensor."""
    n = offsets.shape[0] - 1
    u = in_src
    v = torch.repeat_interleave(offsets[1:] - offsets[:-1],
                                output_size=u.shape[0])
    preds = torch.full((n,), INF32, dtype=torch.int32, device=vals.device)
    preds.index_reduce_(0, v, torch.where(
        achieves(vals, u, v, weights, const_w), input_id[u], INF32), "amin")
    del v
    out = torch.empty_like(preds)
    out[input_id.long()] = torch.where(preds == INF32, -1, preds)
    return out


def _check(offsets, in_src, vals, p: PredsPlan, weights, const_w) -> None:
    dev = offsets.device
    n = offsets.shape[0] - 1
    for name, t in (("offsets", offsets), ("in_src", in_src)):
        if (t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
                or t.device != dev):
            raise ValueError(f"{name} must be a contiguous 1-D int32 "
                             f"tensor on {dev}")
    if vals.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"vals must be int32 labels or float32 "
                         f"distances, not {vals.dtype}")
    if (vals.dim() != 1 or vals.shape[0] < n or not vals.is_contiguous()
            or vals.device != dev):
        raise ValueError(f"vals must be a contiguous 1-D tensor of at "
                         f"least {n} values on {dev}")
    if p.n != n or p.input_id.device != dev:
        raise ValueError("the plan is not this graph's")
    if vals.dtype == torch.int32:
        if weights is not None or const_w is not None:
            raise ValueError("BFS labels take no weights")
        return
    if (weights is None) == (const_w is None):
        raise ValueError("distances take per-edge weights or const_w, "
                         "one of the two")
    if weights is not None and (
            weights.dtype != torch.float32
            or tuple(weights.shape) != tuple(in_src.shape)
            or not weights.is_contiguous() or weights.device != dev):
        raise ValueError("weights must be a contiguous f32 tensor shaped "
                         "like in_src, on its device")


def min_preds(offsets: torch.Tensor, in_src: torch.Tensor,
              vals: torch.Tensor, p: PredsPlan,
              weights: Optional[torch.Tensor] = None,
              const_w: Optional[float] = None) -> torch.Tensor:
    """(n,) int32 preds in input ids of the values `vals` (>= n,) in
    search ids: int32 BFS labels, or float32 SSSP distances with
    `weights` (m,) in CSC order or `const_w`.  The kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check(offsets, in_src, vals, p, weights, const_w)
    if offsets.device.type != "cuda":
        return min_preds_reference(offsets, in_src, vals, p.input_id,
                                   weights, const_w)
    n = p.n
    out = torch.empty(n, dtype=torch.int32, device=offsets.device)
    partials = torch.empty(p.chunk_begin.shape[0], dtype=torch.int32,
                           device=offsets.device)
    ptrs = [t.data_ptr() if t is not None else None for t in (
        offsets, in_src, vals, weights, p.input_id, p.chunk_begin,
        p.chunk_end, p.chunk_v, p.long_v, p.long_chunk, p.multi, partials,
        out)]
    err = _kernel_fn()(
        *ptrs, n, p.chunk_begin.shape[0], p.multi.shape[0], p.long_degree,
        p.chunk, int(vals.dtype == torch.float32),
        0.0 if const_w is None else float(const_w),
        _build.raw_stream(offsets.device.index))
    if err != 0:
        raise RuntimeError(f"min_preds launch failed: CUDA error {err}")
    trace.count("launch.min_preds")
    return out


def plane_labels_reference(planes: torch.Tensor, vw: torch.Tensor, n: int,
                           n_bits: int, psrc: int) -> torch.Tensor:
    """Plain PyTorch version of `plane_labels`, with `n_bits` the planes
    read."""
    n_words = vw.numel()
    shifts = torch.arange(32, dtype=torch.int32, device=vw.device)

    def bits(words):
        return ((words.reshape(-1, 1) >> shifts) & 1).reshape(-1)

    planes = planes.reshape(-1, n_words)
    labels = torch.zeros(n_words * 32, dtype=torch.int32, device=vw.device)
    for b in range(n_bits):
        labels |= bits(planes[b]) << b
    labels[bits(vw) == 0] = INF32
    labels[n:] = INF32
    labels[psrc] = 0
    return labels


def plane_labels(planes: torch.Tensor, vw: torch.Tensor, n: int, depth: int,
                 psrc: int) -> torch.Tensor:
    """(32 * n_words,) int32 BFS labels in search ids, the values
    `min_preds` takes, from a search of `depth` levels from `psrc`: its
    label planes `planes` (P*rows, 128), plane b holding bit b of each
    visited vertex's level, and its visited words `vw` (rows, 128).  Only
    the planes a level below `depth` can set are read, the first
    bit_length(max(depth, 1)) of the P (the rest may hold anything);
    INF32 where the visited bit is clear and at n and above; 0 at psrc.
    The kernel on CUDA tensors, the plain version on CPU tensors."""
    dev = vw.device
    for name, t in (("planes", planes), ("vw", vw)):
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 128
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name} must be a contiguous (k, 128) int32 "
                             f"tensor on {dev}")
    n_words = vw.numel()
    n_planes = planes.numel() // n_words if n_words else 0
    if n_planes == 0 or planes.numel() != n_planes * n_words:
        raise ValueError(f"planes of shape {tuple(planes.shape)} are not "
                         f"whole planes of {vw.shape[0]} rows")
    if not 0 <= int(psrc) < int(n) <= 32 * n_words:
        raise ValueError(f"source {psrc} of {n} vertices does not fit "
                         f"{n_words} words")
    n_bits = min(max(int(depth), 1).bit_length(), n_planes)
    if dev.type != "cuda":
        return plane_labels_reference(planes, vw, int(n), n_bits, int(psrc))
    out = torch.empty(n_words * 32, dtype=torch.int32, device=dev)
    err = _labels_fn()(planes.data_ptr(), vw.data_ptr(), out.data_ptr(),
                       int(n), n_words, n_bits, int(psrc),
                       _build.raw_stream(dev.index))
    if err != 0:
        raise RuntimeError(f"plane_labels launch failed: CUDA error {err}")
    trace.count("launch.plane_labels")
    return out
