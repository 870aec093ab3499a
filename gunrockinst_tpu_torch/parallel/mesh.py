"""The edge mesh: one process per rank on `torch.distributed`.

Counterpart of the JAX package's `parallel/mesh.py`.  There a 1-D
`jax.sharding.Mesh` names the devices and `shard_map` runs one body per
device; here every rank is a process that calls the same function with
the same arguments (SPMD, as under `torchrun`), and the JAX collectives
map onto the process group's:

  * the body of a `shard_map`       -> the code each rank runs on its shard
  * `jax.lax.axis_index`            -> `EdgeMesh.rank`
  * `all_gather(tiled=True)`        -> `EdgeMesh.gather` (rank order)
  * `psum` / `pmin` / `pmax`        -> `EdgeMesh.reduce` ("sum"/"min"/"max")
  * `while_loop` / `fori_loop`      -> a host loop whose condition is read
                                       from state every rank holds

`edge_mesh()` returns the handle of the initialised group, or starts a
1-rank group when there is none, so one Python session runs the tier as
the JAX package runs it on one chip.  `RankPool` starts P spawned ranks
once and runs many jobs on them (the CPU tests, and P ranks sharing one
card through gloo).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import multiprocessing.connection
import os
import pickle
import resource
import shutil
import tempfile
import time
import traceback
import tracemalloc
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from gunrockinst_tpu_torch.device import DeviceLike, resolve_device

TIMEOUT_S = 120.0           # every process group's collective timeout

# all_gather_into_tensor is deprecated where all_gather_single exists;
# both take (output, input, group)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or getattr(
    dist, "all_gather_into_tensor")
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


class EdgeMesh:
    """One rank's view of the edge mesh: its process group, rank, size
    and device.  The collectives take the device's tensors as they are:
    nccl's on the card, gloo's on the CPU or on the card (gloo copies
    CUDA tensors through host memory itself).  With `timing` on, each
    collective is bracketed by device syncs and its time added to
    `collective_s`."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.timing = False
        self.collective_s = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, call, t: torch.Tensor) -> torch.Tensor:
        if self.timing:
            self.sync()
            t0 = time.perf_counter()
        out = call(t)
        if self.timing:
            self.sync()
            self.collective_s += time.perf_counter() - t0
        return out

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The tiled all_gather: every rank's (k, ...) `t` concatenated
        in rank order, (size*k, ...), on every rank."""
        def call(x):
            x = x.contiguous()
            out = torch.empty((self.size * x.shape[0],) + x.shape[1:],
                              dtype=x.dtype, device=x.device)
            _ALL_GATHER(out, x, group=self.group)
            return out
        return self._run(call, t)

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """The elementwise sum, min or max of every rank's `t` (psum,
        pmin, pmax), on every rank; `t` is not changed."""
        def call(x):
            x = x.clone()
            dist.all_reduce(x, op=_OPS[op], group=self.group)
            return x
        return self._run(call, t)

    @property
    def path(self) -> str:
        """Which exchange path the collectives take."""
        return f"{self.backend}, {self.device.type} tensors"

    def own(self, t: torch.Tensor, k: int) -> torch.Tensor:
        """This rank's k-long slice of a replicated (size*k,) vector."""
        return t[self.rank * k: (self.rank + 1) * k]


def _backend_for(dev: torch.device, backend: Optional[str]) -> str:
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device")
    return backend


def edge_mesh(n_devices: Optional[int] = None, device: DeviceLike = None,
              backend: Optional[str] = None) -> EdgeMesh:
    """The edge mesh of this process.  Inside an initialised process
    group it is that group (whose size `n_devices`, if given, must
    equal); with none it starts a 1-rank group in this process.
    `device=None` is the CUDA card (see `resolve_device`); the backend
    is nccl for CUDA and gloo for the CPU, and `backend="gloo"` on CUDA
    puts several ranks on one card."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"edge_mesh({n_devices}) outside a process group: start "
                "the ranks first (RankPool, torchrun)")
        name = _backend_for(dev, backend)
        dist.init_process_group(
            name, store=dist.HashStore(), rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"edge_mesh({n_devices}) in a group of {size} "
                         "ranks")
    name = dist.get_backend()
    if backend is not None and backend != name:
        raise ValueError(f"the process group runs {name}, not {backend}")
    _backend_for(dev, name)
    return EdgeMesh(dist.group.WORLD, dist.get_rank(), size, dev, name)


def timed(mesh: EdgeMesh, fn: Callable, *args, **kwargs):
    """Runs `fn(*args, **kwargs)` twice: a warm-up with the collectives
    timed (each bracketed by device syncs), then a call timed by the
    host clock and ended by a device sync.  Returns (the timed call's
    result, its wall ms, the warm-up's ms inside collectives, the
    warm-up's wall ms)."""
    mesh.timing, mesh.collective_s = True, 0.0
    try:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        mesh.sync()
        wall_warm = (time.perf_counter() - t0) * 1e3
    finally:
        mesh.timing = False
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    mesh.sync()
    wall = (time.perf_counter() - t0) * 1e3
    return out, wall, mesh.collective_s * 1e3, wall_warm


# ---------------------------------------------------------------------
# RankPool: P spawned ranks that run many jobs
# ---------------------------------------------------------------------

class _Mesh:
    """Stands for the rank's EdgeMesh in a job's arguments."""

    def __repr__(self):
        return "MESH"


MESH = _Mesh()


@dataclasses.dataclass(frozen=True)
class Kept:
    """Stands for the value a rank keeps under `name` (`RankPool.keep`)."""
    name: str


@dataclasses.dataclass(frozen=True)
class Call:
    """A call each rank makes while it binds a job's arguments."""
    fn: Callable
    args: tuple = ()
    kwargs: dict = dataclasses.field(default_factory=dict)


def call(fn: Callable, *args, **kwargs) -> Call:
    return Call(fn, args, kwargs)


def bind(x, mesh: EdgeMesh, kept: dict):
    """`x` with MESH replaced by `mesh`, each Kept(name) by kept[name]
    and each call(...) by its result, through tuples, lists and dicts:
    how a rank reads a job's arguments."""
    if isinstance(x, _Mesh):            # MESH, or its unpickled copy
        return mesh
    if isinstance(x, Kept):
        return kept[x.name]
    if isinstance(x, Call):
        return x.fn(*bind(x.args, mesh, kept), **bind(x.kwargs, mesh, kept))
    if isinstance(x, tuple):
        return tuple(bind(v, mesh, kept) for v in x)
    if isinstance(x, list):
        return [bind(v, mesh, kept) for v in x]
    if isinstance(x, dict):
        return {k: bind(v, mesh, kept) for k, v in x.items()}
    return x


def to_host(x):
    """A job's result with every tensor as a NumPy array (dataclasses as
    dicts of their fields), so that it pickles without shared memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_host(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def memory_peaks(mesh: EdgeMesh, fn: Callable, *args, **kwargs) -> dict:
    """A job that measures the memory one call takes and drops its
    result: the peak of the NumPy buffers it held on the host (traced by
    tracemalloc), the peak of the device memory it allocated above what
    was allocated before it and what its result keeps there (None on the
    CPU), and the process's peak resident set so far, in bytes."""
    cuda = mesh.device.type == "cuda"
    if cuda:
        mesh.sync()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        base = torch.cuda.memory_allocated(mesh.device)
    tracemalloc.start()
    try:
        out = fn(*args, **kwargs)
        host = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    dev_peak = dev_kept = None
    if cuda:
        mesh.sync()
        dev_peak = torch.cuda.max_memory_allocated(mesh.device) - base
        dev_kept = torch.cuda.memory_allocated(mesh.device) - base
    del out
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return dict(host_peak=host, device_peak=dev_peak, device_kept=dev_kept,
                rss_peak=rss)


def _rank_main(rank: int, size: int, store_path: str, device: str,
               backend: Optional[str], conn) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    name = _backend_for(dev, backend)
    if dev.type == "cuda" and dev.index is None:
        # nccl takes one card per rank; gloo ranks may share one
        index = rank % torch.cuda.device_count() if name == "nccl" else 0
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    dev = resolve_device(dev)
    dist.init_process_group(
        name, store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        mesh = edge_mesh(device=dev, backend=name)
        kept: dict = {}
        while True:
            msg = conn.recv()
            if msg is None:
                break
            kind, payload = msg
            try:
                if kind == "keep":
                    key, path = payload
                    with open(path, "rb") as f:   # written by the pool
                        kept[key] = bind(pickle.load(f), mesh, kept)
                    out = None
                else:
                    fn, args, kwargs = payload
                    out = to_host(fn(*bind(args, mesh, kept),
                                     **bind(kwargs, mesh, kept)))
            except Exception:      # reported to the parent, which ends all
                conn.send(("error", traceback.format_exc()))
                continue
            conn.send(("ok", out))
    finally:
        dist.destroy_process_group()


class RankError(RuntimeError):
    """A rank raised, died or missed its deadline; the pool is closed."""


class RankPool:
    """`world_size` spawned rank processes in one process group, which
    run many jobs.  A job is a module-level function of this package
    (so a rank imports nothing else); `run` sends it to every rank and
    returns each rank's result in rank order, its tensors as NumPy
    arrays.  `MESH` in a job's arguments stands for the rank's
    `EdgeMesh`, `Kept(name)` for a value kept with `keep`, and
    `call(fn, ...)` for a call the rank makes first.

    `device=None` is the CUDA card, as for every entry point: without
    one the pool raises before it starts a rank; `device="cpu"` runs the
    ranks on the CPU.  The ranks rendezvous through a FileStore in a
    temporary directory (no TCP port), use one thread each, and their
    group has a collective timeout.  `run` and `keep` wait at most
    `deadline_s` seconds; when a rank raises, dies or misses the
    deadline, every rank is ended and RankError carries the rank's
    traceback.  Use it as a context manager: closing leaves no process
    behind."""

    def __init__(self, world_size: int, device: DeviceLike = None,
                 backend: Optional[str] = None, deadline_s: float = 300.0):
        if world_size < 1:
            raise ValueError("world_size must be at least 1")
        dev = torch.device("cuda" if device is None else device)
        resolve_device(dev)        # raises when the card is absent
        _backend_for(dev, backend)
        self.size = world_size
        self.deadline_s = deadline_s
        self._keeps = 0
        self._dir = tempfile.mkdtemp(prefix="rankpool-")
        ctx = multiprocessing.get_context("spawn")
        self._conns, self._procs = [], []
        try:
            for rank in range(world_size):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_rank_main, daemon=True,
                    args=(rank, world_size, os.path.join(self._dir, "store"),
                          str(dev), backend, child))
                p.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(p)
        except BaseException:
            self.close()
            raise

    @property
    def closed(self) -> bool:
        return not self._procs

    def _exchange(self, msg) -> list:
        if self.closed:
            raise RankError("the rank pool is closed")
        for c in self._conns:
            c.send(msg)
        end = time.monotonic() + self.deadline_s
        results: list = [None] * self.size
        pending = set(range(self.size))
        while pending:
            left = end - time.monotonic()
            waits = [self._conns[r] for r in pending] + [
                self._procs[r].sentinel for r in pending]
            ready = (multiprocessing.connection.wait(waits, timeout=left)
                     if left > 0 else [])
            if not ready:
                self.close(wait_s=0)
                raise RankError(f"ranks {sorted(pending)} did not finish "
                                f"within the deadline of {self.deadline_s:g} s; "
                                "every rank was ended")
            for r in sorted(pending):
                if self._conns[r] in ready:
                    try:
                        status, value = self._conns[r].recv()
                    except EOFError:
                        status, value = "error", "the rank's pipe closed"
                    if status != "ok":
                        self.close(wait_s=0)
                        raise RankError(f"rank {r} raised; every rank was "
                                        f"ended:\n{value}")
                    results[r] = value
                    pending.discard(r)
                elif self._procs[r].sentinel in ready:
                    code = self._procs[r].exitcode
                    self.close(wait_s=0)
                    raise RankError(f"rank {r} died (exit code {code}); "
                                    "every rank was ended")
        return results

    def run(self, fn: Callable, *args, **kwargs) -> list:
        """fn(*args, **kwargs) on every rank; the results in rank order."""
        return self._exchange(("run", (fn, args, kwargs)))

    def keep(self, name: str, value: Any) -> None:
        """Has every rank keep `value` (bound as a job's arguments are)
        under `name`, for later jobs' `Kept(name)`.  The value is
        pickled once into the pool's directory, which the ranks read:
        a pipe a rank is far slower for arrays of hundreds of MB."""
        if self.closed:
            raise RankError("the rank pool is closed")
        self._keeps += 1
        path = os.path.join(self._dir, f"keep-{self._keeps}")
        with open(path, "wb") as f:
            pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            self._exchange(("keep", (name, path)))
        finally:
            if os.path.exists(path):
                os.remove(path)

    def close(self, wait_s: float = 5.0) -> None:
        """Ends every rank: asks them to stop, waits up to `wait_s`
        seconds in all, then terminates (and kills) the ones still
        running.  Safe to call twice."""
        procs, self._procs = self._procs, []
        for c in self._conns:
            try:
                c.send(None)
            except OSError:        # the rank is gone already
                pass
        end = time.monotonic() + wait_s
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 0))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        for c in self._conns:
            c.close()
        self._conns = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def mesh_check(mesh: EdgeMesh, fail_rank: int = -1, skip_rank: int = -1):
    """A job that checks the mesh: every rank's id gathered in rank order
    and summed, with the exchange path.  Rank `fail_rank` raises instead,
    and rank `skip_rank` returns without joining the collectives (its
    peers then wait in them): the pool's fault handling is tested with
    these."""
    if mesh.rank == fail_rank:
        raise RuntimeError(f"rank {mesh.rank} was asked to fail")
    if mesh.rank == skip_rank:
        return None
    ids = torch.tensor([mesh.rank], dtype=torch.int32, device=mesh.device)
    gathered = mesh.gather(ids)
    total = mesh.reduce(ids.to(torch.int64), "sum")
    return gathered.tolist(), int(total.item()), mesh.path
