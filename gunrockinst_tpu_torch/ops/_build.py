"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` has a plain C interface and is compiled by
one `nvcc` call for Hopper (`sm_90a`) into `_build/<name>-<hash>.so`,
where the hash covers the source text, the text of every header it
includes from `csrc/` (`#include "x.cuh"`, followed through the
headers' own includes) and the flags; the library is then loaded with
`ctypes`.  Nothing is built when the package is
imported: `load` builds at first use, and `build` starts one `nvcc`
per missing library, all at once.  A build that fails raises with
nvcc's output.  No source includes PyTorch's headers, so a build takes
seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

from gunrockinst_tpu_torch.utils import trace

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{home}/bin); the CUDA kernels cannot be built")
    return path


def sources_of(name: str) -> List[Path]:
    """`csrc/<name>.cu` and every header under `csrc/` it includes with
    `#include "..."`, directly or through another header, in the order
    first met."""
    order: List[Path] = []
    todo = [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in order:
            continue
        order.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            header = path.parent / inc
            if not header.exists():
                raise FileNotFoundError(f"{path.name} includes {inc}, "
                                        f"which is not in {path.parent}")
            todo.append(header)
    return order


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` goes, named by the hash of
    its source, the headers it includes and the flags."""
    h = hashlib.sha256()
    for path in sources_of(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, one nvcc
    process per source, all started together.  Returns each name's
    compiler output (its `-Xptxas -v` report), "" when it was cached."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    reports = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            reports[name] = ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
        trace.count("kernel.build")
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            with trace.span("gt.setup.kernel_load"):
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib
