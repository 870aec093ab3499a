"""Where the port's tensors live: device resolution for the entry
points, and the counted copies between the host and the card.

``device=None`` means the CUDA card.  Without a card the entry points
raise instead of carrying on quietly on the CPU; the CPU runs only when
the caller asks for it (``device="cpu"``), and then every kernel
wrapper takes its plain PyTorch version.  `download` and `upload` move
an entry's results and host values across the bus through page-locked
blocks, counted as `host_read` and `copy.*_bytes` (`utils/trace.py`).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from gunrockinst_tpu_torch.utils import trace

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """torch.device for `device`, defaulting to CUDA; raises
    RuntimeError when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def download(t: torch.Tensor) -> np.ndarray:
    """`t` on the host, counted as one host read.  From a CUDA device
    the copy lands in a page-locked block of PyTorch's caching host
    allocator, so that the card's part is one DMA that does not wait on
    the host's paging, and the array returned owns that block."""
    trace.d2h(t)
    if t.device.type != "cuda":
        return t.cpu().numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array `a` on `device`, its bytes counted; to a CUDA device
    through a page-locked block, filled by NumPy (a PyTorch CPU copy
    would wake the intra-op threads, which then spin)."""
    host = torch.from_numpy(trace.h2d(a))
    if device.type != "cuda":
        return host.to(device)
    buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
    np.copyto(buf.numpy(), a)
    return buf.to(device)
