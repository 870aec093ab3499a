"""Device resolution for the port's entry points.

``device=None`` means the CUDA card.  Without a card the entry points
raise instead of carrying on quietly on the CPU; the CPU runs only when
the caller asks for it (``device="cpu"``), and then every kernel
wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

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
