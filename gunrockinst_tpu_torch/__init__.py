"""gunrockinst_tpu_torch — the PyTorch/CUDA port of the JAX package
`gunrockinst_tpu`, which stays beside it as the reference.

The port mirrors the JAX package's module paths (graph/, ops/,
oracles/, primitives/) so that each module's counterpart is found under
the same name.  Its kernels are written by hand for NVIDIA Hopper
(csrc/, built by ops/_build.py at first use); every kernel has a plain
PyTorch version beside it, which is what runs for tensors on the CPU.

Entry points take ``device=None``, which means the CUDA card; see
`device.resolve_device`.
"""

from gunrockinst_tpu_torch.device import resolve_device  # noqa: F401
