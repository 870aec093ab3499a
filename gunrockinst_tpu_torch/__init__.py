"""gunrockinst_tpu_torch — the PyTorch/CUDA port of the JAX package
`gunrockinst_tpu`, which stays beside it as the reference.

The port mirrors the JAX package's module paths (graph/, ops/,
oracles/, primitives/) so that each module's counterpart is found under
the same name.  Its kernels are written by hand for NVIDIA Hopper
(csrc/, built by ops/_build.py at first use); every kernel has a plain
PyTorch version beside it, which is what runs for tensors on the CPU.

Entry points take ``device=None``, which means the CUDA card; see
`device.resolve_device`.  Each primitive's default mode runs the
operator layer (`ops/advance.py`, `filter.py`, `frontier.py`,
`priority.py`, `segment.py`) on a padded `DeviceGraph`, as the
reference's default XLA modes do.  The host surfaces are `api.py` (raw
CSR arrays in, NumPy arrays out), `cli.py` (`python -m
gunrockinst_tpu_torch.cli`) and `utils/` (its flags; the INST layer's
tracer, stepped searches and checkpoints).
"""

from gunrockinst_tpu_torch.device import resolve_device  # noqa: F401
from gunrockinst_tpu_torch.graph.csr import CsrGraph, DeviceGraph  # noqa: F401
from gunrockinst_tpu_torch.graph.market import load_market  # noqa: F401
from gunrockinst_tpu_torch.graph.rmat import rmat_graph  # noqa: F401
from gunrockinst_tpu_torch.graph.lattice import grid_graph  # noqa: F401
