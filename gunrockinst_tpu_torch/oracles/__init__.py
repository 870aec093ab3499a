"""NumPy oracles: the ground truth the port is checked against."""

from gunrockinst_tpu_torch.oracles.traversal import bfs_reference  # noqa: F401
