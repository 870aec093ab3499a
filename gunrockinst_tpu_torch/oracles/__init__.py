"""NumPy oracles: the ground truth the port is checked against."""

from gunrockinst_tpu_torch.oracles.traversal import (  # noqa: F401
    bfs_reference, sssp_reference)
from gunrockinst_tpu_torch.oracles.components import (  # noqa: F401
    canonicalize_components, cc_reference)
from gunrockinst_tpu_torch.oracles.ranking import (  # noqa: F401
    hits_reference, pagerank_reference, remove_dangling_degrees,
    salsa_reference)
from gunrockinst_tpu_torch.oracles.wtf import wtf_reference  # noqa: F401
from gunrockinst_tpu_torch.oracles.centrality import (  # noqa: F401
    bc_reference, bc_reference_fast)
