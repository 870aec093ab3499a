"""Multi-device execution over an edge mesh of `torch.distributed` ranks.

Counterpart of the JAX package's `parallel/`.  The preferred tier is the
WORD-EXCHANGE implementations in `dist_words`: dst-owned / src-owned
slice exchanges whose per-level traffic is the owned frontier-word or
value slices (an all_gather of n_loc/8 or n_loc*4 bytes a rank).  The
replicated-state tiers (`dist`, `dist_more`) stay importable as
fallbacks but are not re-exported here.  `mesh.RankPool` starts P ranks
in one process group; `edge_mesh()` with no group runs one rank in this
process.
"""

from gunrockinst_tpu_torch.parallel.mesh import (  # noqa: F401
    EdgeMesh, RankPool, edge_mesh)
from gunrockinst_tpu_torch.parallel.partition import (  # noqa: F401
    ShardedGraph, shard_graph)
from gunrockinst_tpu_torch.parallel.dist_words import (  # noqa: F401
    DstShardedGraph, shard_graph_by_dst,
    bfs_dist_words as bfs_dist,
    dobfs_dist_words as dobfs_dist,
    sssp_dist_words as sssp_dist,
    cc_dist_words as cc_dist,
    bc_dist_words as bc_dist,
    pagerank_dist_words as pagerank_dist,
    hits_dist_words as hits_dist,
    salsa_dist_words as salsa_dist,
    mis_dist_words as mis_dist,
    topk_dist_words as topk_dist,
    wtf_dist_words as wtf_dist,
    mst_dist_words as mst_dist,
)
