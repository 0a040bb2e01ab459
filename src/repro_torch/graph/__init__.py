"""Graph workload of the port (the paper's third case study): power-law
graphs in CSR layout, PageRank and BFS through the segment-sum and
frontier kernels, protectable as a ``MemoryDomain`` under the regions
``graph/topology``, ``graph/rank`` and ``graph/frontier``. Counterpart of
``repro.graph``, without the reference's bit-pinning oracle backend.
"""
from repro_torch.graph.bfs import (  # noqa: F401
    bfs, bfs_eval_fn, bfs_reference, bfs_scrubbed, bfs_step,
)
from repro_torch.graph.generate import (  # noqa: F401
    CSRGraph, bucket_edges, graph_state, n_padded, node_block_of,
    powerlaw_graph,
)
from repro_torch.graph.pagerank import (  # noqa: F401
    BACKENDS, pagerank, pagerank_eval_fn, pagerank_scrubbed,
    pagerank_step, top_k,
)
