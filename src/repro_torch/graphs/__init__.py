"""Graph substrate of the port: CSR graphs, generators, node statistics."""
from repro_torch.graphs.csr import (CSRGraph, NodeStats, dist_code,
                                    from_edges, has_edge, node_stats,
                                    row_scan)
from repro_torch.graphs.generators import (attach_weights, power_law_graph,
                                           random_graph)

__all__ = ["CSRGraph", "NodeStats", "dist_code", "from_edges", "has_edge",
           "node_stats", "row_scan", "attach_weights", "power_law_graph",
           "random_graph"]
