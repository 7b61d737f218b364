"""Walk programs of the port: the reference's whole registry."""
from repro_torch.walks.workloads import (WORKLOADS, deepwalk, make_workload,
                                         metapath, node2vec, ppr_nibble,
                                         register_workload,
                                         second_order_pagerank,
                                         visited_avoiding)

__all__ = ["WORKLOADS", "deepwalk", "make_workload", "metapath", "node2vec",
           "ppr_nibble", "register_workload", "second_order_pagerank",
           "visited_avoiding"]
