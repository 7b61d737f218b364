"""Walk programs of the port (this slice: node2vec and deepwalk)."""
from repro_torch.walks.workloads import (WORKLOADS, deepwalk, make_workload,
                                         node2vec)

__all__ = ["WORKLOADS", "deepwalk", "make_workload", "node2vec"]
