"""PyTorch/CUDA port of FlexiWalker, grown slice by slice beside the JAX
package ``repro`` (the reference it is held against).

The port runs the paper's main path for every program of the registry
(``walks.WORKLOADS``):
``WalkEngine(graph, program, EngineConfig(method="adaptive")).run(starts,
num_steps)``, whose eRVS / eRJS / ITS regimes run as hand-written CUDA
kernels (``repro_torch.kernels``) on the card and as their plain PyTorch
versions on the CPU, and ``step_exec="fused"``, one fused-epoch launch
per scheduler epoch, for the fusable programs (deepwalk, ppr_nibble).
Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for ``cuda`` where there is none raises.
"""
