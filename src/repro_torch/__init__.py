"""PyTorch/CUDA port of FlexiWalker, grown slice by slice beside the JAX
package ``repro`` (the reference it is held against).

The port runs the paper's main path for every program of the registry
(``walks.WORKLOADS``):
``WalkEngine(graph, program, EngineConfig(method="adaptive")).run(starts,
num_steps)``, whose eRVS / eRJS / ITS regimes run as hand-written CUDA
kernels (``repro_torch.kernels``) on the card and as their plain PyTorch
versions on the CPU, and ``step_exec="fused"``, one fused-epoch launch
per scheduler epoch, for the fusable programs (deepwalk, ppr_nibble).
Beside the walks it serves the dense LMs of ``configs``
(``serving.generate``: decode steps against an in-place KV cache, each
step's token drawn by the hand-written Gumbel-max sampler K8).
Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for ``cuda`` where there is none raises.
"""
