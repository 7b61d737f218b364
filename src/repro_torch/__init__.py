"""PyTorch/CUDA port of FlexiWalker, grown slice by slice beside the JAX
package ``repro`` (the reference it is held against).

This slice ports the paper's main path for the ``node2vec`` and
``deepwalk`` programs:
``WalkEngine(graph, program, EngineConfig(method="adaptive")).run(starts,
num_steps)``, whose eRVS / eRJS / ITS regimes run as hand-written CUDA
kernels (``repro_torch.kernels``) on the card and as their plain PyTorch
versions on the CPU.  Entry points run on ``cuda`` unless the caller asks
for ``cpu``; asking for ``cuda`` where there is none raises.
"""
