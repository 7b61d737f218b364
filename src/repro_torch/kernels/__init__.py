"""Hand-written CUDA kernels of the port and their wrappers.

K1 ``ervs.ervs_select`` (plain and jump instances), K2
``erjs.erjs_select``, K3 ``its.its_search``, K4 ``megastep.fused_epoch``
(one instance per fused regime), K5 ``alias.alias_pick``; the standalone
ops in ``ops`` — on the tile-aligned layout K6 ``ervs_select``, K7
``erjs_select`` and the aligned entries of K3 and K5, and over LM logits
K8 ``token_sample`` (``token_sampler``) — with their plain versions in
``ref``; ``prng`` is the Threefry generator they share with the plain
versions, ``build`` compiles and binds the sources in ``csrc/`` and keeps
the launch counts.  Importing this package builds nothing.
"""
