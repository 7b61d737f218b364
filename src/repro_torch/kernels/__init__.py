"""Hand-written CUDA kernels of the port and their wrappers.

K1 ``ervs.ervs_select`` (plain and jump instances), K2
``erjs.erjs_select``, K3 ``its.its_search``, K4 ``megastep.fused_epoch``
(one instance per fused regime), K5 ``alias.alias_pick``; ``prng`` is the
Threefry generator they share with the plain versions, ``build`` compiles
and binds the sources in ``csrc/`` and keeps the launch counts.  Importing
this package builds nothing.
"""
