"""A frozen plain-PyTorch copy of the mathematics of the two benchmarked
models, ``cod`` (HitNet on a texture-diffusion-prompted PVTv2-b2, arXiv
2408.09097) and ``DQnet`` (HitNet's decoder on a depth-adapter-prompted
PVTv2-b2): forward, losses, the diffusion stencil's plain version, DropPath
and AdamW with the recipe's lr multipliers.

Written from the models' equations as functions of a flat state dict whose
keys are the reference checkpoint's (``hitnet.*`` for ``cod``, the JAX
tree's for ``DQnet``). It imports only ``torch`` and ``numpy``: nothing of
the program under test, and nothing of JAX. It is the yardstick that decides
a run's ``correct``; the program never runs it.
"""
