"""Data parallelism and spatially sharded diffusion over ``torch.distributed``
(counterpart of ``dgtd_tpu/parallel/``): ``dist.py`` starts the process
group and holds the ranks' collectives, ``spatial.py`` runs the diffusion
stencil on H-shards with a halo exchange, ``space.py`` is the data×space
layout that serves a model with every activation H-banded."""
