"""PyTorch + CUDA port of cpd_tpu for one NVIDIA Hopper GPU.

Mirrors the layout and names of ``cpd_tpu`` (``ops/``, ``models/``,
``utils/``, ``parallel/``); hand-written CUDA sources live in ``csrc/`` and
are compiled at first use into ``_build/``. This package imports torch and
never jax, flax or yaml. It covers the inference path ``VoxelRCNN.predict``
(sparse or dense backbone tail), the training step (``VoxelRCNN.loss_step``
with the MM branch, and the adam_onecycle trainer of ``parallel``) on one
device, and the gather-formulation probes (``probes/``, kernels G1-G4 of
``ops/gather_probes.py``).
"""
