"""PyTorch + CUDA port of cpd_tpu for one NVIDIA Hopper GPU.

Mirrors the layout and names of ``cpd_tpu`` (``ops/``, ``models/``,
``utils/``, ``parallel/``, ``datasets/``, ``evaluation/``, ``config.py``);
hand-written CUDA sources live in ``csrc/`` and are compiled at first use
into ``_build/``. This package imports torch and never jax, flax or yaml
(``utils/yaml_subset.py`` reads the configs). It covers the inference path
``VoxelRCNN.predict`` (sparse or dense backbone tail), the evaluation entry
point ``python -m cpd_tpu_torch.tools.test`` (yaml config, ``build_network``,
``.pth`` checkpoints, the Waymo data layer, AP), the training step
(``VoxelRCNN.loss_step`` with the MM branch, and the adam_onecycle trainer of
``parallel``) on one device or data-parallel over ranks (``parallel.comm``),
and the gather-formulation probes (``probes/``, kernels G1-G4 of
``ops/gather_probes.py``).
"""
