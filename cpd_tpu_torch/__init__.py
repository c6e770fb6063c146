"""PyTorch + CUDA port of cpd_tpu for one NVIDIA Hopper GPU.

Mirrors the layout and names of ``cpd_tpu`` (``ops/``, ``models/``,
``utils/``); hand-written CUDA sources live in ``csrc/`` and are compiled at
first use into ``_build/``. This package imports torch and never jax, flax or
yaml. It currently covers the inference path of ``VoxelRCNN.predict`` with the
sparse backbone and the MM branch off.
"""
