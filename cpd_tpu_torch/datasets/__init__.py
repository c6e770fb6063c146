"""Data layer (port of cpd_tpu/datasets): fixed-capacity sample protocol,
augmentors, the Waymo reader and the threaded loader, all NumPy on the host.

As in the JAX package, every sample is padded/truncated to static
capacities on the host and voxelization runs on the device inside the
model's forward, so the host pipeline only selects, augments and pads points.
"""
from .dataset import DatasetTemplate, collate_batch  # noqa: F401
from .loader import build_dataloader  # noqa: F401
