"""The port's op substrate: geometry, rotated IoU and NMS, box coders, RoI
pooling, voxelization, sparse convolution and the CUDA kernels' wrappers."""
from . import box_coders, geometry, iou3d, nms, roipool  # noqa: F401
