from .detector import VoxelRCNN, build_network  # noqa: F401
