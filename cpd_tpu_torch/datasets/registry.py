"""Dataset registry (port of cpd_tpu/datasets/registry.py; parity:
cpd/datasets/__init__.py:14 __all__ dict): WaymoUnsupervisedDataset and
Kitti2WaymoDataset."""
from __future__ import annotations

_REGISTRY = {}


def register_dataset(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def build_dataset(dataset_cfg, class_names, training, root_path=None, logger=None, **kw):
    name = dataset_cfg["DATASET"]
    # late import: registering the readers needs the dataset template
    if name not in _REGISTRY:
        from . import kitti, waymo_unsupervised  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown DATASET {name!r} (registered: {sorted(_REGISTRY)})")
    cls = _REGISTRY[name]
    return cls(dataset_cfg=dataset_cfg, class_names=class_names, training=training,
               root_path=root_path, logger=logger, **kw)
