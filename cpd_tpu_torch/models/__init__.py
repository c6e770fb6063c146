"""The detector stack: ``build_network`` and the models of the registry,
with the reference's two model helpers."""
import numpy as np
import torch

from .detector import VoxelRCNN, build_network  # noqa: F401


def load_data_to_device(batch, device):
    """Host batch -> tensors on ``device``: numeric and boolean arrays (and
    tensors) move, every other entry (frame ids, metadata) stays behind."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.to(device)
        elif isinstance(v, (np.ndarray, np.generic)) and v.dtype.kind in "biuf":
            out[k] = torch.as_tensor(np.asarray(v), device=device)
    return out


def model_fn_decorator(model):
    """-> fn(batch, generator=None) -> (loss, tb, disp): the model's
    ``loss_step`` in training mode on the batch moved to the model's device,
    with ``disp`` the tb entries as floats. Without a generator the RoI
    sampling draws from one seeded 0 on that device, so that a call is
    reproducible."""
    def model_func(batch, generator=None):
        device = next(model.parameters()).device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        model.train()
        loss, tb = model.loss_step(load_data_to_device(batch, device), generator=generator)
        return loss, tb, {k: float(v.detach()) for k, v in tb.items()}

    return model_func
