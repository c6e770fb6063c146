"""Training on one device (port of cpd_tpu/parallel)."""
from .trainer import (AdamOneCycle, TrainState, build_optimizer, cosine_onecycle_schedule,
                      deterministic_cudnn, init_state, make_train_step,
                      onecycle_momentum_schedule, resolve_device)

__all__ = ["AdamOneCycle", "TrainState", "build_optimizer", "cosine_onecycle_schedule",
           "deterministic_cudnn", "init_state", "make_train_step", "onecycle_momentum_schedule",
           "resolve_device"]
