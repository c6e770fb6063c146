"""Training on one device and the eval step (port of cpd_tpu/parallel)."""
from .trainer import (AdamOneCycle, TrainState, build_optimizer, cosine_onecycle_schedule,
                      deterministic_cudnn, init_state, make_eval_step, make_train_step,
                      onecycle_momentum_schedule, resolve_device)

__all__ = ["AdamOneCycle", "TrainState", "build_optimizer", "cosine_onecycle_schedule",
           "deterministic_cudnn", "init_state", "make_eval_step", "make_train_step",
           "onecycle_momentum_schedule", "resolve_device"]
