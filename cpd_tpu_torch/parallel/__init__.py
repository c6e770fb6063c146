"""Training on one device or data-parallel over ranks, the eval step and the
collectives (port of cpd_tpu/parallel)."""
from .trainer import (ClippedAdamW, ClippedOptimizer, ClippedSGD, TrainState, build_optimizer,
                      cosine_onecycle_schedule, deterministic_cudnn, init_state, make_eval_step,
                      make_train_step, onecycle_momentum_schedule, resolve_device,
                      step_generator)

__all__ = ["ClippedAdamW", "ClippedOptimizer", "ClippedSGD", "TrainState", "build_optimizer",
           "cosine_onecycle_schedule", "deterministic_cudnn", "init_state", "make_eval_step",
           "make_train_step", "onecycle_momentum_schedule", "resolve_device", "step_generator"]
