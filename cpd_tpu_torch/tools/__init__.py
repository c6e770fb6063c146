"""The port's command-line entry points (counterparts of ``tools/``):
``python -m cpd_tpu_torch.tools.test`` evaluates checkpoints."""
