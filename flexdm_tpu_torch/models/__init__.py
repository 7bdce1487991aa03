"""The MFP model of the port: encoder, transformer blocks, decoder heads,
the task layer and the loss; the baselines in :mod:`.baselines`."""

from .mfp import MFPModel, TaskConfig, forward_eval, forward_train, make_task_config

__all__ = [
    "MFPModel", "TaskConfig", "forward_eval", "forward_train",
    "make_task_config",
]
