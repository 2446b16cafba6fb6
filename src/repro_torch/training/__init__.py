"""Training (counterpart of ``repro.training``): AdamW, the train step and
loop, checkpoints in the JAX package's format, and the synthetic data
stream."""

from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_loop import (TrainResult, TrainStepConfig,
                                             cross_entropy, make_train_step,
                                             train)

__all__ = ["AdamW", "AdamWState", "TrainResult", "TrainStepConfig",
           "cross_entropy", "make_train_step", "train"]
