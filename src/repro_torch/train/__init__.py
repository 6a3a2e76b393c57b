"""Training of the port (``repro/train``): the step and its fault-tolerant
loop, gradient compression, pipeline parallelism, straggler policy."""
from .trainer import TrainConfig, Trainer, make_train_step  # noqa: F401
from . import compress, pipeline, straggler  # noqa: F401
