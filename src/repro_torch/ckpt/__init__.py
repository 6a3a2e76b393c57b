"""Checkpointing of the port (``repro/ckpt``)."""
from . import checkpoint  # noqa: F401
from .checkpoint import (AsyncCheckpointer, latest_step,  # noqa: F401
                         load_checkpoint, process_count, process_index,
                         restore_to_device, save_checkpoint)
