"""Checkpointing of the port (``repro/ckpt``)."""
from . import checkpoint  # noqa: F401
from .checkpoint import (AsyncCheckpointer, flatten_paths,  # noqa: F401
                         gc_checkpoints, latest_step, load_checkpoint,
                         process_count, process_index, restore_to_device,
                         restore_with_placements, save_checkpoint,
                         save_with_placements)
