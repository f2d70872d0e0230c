"""Pytree checkpointing (npz-based), file-compatible with ``repro``'s."""
from .ckpt import latest_step, load_checkpoint, save_checkpoint  # noqa: F401
