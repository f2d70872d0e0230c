"""Optimizers with ``repro``'s arithmetic, schedules and gradient
utilities."""
from .optimizers import (  # noqa: F401
    SGD,
    AdamW,
    clip_by_global_norm,
    global_norm,
)
from .schedules import constant, cosine_decay, linear_warmup_cosine  # noqa: F401
