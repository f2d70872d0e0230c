"""Learning-rate schedules: integer step -> f32 learning rate.

The port of ``repro.optim.schedules``, evaluated on the host in numpy
f32 (the step count is a host int in the port), op for op as ``repro``
evaluates them on the device.
"""
from __future__ import annotations

import numpy as np

_F = np.float32


def constant(lr: float):
    return lambda step: _F(lr)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = np.clip(_F(step) / _F(max(total_steps, 1)), _F(0.0), _F(1.0))
        cos = _F(0.5) * (_F(1.0) + np.cos(_F(np.pi) * t))
        return _F(lr) * (_F(final_frac) + _F(1.0 - final_frac) * cos)

    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    decay = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = _F(step)
        if step < warmup_steps:
            return _F(lr) * step / _F(max(warmup_steps, 1))
        return decay(step - _F(warmup_steps))

    return fn
