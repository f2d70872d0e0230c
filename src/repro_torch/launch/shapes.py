"""The assigned input shapes (the 4-row shape table), and the reduced
variant the CPU smoke runs use.

A copy of ``repro.launch.shapes``: pure values, no framework.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int

    @property
    def lowers(self) -> str:
        """Which step function this shape exercises."""
        return {"train": "train_step", "prefill": "prefill_step",
                "decode": "serve_step"}[self.kind]


SHAPES: dict[str, InputShape] = {
    s.name: s
    for s in [
        InputShape("train_4k", "train", 4_096, 256),
        InputShape("prefill_32k", "prefill", 32_768, 32),
        InputShape("decode_32k", "decode", 32_768, 128),
        InputShape("long_500k", "decode", 524_288, 1),
    ]
}


def reduced_shape(shape: InputShape) -> InputShape:
    """CPU-runnable variant preserving the kind (for smoke tests)."""
    return InputShape(
        shape.name + "-reduced",
        shape.kind,
        seq_len=min(shape.seq_len, 128),
        global_batch=min(shape.global_batch, 2),
    )
