"""The attention kernels under the dry run: their calls counted, and their
stand-ins on the meta device.

``launch.op_analysis`` counts one rank's step while it runs. torch's FLOP
counter cannot see a kernel's ``ctypes`` launch, so each attention
wrapper reports its calls, with their FLOPs and the bytes they move by
the kernel's formula, to the observer the count installs
(:func:`observing`), on a CUDA tensor beside its launch. On a meta
tensor (the dry run's production ranks) the wrapper allocates the output
as the kernel does and reports the call (:func:`stand_in`); outside a
count a meta tensor that reaches a kernel raises, so no real path can
take the stand-in.
"""
from __future__ import annotations

import contextlib

import torch

#: ``observer(name, flops, nbytes)`` while a count runs, else None
observer = None


@contextlib.contextmanager
def observing(fn):
    """Install ``fn`` as the kernels' observer."""
    global observer
    prev, observer = observer, fn
    try:
        yield
    finally:
        observer = prev


def stand_in(name: str, out: torch.Tensor, cost: tuple) -> torch.Tensor:
    """``out``, the output a kernel call on meta tensors allocates, the
    call (``cost``: its FLOPs and bytes) reported; raises outside a
    count."""
    if observer is None:
        raise RuntimeError(f"{name}: a meta tensor reached the kernel "
                           f"outside the dry run (launch.op_analysis)")
    observer(name, *cost)
    return out


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)
