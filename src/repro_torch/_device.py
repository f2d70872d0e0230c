"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None, *tensors) -> torch.device:
    """The device an entry point runs on.

    The first torch tensor among ``tensors`` decides; otherwise
    ``device`` (default ``"cuda"``). A CUDA device on a host without
    CUDA raises: the port never falls back to the CPU on its own.
    """
    for t in tensors:
        if isinstance(t, torch.Tensor):
            return t.device
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' to run "
            "the port's plain PyTorch versions on the CPU")
    return dev


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """``x`` as a tensor: torch tensors stay where they are (cast to
    ``dtype`` if given); host arrays go to :func:`resolve_device`."""
    if isinstance(x, torch.Tensor):
        return x if dtype is None else x.to(dtype)
    a = np.ascontiguousarray(x)
    if not a.flags.writeable:  # torch tensors are always writable
        a = a.copy()
    return torch.from_numpy(a).to(device=resolve_device(device), dtype=dtype)
