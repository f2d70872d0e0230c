"""The yardstick's arithmetic: the chip's peaks and the least work and
bytes each measured stage needs, counted from the shapes alone.

The counts read the same whatever implements a stage, so no kernel can
push a share past 100%: a Gram is the n * d(d+1)/2 multiply-adds of its
distinct entries (2 operations each) over the valid samples, against the
chip's highest dense peak, whatever the kernel's number format or
whether it computes one triangle; bytes are each input byte read once and
each output byte written once.
"""
from __future__ import annotations

#: device name -> (dense operations per second, HBM bytes per second):
#: NVIDIA's data sheet for the H100 SXM (int8 / fp8 dense, HBM3), at the
#: full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": (1979e12, 3.35e12),
}


def gram_ops(n: int, d: int) -> int:
    """Operations of the distinct entries of a symmetric (d, d) Gram over
    n samples."""
    return n * d * (d + 1)


def gram_bytes(n: int, d: int, in_bytes: float) -> float:
    """The (n, d) payload read once at ``in_bytes`` a symbol and the
    (d, d) f32 Gram written once."""
    return n * d * in_bytes + 4 * d * d


def encode_bytes(n: int, d: int, out_bytes: float = 1) -> float:
    """f32 samples in, the payload out at ``out_bytes`` a symbol."""
    return 4 * n * d + n * d * out_bytes


def floor_s(ops: float, nbytes: float, device: str) -> float | None:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth (None for a
    device the table does not know)."""
    peak = PEAKS.get(device)
    if peak is None:
        return None
    return max(ops / peak[0], nbytes / peak[1])


def share(ops: float, nbytes: float, seconds: float | None,
          device: str) -> float | None:
    """100 * floor / measured seconds, in %."""
    floor = floor_s(ops, nbytes, device)
    if floor is None or not seconds:
        return None
    return 100.0 * floor / seconds
