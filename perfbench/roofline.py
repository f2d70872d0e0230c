"""The yardstick's arithmetic: the chip's peaks and the least work and
bytes each measured stage needs, counted from the shapes alone.

The counts read the same whatever implements a stage, so no kernel can
push a share past 100%: a Gram is the n * d(d+1)/2 multiply-adds of its
distinct entries (2 operations each) over the valid samples, against the
chip's highest dense peak, whatever the kernel's number format or
whether it computes one triangle; bytes are each input byte read once and
each output byte written once. An LM prefill's shares are taken at the
dense bf16 peak (``BF16_PEAKS``): its configuration fixes bf16, and its
check fails a lower precision.
"""
from __future__ import annotations

#: device name -> (dense operations per second, HBM bytes per second):
#: NVIDIA's data sheet for the H100 SXM (int8 / fp8 dense, HBM3), at the
#: full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": (1979e12, 3.35e12),
}
#: device name -> (dense bf16 operations per second, HBM bytes per
#: second): the same data sheet and power limit
BF16_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
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


def causal_attention_ops(b: int, s: int, hq: int, dh: int) -> int:
    """Operations of one layer's causal attention over S positions: q.k
    and p.v, 2 * Dh each, for each of the S(S+1)/2 visible pairs of each
    query head."""
    return 4 * b * hq * dh * (s * (s + 1) // 2)


def attention_bytes(b: int, s: int, hq: int, hkv: int, dh: int,
                    itemsize: int = 2) -> int:
    """q, k and v read once and the output written once."""
    return itemsize * b * s * dh * (2 * hq + 2 * hkv)


def gemm_ops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def gemm_bytes(m: int, k: int, n: int, itemsize: int = 2) -> int:
    """(m, k) and (k, n) read once, (m, n) written once."""
    return itemsize * (m * k + k * n + m * n)


def dense_prefill_gemms(b: int, s: int, d: int, hq: int, hkv: int, dh: int,
                        f: int, vocab: int, layers: int) -> list:
    """((m, k, n), count) of a dense GQA decoder's prefill of B x S
    tokens: each layer's q, k, v and output projections and its SwiGLU's
    gate, up and down over every token, and the LM head over each row's
    last position (the logits a prefill returns)."""
    t = b * s
    return [((t, d, hq * dh), layers), ((t, d, hkv * dh), 2 * layers),
            ((t, hq * dh, d), layers), ((t, d, f), 2 * layers),
            ((t, f, d), layers), ((b, d, vocab), 1)]


def floor_s(ops: float, nbytes: float, device: str,
            peaks: dict = PEAKS) -> float | None:
    """The least time the chip could take: the larger of the operations
    over the peak rate and the bytes over the peak bandwidth (None for a
    device the table does not know)."""
    peak = peaks.get(device)
    if peak is None:
        return None
    return max(ops / peak[0], nbytes / peak[1])


def share(ops: float, nbytes: float, seconds: float | None,
          device: str, peaks: dict = PEAKS) -> float | None:
    """100 * floor / measured seconds, in %."""
    floor = floor_s(ops, nbytes, device, peaks)
    if floor is None or not seconds:
        return None
    return 100.0 * floor / seconds
