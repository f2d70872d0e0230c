"""Streaming (online) statistic estimation — n beyond device memory.

The port of ``repro.core.streaming``. The paper's central statistics are
sums over samples (eq. 8, eq. 32), so the center can consume the
quantized stream in batches and keep only the (d, d) Gram accumulator:
exact equality with the batch estimator on the integer paths, O(d^2)
state, any n.

Every per-batch Gram goes through :class:`repro_torch.core.gram.GramEngine`:

* sign / per-symbol batches enter the kernels as int8 code blocks (the
  centroid decode runs in ``code_corr``'s tiles);
* :meth:`StreamingGram.update_codes` folds already-quantized wire blocks;
* :meth:`StreamingGram.update_packed` folds 1-bit packed sign payloads
  through ``sign_corr_packed`` (the wire bytes are the operand);
* :meth:`StreamingGram.update_codes_batch` /
  :meth:`StreamingGram.update_packed_batch` fold a stack of per-machine
  blocks through one batched launch.

The accumulator is an f32 tensor on the engine's device (``cuda`` unless
the engine says ``device="cpu"``); the estimate is
``estimators.weights_from_gram``, the batch pipeline's own tail.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device

from . import estimators
from .gram import GramEngine, resolve_engine
from .quantizers import MASKED_CODE, PerSymbolQuantizer, sign_codes
from .strategy import Strategy


@dataclasses.dataclass
class StreamingGram:
    """Accumulates G += U_batch^T U_batch and n over quantized batches."""

    d: int
    method: str = "sign"          # sign | persymbol | original
    rate: int = 4
    engine: GramEngine | None = None  # None = the default (cuda) engine

    def __post_init__(self):
        self.device = resolve_device(self._eng.device)
        self.gram = torch.zeros((self.d, self.d), dtype=torch.float32,
                                device=self.device)
        self.n = 0
        self._quant = (
            PerSymbolQuantizer(self.rate) if self.method == "persymbol"
            else None)

    @classmethod
    def from_strategy(cls, d: int, strategy: Strategy,
                      engine: GramEngine | None = None) -> "StreamingGram":
        """The accumulator of a declarative :class:`Strategy`."""
        return cls(d=d, method=strategy.method, rate=strategy.rate,
                   engine=engine)

    @property
    def _eng(self) -> GramEngine:
        return resolve_engine(self.engine)

    def _in(self, a, dtype=None) -> torch.Tensor:
        """An operand on the accumulator's device (tensors stay put), in
        row-major order as the kernels read it."""
        return as_tensor(a, self.device, dtype).contiguous()

    def _add(self, g: torch.Tensor) -> None:
        self.gram = self.gram + g.to(self.device)

    def update(self, x_batch) -> "StreamingGram":
        """Quantize a raw (n_b, d) sample batch and fold it in. Per-symbol
        codes come from ``quantize_fused`` and feed ``code_corr``."""
        x = self._in(x_batch, torch.float32)
        if x.shape[1] != self.d:
            raise ValueError(f"batch has d={x.shape[1]}, accumulator {self.d}")
        if self.method == "sign":
            g = self._eng.gram(sign_codes(x))
        elif self.method == "persymbol":
            g = self._eng.code_gram(self._quant.encode(x),
                                    self._quant.centroids_np)
        else:
            g = self._eng.gram(x)
        self._add(g)
        self.n += x.shape[0]
        return self

    def update_codes(self, codes) -> "StreamingGram":
        """Fold an already-quantized (n_b, d) wire block: sign bits {0,1}
        or signs {-1,+1}; per-symbol bin indices in [0, 2^R)."""
        u = self._in(codes)
        if u.shape[1] != self.d:
            raise ValueError(f"block has d={u.shape[1]}, accumulator {self.d}")
        if self.method == "sign":
            g = self._eng.gram(_codes_pm1(u))
        elif self.method == "persymbol":
            g = self._eng.code_gram(u.to(torch.int8), self._quant.centroids_np)
        else:
            raise ValueError("update_codes requires a quantized method")
        self._add(g)
        self.n += u.shape[0]
        return self

    def update_packed(self, payload, n_batch: int) -> "StreamingGram":
        """Fold a 1-bit packed sign payload: (d, ceil(n_b/8)) uint8 in
        ``quantizers.pack_codes`` layout (feature-major, little bit order,
        zero tail bits)."""
        self._require_sign("packed wire")
        p = self._in(payload)
        if p.shape[0] != self.d:
            raise ValueError(f"payload has d={p.shape[0]}, accumulator "
                             f"{self.d}")
        self._add(self._eng.packed_sign_gram(p, n_batch))
        self.n += n_batch
        return self

    def update_codes_batch(self, codes, n_valid=None) -> "StreamingGram":
        """Fold a stack of per-machine wire blocks, (m, n_b, d), through
        one batched Gram launch; exactly m :meth:`update_codes` calls.

        ``n_valid`` — optional (m,) delivered-row counts: machine i
        contributes only its first ``n_valid[i]`` rows (0 = dropped). Rows
        past the prefix become 0 (sign) or ``MASKED_CODE`` (per-symbol),
        which drop out of the contraction.
        """
        u = self._in(codes)
        if u.dim() != 3 or u.shape[2] != self.d:
            raise ValueError(f"update_codes_batch takes (m, n_b, {self.d}), "
                             f"got {tuple(u.shape)}")
        m, n_b, _ = u.shape
        n_add = m * n_b
        mask = None
        if n_valid is not None:
            nv = _counts(n_valid, m)
            mask = (torch.arange(n_b, device=u.device)[None, :, None]
                    < torch.as_tensor(nv, device=u.device)[:, None, None])
            n_add = int(nv.sum())
        if self.method == "sign":
            u = _codes_pm1(u)
            if mask is not None:
                u = torch.where(mask, u, 0)
            g = self._eng.gram_batch(u)
        elif self.method == "persymbol":
            u = u.to(torch.int8)
            if mask is not None:
                u = torch.where(mask, u, MASKED_CODE).to(torch.int8)
            g = self._eng.code_gram_batch(u, self._quant.centroids_np)
        else:
            raise ValueError("update_codes_batch requires a quantized method")
        self._add(g.sum(dim=0))
        self.n += n_add
        return self

    def update_packed_batch(self, payloads, n_batch: int,
                            n_valid=None) -> "StreamingGram":
        """Fold a stack of 1-bit packed sign payloads, (m, d, ceil(n_b/8))
        uint8, each ``n_batch`` samples, through one batched launch.

        ``n_valid`` — optional (m,) delivered-row counts (prefix
        truncation; 0 = dropped). Each machine's bytes are masked to its
        bit prefix; the zeroed bits unpack to -1 on both sides of the
        contraction and count as agreement, so ``n_batch - n_valid[i]`` is
        subtracted from machine i's Gram — exactly the fold of the
        surviving prefixes.
        """
        self._require_sign("packed wire")
        p = self._in(payloads)
        if p.dim() != 3 or p.shape[1] != self.d:
            raise ValueError(f"update_packed_batch takes (m, {self.d}, nb), "
                             f"got {tuple(p.shape)}")
        m, nb = p.shape[0], p.shape[-1]
        if n_valid is None:
            g = self._eng.packed_sign_gram_batch(p, n_batch)
            self._add(g.sum(dim=0))
            self.n += m * n_batch
            return self
        nv = _counts(n_valid, m)
        # byte j of machine i keeps its low clip(nv[i] - 8j, 0, 8) bits
        bits_left = np.clip(nv[:, None] - 8 * np.arange(nb)[None, :], 0, 8)
        byte_mask = ((1 << bits_left) - 1).astype(np.uint8)
        masked = p & torch.from_numpy(byte_mask).to(p.device)[:, None, :]
        g = self._eng.packed_sign_gram_batch(masked, n_batch)
        shift = (np.float32(n_batch) - nv.astype(np.float32))
        g = g - torch.from_numpy(shift).to(g.device)[:, None, None]
        self._add(g.sum(dim=0))
        self.n += int(nv.sum())
        return self

    def merge(self, other: "StreamingGram") -> "StreamingGram":
        """Fold another accumulator in: G += other.G, n += other.n. Exact on
        the integer paths (sign, packed) in any order."""
        if not isinstance(other, StreamingGram):
            raise TypeError(f"can only merge StreamingGram, got {type(other)}")
        if (self.d, self.method) != (other.d, other.method):
            raise ValueError(
                f"incompatible accumulators: d/method "
                f"{(self.d, self.method)} vs {(other.d, other.method)}")
        if self.method == "persymbol" and self.rate != other.rate:
            raise ValueError(
                f"incompatible per-symbol rates: {self.rate} vs {other.rate}")
        self._add(other.gram)
        self.n += other.n
        return self

    def weights(self) -> torch.Tensor:
        """Chow-Liu weights: the batch estimator's tail on the stream."""
        return estimators.weights_from_gram(self.gram, self.n, self.method)

    def learn_adjacency(self) -> torch.Tensor:
        """Weights -> Boruvka MWST on the accumulator's device: the (d, d)
        bool adjacency."""
        from .chow_liu import boruvka_mst

        return boruvka_mst(self.weights())

    def learn_structure(self, backend: str = "kruskal"):
        from .chow_liu import adjacency_to_edges, kruskal_mst

        if backend == "boruvka":
            return adjacency_to_edges(self.learn_adjacency())
        if backend != "kruskal":
            raise ValueError(f"unknown backend {backend!r}")
        return kruskal_mst(self.weights())

    def _require_sign(self, what: str) -> None:
        if self.method != "sign":
            raise ValueError(f"the {what} is the sign method")


def _codes_pm1(codes: torch.Tensor) -> torch.Tensor:
    """{0,1} wire bits as well as {-1,+1} signs -> int8 ±1."""
    return torch.where(codes > 0, 1, -1).to(torch.int8)


def _counts(n_valid, m: int) -> np.ndarray:
    """(m,) host int64 delivered-row counts."""
    if isinstance(n_valid, torch.Tensor):
        n_valid = n_valid.detach().cpu().numpy()
    nv = np.asarray(n_valid, dtype=np.int64)
    if nv.shape != (m,):
        raise ValueError(f"n_valid has shape {nv.shape}, expected ({m},)")
    return nv
