"""TenantTable: many StreamingGram accumulators behind batched launches.

The port of ``repro.serve.table``. Multi-tenant center state, stacked on
a leading tenant axis, kept on the host:

* ``gram`` — (T, d, d) float64 accumulators. Each fold's per-slot f32
  Grams are copied to the host and added in float64 in acceptance
  order. Sign and packed-sign Grams are exact integers, so the sums are
  bit-identical under any fold order (what makes crash replay and merge
  exact); rate-1 per-symbol Grams are c^2 times an integer and exact as
  well. Higher-rate per-symbol sums are deterministic, not order-free.
* ``n`` — (T,) int64 folded sample counts; lost payloads never fold, so
  the estimate normalizes by what arrived.

Every fold runs one batched launch per payload kind (codes, packed),
however many tenants have data: payloads are padded to ``(slots,
block_n, d)`` (slots bucketed to powers of two) and contracted on the
engine's device by ``sign_corr``, ``code_corr`` or ``sign_corr_packed``
at b = slots. Structure is re-solved incrementally: only tenants whose
accumulator changed go through the batched weights -> Boruvka solve,
and each solve adds the edge symmetric difference against the previous
one to a drift counter (``experiments.structure_metric_channels``).

With a tenant mesh (``launch.mesh.make_tenant_mesh``: local devices of
this process) a fold's or a solve's slot bucket is split over the mesh's
devices when their count divides it: part i folds and solves on
``devices[i]``, and the parts come back in slot order. Tenants are
independent, so the split cannot change a tenant's bits.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

from ..core import estimators, experiments
from ..core.chow_liu import boruvka_mst_batch
from ..core.gram import GramEngine, resolve_engine
from ..core.quantizers import MASKED_CODE, PerSymbolQuantizer
from ..core.streaming import StreamingGram
from .ingest import Payload, split_kinds


def _next_pow2(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


def codes_fold_stage(batch: torch.Tensor, method: str, rate: int,
                     engine: GramEngine) -> torch.Tensor:
    """(slots, block_n, d) int8 -> (slots, d, d) f32 per-slot Grams.

    Sign codes arrive as {-1, 0, +1} (0 — a padded row or a masked wire
    entry — drops out of the integer contraction); per-symbol codes as
    bin indices with ``MASKED_CODE`` padding, which decodes to 0.
    """
    if method == "sign":
        return engine.gram_batch(batch)
    if method == "persymbol":
        return engine.code_gram_batch(
            batch, PerSymbolQuantizer(rate).centroids_np)
    raise ValueError(f"serve folds quantized payloads, got {method!r}")


def packed_fold_stage(batch: torch.Tensor, n_valid: torch.Tensor,
                      block_n: int, engine: GramEngine) -> torch.Tensor:
    """(slots, d, block_n/8) uint8 + (slots,) valid counts -> (slots, d,
    d) f32. The launch contracts all ``block_n`` samples: zero-padded bits
    unpack to -1 on both sides and count as agreement, so subtracting
    ``block_n - n_valid[i]`` gives each slot's prefix Gram exactly (an
    all-zero padding slot lands on 0) — the identity of
    ``StreamingGram.update_packed_batch``.
    """
    g = engine.packed_sign_gram_batch(batch, block_n)
    return g - (float(block_n) - n_valid.to(torch.float32))[:, None, None]


def solve_stage(stat: torch.Tensor, n: torch.Tensor, prev_adj: torch.Tensor,
                method: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots, d, d) f32 normalized Grams (gram / max(n, 1), divided on
    the host in float64) + (slots,) counts + previous adjacencies ->
    (new adjacencies, [changed, drift, shared] channels).

    ``n`` enters ``weights_from_gram(..., normalized=True)`` as a (slots,
    1, 1) count used only for the per-symbol bias correction and the
    n < 2 neutralization, so a tenant with fewer than 2 samples solves to
    zero weights instead of NaN.
    """
    w = estimators.weights_from_gram(stat, n[:, None, None], method,
                                     normalized=True)
    adj = boruvka_mst_batch(w)
    return adj, experiments.structure_metric_channels(adj, prev_adj)


@dataclasses.dataclass
class TenantTable:
    """The accumulator stack + incremental-solve state for T tenants."""

    tenants: int
    d: int
    method: str = "sign"
    rate: int = 1
    block_n: int = 64       # canonical payload row bucket (n <= block_n)
    max_slots: int = 64     # largest single fold launch
    engine: GramEngine | None = None  # None = the default (cuda) engine
    mesh: object | None = None  # a TenantMesh: split launches over it
    resolve_min_new: int = 1    # new samples before a re-solve
    resolve_fraction: float = 0.0  # ... or this fraction of solved_n

    def __post_init__(self):
        if self.method == "sign":
            self.rate = 1
        if self.block_n % 8:
            raise ValueError("block_n must be a multiple of 8 (packed wire)")
        T, d = self.tenants, self.d
        self.gram = np.zeros((T, d, d), np.float64)
        self.n = np.zeros(T, np.int64)
        self.adj = np.zeros((T, d, d), bool)
        self.solved_n = np.zeros(T, np.int64)
        self.solves = np.zeros(T, np.int64)
        self.drift = np.zeros(T, np.int64)
        self._eng = resolve_engine(self.engine)
        self.device = resolve_device(self._eng.device)

    # -- folding ------------------------------------------------------------

    def fold(self, payloads: Sequence[Payload]) -> int:
        """Fold one batch of ACCEPTED payloads (the tick's admissions, in
        acceptance order) through batched launches; returns rows folded.

        The canonical grouping — codes first, then packed, each chunked
        to ``max_slots`` — is shared with journal replay, so a replayed
        batch reproduces the live accumulation order exactly.
        """
        rows = 0
        codes, packed = split_kinds(payloads)
        for chunk in _chunks(codes, self.max_slots):
            rows += self._fold_codes(chunk)
        for chunk in _chunks(packed, self.max_slots):
            rows += self._fold_packed(chunk)
        return rows

    def _fold_codes(self, chunk: list[Payload]) -> int:
        S = _next_pow2(len(chunk))
        fill = 0 if self.method == "sign" else MASKED_CODE
        batch = np.full((S, self.block_n, self.d), fill, np.int8)
        for i, p in enumerate(chunk):
            self._check(p)
            c = p.codes
            if p.bits:
                # {0,1} wire bits -> ±1 (0 is a true -1 on a bit wire)
                c = (2 * c.astype(np.int8) - 1).astype(np.int8)
            # sign values {-1,0,+1} pass through: 0 = masked entry,
            # drops out of the contraction exactly like padding rows
            batch[i, :p.n] = c
        g = self._staged(lambda b: codes_fold_stage(
            b, self.method, self.rate, self._eng), batch)
        return self._scatter(chunk, to_host(g))

    def _fold_packed(self, chunk: list[Payload]) -> int:
        if self.method != "sign":
            raise ValueError("packed payloads are the sign method")
        S = _next_pow2(len(chunk))
        nb = self.block_n // 8
        batch = np.zeros((S, self.d, nb), np.uint8)
        n_valid = np.zeros(S, np.int32)
        for i, p in enumerate(chunk):
            self._check(p)
            batch[i, :, :p.packed.shape[1]] = p.packed
            n_valid[i] = p.n
        g = self._staged(lambda b, n: packed_fold_stage(
            b, n, self.block_n, self._eng), batch, n_valid)
        return self._scatter(chunk, to_host(g))

    def _scatter(self, chunk: list[Payload], g: np.ndarray) -> int:
        rows = 0
        for i, p in enumerate(chunk):  # acceptance order: deterministic
            self.gram[p.tenant] += g[i]
            self.n[p.tenant] += p.n
            rows += p.n
        return rows

    def _check(self, p: Payload) -> None:
        if p.d != self.d:
            raise ValueError(f"payload d={p.d} vs table d={self.d}")
        if not 0 < p.n <= self.block_n:
            raise ValueError(
                f"payload rows {p.n} exceed block_n={self.block_n}")
        if not 0 <= p.tenant < self.tenants:
            raise ValueError(f"unknown tenant {p.tenant}")
        if p.kind != "codes":
            return
        if self.method == "sign":
            lo, hi = (0, 1) if p.bits else (-1, 1)
            if p.codes.min() < lo or p.codes.max() > hi:
                raise ValueError(
                    f"sign payload codes must lie in [{lo}, {hi}] "
                    f"({'wire bits' if p.bits else 'signs, 0 = masked'}), "
                    f"got [{p.codes.min()}, {p.codes.max()}]")
        elif p.bits:
            raise ValueError("bits payloads are the sign method")

    # -- incremental solve --------------------------------------------------

    def needs_resolve(self) -> np.ndarray:
        """(T,) bool — tenants whose Gram changed materially since their
        last solve: at least ``resolve_min_new`` new samples, or
        ``resolve_fraction`` of the count last solved at."""
        fresh = self.n - self.solved_n
        floor = np.maximum(self.resolve_min_new,
                           (self.resolve_fraction
                            * self.solved_n).astype(np.int64))
        return (self.n > 0) & (fresh >= np.maximum(floor, 1))

    def resolve(self, idx: np.ndarray) -> dict:
        """Re-solve structure for the tenant indices ``idx`` (one batched
        weights -> Boruvka solve per pow2 slot bucket) and update the
        drift telemetry. Returns {solved, drifted, drift_edges}."""
        idx = np.asarray(idx, np.int64)
        solved = drifted = drift_edges = 0
        for lo in range(0, len(idx), self.max_slots):
            part = idx[lo:lo + self.max_slots]
            S = _next_pow2(len(part))
            stat = np.zeros((S, self.d, self.d), np.float32)
            n = np.zeros(S, np.float32)
            prev = np.zeros((S, self.d, self.d), bool)
            # normalize in float64 on the host: int64 counts round in
            # f32 beyond 2^24 folded samples, skewing every weight
            safe_n = np.maximum(self.n[part], 1).astype(np.float64)
            stat[:len(part)] = (
                self.gram[part] / safe_n[:, None, None]).astype(np.float32)
            n[:len(part)] = self.n[part]
            prev[:len(part)] = self.adj[part]
            adj, ch = self._staged(lambda *a: solve_stage(*a, self.method),
                                   stat, n, prev)
            adj = adj[:len(part)].cpu().numpy()
            ch = ch[:len(part)].cpu().numpy()
            ham = ch[:, 1].astype(np.int64)
            self.adj[part] = adj
            self.drift[part] += ham
            self.solves[part] += 1
            self.solved_n[part] = self.n[part]
            solved += len(part)
            drifted += int((ham > 0).sum())
            drift_edges += int(ham.sum())
        return {"solved": solved, "drifted": drifted,
                "drift_edges": drift_edges}

    def _place(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Host batch -> the engine's device (or ``device``)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device if device is None else device)

    def _staged(self, stage, *arrays):
        """``stage`` over host batches with a leading slot axis: on the
        engine's device, or, when a tenant mesh's device count divides
        the slots, one part a device (``repro``'s ``_place`` shards the
        batch over the ``("tenant",)`` mesh), the parts' outputs
        concatenated in slot order on the host."""
        mesh, slots = self.mesh, arrays[0].shape[0]
        if mesh is None or mesh.size == 1 or slots % mesh.size:
            return stage(*(self._place(a) for a in arrays))
        k = slots // mesh.size
        outs = [stage(*(self._place(a[i * k:(i + 1) * k], dev)
                        for a in arrays))
                for i, dev in enumerate(mesh.devices)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat([o[j].cpu() for o in outs])
                         for j in range(len(outs[0])))
        return torch.cat([o.cpu() for o in outs])

    # -- state / interop ----------------------------------------------------

    def state_tree(self) -> dict:
        """The snapshot pytree (host numpy leaves; see checkpoint.ckpt)."""
        return {"gram": self.gram, "n": self.n, "adj": self.adj,
                "solved_n": self.solved_n, "solves": self.solves,
                "drift": self.drift}

    def load_state(self, tree: dict) -> None:
        for k, v in self.state_tree().items():
            got = np.asarray(tree[k], v.dtype)
            if got.shape != v.shape:
                raise ValueError(f"snapshot leaf {k}: {got.shape} vs "
                                 f"{v.shape}")
            v[...] = got

    def to_streaming(self, tenant: int) -> StreamingGram:
        """Export one tenant's accumulator as a ``StreamingGram`` (same
        estimator tail; ``StreamingGram.merge`` recombines exports)."""
        sg = StreamingGram(d=self.d, method=self.method, rate=self.rate,
                           engine=self.engine)
        sg.gram = torch.from_numpy(
            self.gram[tenant].astype(np.float32)).to(sg.device)
        sg.n = int(self.n[tenant])
        return sg


def to_host(g: torch.Tensor) -> np.ndarray:
    """A fold's (slots, d, d) f32 Grams as host float64 (exact)."""
    return g.cpu().numpy().astype(np.float64)


def _chunks(items: list, size: int):
    for lo in range(0, len(items), size):
        yield items[lo:lo + size]
