"""Deterministic synthetic traffic for the serving plane.

A copy of ``repro.serve.traffic``: the same config gives the same
payloads byte for byte.

Machines sample a chain-structured Gaussian (corr(i, j) = rho^|i-j| —
the paper's running example, drawn via the AR(1) recursion), quantize
per the serve method, and stamp per-(tenant, machine) sequence numbers.
On top of the clean trace the generator injects the three wire
pathologies the ingest log is built for — duplicates (a payload
delivered again later), reordering (a payload delayed past its
successor) and drops (a sequence number that never arrives) — all from
one seeded ``numpy`` Generator, so a trace is a pure function of its
config: tests and the crash-recovery bench replay the identical byte
stream into independent server processes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.quantizers import _codebook_np, pack_codes
from .ingest import Payload


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    tenants: int
    machines: int
    ticks: int
    n: int                     # rows per payload
    d: int
    rho: float = 0.6
    method: str = "sign"
    rate: int = 1
    packed_fraction: float = 0.5   # sign payloads sent 1-bit packed
    bit_fraction: float = 0.0      # unpacked sign payloads sent as
                                   # {0,1} wire bits (Payload.bits=True)
    p_duplicate: float = 0.0
    p_reorder: float = 0.0
    p_drop: float = 0.0
    seed: int = 0
    #: mid-trace STRUCTURE CHANGE: from ``permute_from_tick`` on, every
    #: sample block has its feature columns permuted by this (d,) tuple
    #: before quantization — the underlying chain edges move, so a
    #: drift detector watching the solves should alarm. ``None`` = the
    #: stationary trace (byte-identical to pre-permutation configs: the
    #: permutation consumes no RNG draws).
    permutation: tuple[int, ...] | None = None
    permute_from_tick: int = 0

    def __post_init__(self):
        if self.permutation is not None:
            perm = tuple(int(j) for j in self.permutation)
            if sorted(perm) != list(range(self.d)):
                raise ValueError(
                    f"permutation must be a permutation of range({self.d}), "
                    f"got {self.permutation!r}")
            object.__setattr__(self, "permutation", perm)


def _chain_samples(rng: np.random.Generator, n: int, d: int,
                   rho: float) -> np.ndarray:
    """(n, d) samples with corr(i, j) = rho^|i-j| (stationary AR(1)).

    ``repro``'s recursion x[:, j] = rho x[:, j-1] + s z[:, j], the same
    float64 products and sums element by element, run feature-major so
    that each step reads contiguous rows (the same bytes, a few times
    faster at d in the thousands)."""
    zt = rng.standard_normal((n, d)).T
    s = np.sqrt(1.0 - rho * rho)
    xt = np.empty((d, n))
    xt[0] = zt[0]
    np.multiply(zt[1:], s, out=xt[1:])       # s z_j, all j at once
    for j in range(1, d):
        xt[j] += rho * xt[j - 1]
    return xt.T


def _encode(cfg: TrafficConfig, rng: np.random.Generator,
            x: np.ndarray) -> dict:
    """Quantize one block into Payload kwargs (codes= or packed=+n=)."""
    if cfg.method == "sign":
        # one draw picks among packed / bit-codes / sign-codes so a
        # bit_fraction of 0 reproduces pre-bit_fraction traces exactly
        u = rng.random()
        if u < cfg.packed_fraction:
            bits = (x >= 0).astype(np.int8)            # (n, d) {0, 1}
            pad = (-cfg.n) % 8
            if pad:
                bits = np.concatenate(
                    [bits, np.zeros((pad, cfg.d), np.int8)])
            packed = pack_codes(torch.from_numpy(bits.T), 1).numpy()
            return {"packed": packed, "n": cfg.n}
        if (u - cfg.packed_fraction
                < cfg.bit_fraction * (1.0 - cfg.packed_fraction)):
            return {"codes": (x >= 0).astype(np.int8), "bits": True}
        return {"codes": np.where(x >= 0, 1, -1).astype(np.int8)}
    boundaries, _ = _codebook_np(cfg.rate)
    # count of interior boundaries strictly below x = the encoder's bin
    codes = np.searchsorted(boundaries[1:-1], x, side="left")
    return {"codes": codes.astype(np.int8)}


def make_trace(cfg: TrafficConfig) -> list[list[Payload]]:
    """The full delivery schedule: ``trace[t]`` is the (ordered) list of
    payloads ARRIVING at tick t, pathologies already applied."""
    rng = np.random.default_rng(cfg.seed)
    arrivals: list[list[Payload]] = [[] for _ in range(cfg.ticks)]
    for tenant in range(cfg.tenants):
        for machine in range(cfg.machines):
            seq = 0
            for tick in range(cfg.ticks):
                seq += 1
                x = _chain_samples(rng, cfg.n, cfg.d, cfg.rho)
                if (cfg.permutation is not None
                        and tick >= cfg.permute_from_tick):
                    x = x[:, np.asarray(cfg.permutation)]
                p = Payload(tenant, machine, seq, **_encode(cfg, rng, x))
                r = rng.random(3)
                if r[0] < cfg.p_drop:
                    continue                       # the seq never arrives
                at = tick
                if r[1] < cfg.p_reorder and tick + 1 < cfg.ticks:
                    at = tick + 1                  # delayed past successor
                arrivals[at].append(p)
                if r[2] < cfg.p_duplicate:
                    again = min(tick + int(rng.integers(0, 3)),
                                cfg.ticks - 1)
                    arrivals[again].append(p)      # replayed verbatim
    return arrivals


def unique_payloads(trace: list[list[Payload]]) -> list[Payload]:
    """Each delivered (tenant, machine, seq) once, first arrival wins —
    the exactly-once ground truth a server folding this trace (with
    buffers large enough to absorb its reordering) must reproduce."""
    seen: set[tuple[int, int, int]] = set()
    out: list[Payload] = []
    for batch in trace:
        for p in batch:
            key = (p.tenant, p.machine, p.seq)
            if key not in seen:
                seen.add(key)
                out.append(p)
    return out
