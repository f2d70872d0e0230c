"""Deterministic fault injection for the wire (the port of
``repro.core.faults``).

A :class:`FaultPlan` — frozen and hashable, a plan value beside
:class:`~repro_torch.core.strategy.Strategy` — specifies

* **dropout**: each machine's payload is lost with probability
  ``dropout`` per wire round; up to ``retries`` extra rounds re-request
  the lost ones, and a machine's features are voided only if every round
  failed;
* **straggling**: with probability ``straggle`` an arriving machine
  delivers only the first ``ceil(straggle_frac * n)`` of its rows;
* **bit flips**: each sign bit is flipped with probability ``bitflip``
  (sign-method payloads only).

Every draw is a trial/machine/round-keyed ``fold_in`` stream of the
port's threefry (``core.prng``), in ``repro``'s order, so the port's
realizations — delivered-row counts, flip masks and telemetry — are
bit-identical to ``repro``'s, and bucket-stable: the flip mask is keyed
by sample row. A zero-fault plan draws all-true masks, whose every use is
the identity: it is bit-identical to no plan.

The MAC channel sees the same machine fates as delivered-row counts per
sample-row block (:meth:`FaultPlan.draw_rowblock_batch`).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch._device import resolve_device

from . import prng

#: fold_in tag separating the fault root key from the sampler's trial keys
#: (ascii "faul")
_FAULT_ROOT = 0x6661756C
#: fold_in tag of the per-machine straggler draw (outside the round range)
_STRAGGLE_TAG = (1 << 31) - 2
#: fold_in tag of the per-trial bit-flip stream (row keys fold under it)
_FLIP_TAG = (1 << 31) - 1
#: elements (trials x rows x d) of one block of the flip draw
_FLIP_BLOCK = 1 << 24


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Declarative fault model for one sweep — frozen + hashable.

    Attributes:
      dropout: per-round probability a machine's payload is lost.
      straggle: probability an arriving machine is a straggler.
      straggle_frac: fraction of its rows a straggler delivers (prefix
        truncation, ``ceil(straggle_frac * n)`` rows).
      bitflip: per-bit flip probability on sign-method payloads.
      retries: extra wire rounds re-requesting dropped payloads (0 = the
        plain single-round wire).
      machines: number of machines the d features are partitioned over
        (contiguous equal blocks; must divide d). ``None`` = one machine
        per feature — the paper's topology.
      seed: root of the fault PRNG stream (independent of the sampler's
        ``seed0`` even when numerically equal).
    """

    dropout: float = 0.0
    straggle: float = 0.0
    straggle_frac: float = 0.5
    bitflip: float = 0.0
    retries: int = 0
    machines: int | None = None
    seed: int = 0

    def __post_init__(self):
        for name in ("dropout", "straggle", "bitflip"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p!r}")
            object.__setattr__(self, name, float(p))
        if not 0.0 < self.straggle_frac <= 1.0:
            raise ValueError(
                f"straggle_frac must be in (0, 1], got {self.straggle_frac!r}")
        object.__setattr__(self, "straggle_frac", float(self.straggle_frac))
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries!r}")
        object.__setattr__(self, "retries", int(self.retries))
        if self.machines is not None:
            if self.machines < 1:
                raise ValueError(
                    f"machines must be >= 1, got {self.machines!r}")
            object.__setattr__(self, "machines", int(self.machines))
        object.__setattr__(self, "seed", int(self.seed))

    @property
    def is_null(self) -> bool:
        """True when the plan can inject no fault at all. The engine still
        runs the fault path for a null plan, bit-identical to no plan."""
        return self.dropout == 0.0 and self.straggle == 0.0 \
            and self.bitflip == 0.0

    @property
    def channels(self) -> int:
        """Telemetry channels per trial: [machines dropped (after retries),
        machines straggling, retransmissions in retry round 1..R,
        retry-round-used indicator 1..R], all integer-valued."""
        return 2 + 2 * self.retries

    def n_machines(self, d: int) -> int:
        m = d if self.machines is None else self.machines
        if d % m != 0:
            raise ValueError(
                f"machines={m} must divide d={d} (contiguous equal blocks)")
        return m

    def feature_machines(self, d: int, device=None) -> torch.Tensor:
        """(d,) map feature index -> owning machine (contiguous blocks of
        d / machines features)."""
        m = self.n_machines(d)
        return (torch.arange(d, device=resolve_device(device)) * m) // d

    # ---- draws (trial/machine/round-keyed fold_in streams) ---------------

    def _machine_states(self, keys: torch.Tensor, m: int):
        """The per-machine fault states of (t, 2) trial keys: (arrived
        (t, m) bool, straggling (t, m) bool, still (t, m, retries+1)
        int32 — machine still missing after rounds 0..j). The fold_in
        order (machine keys -> per-round dropout uniforms -> straggler
        uniform) is ``repro``'s, which makes the draws its draws. The
        feature-partition view (:meth:`draw_batch`) and the MAC row-block
        view (:meth:`draw_rowblock_batch`) both read it, so with equal
        machine counts they realize the same machine fates."""
        dev = keys.device
        mkeys = prng.fold_in(keys[:, None, :], torch.arange(m, device=dev))
        rkeys = prng.fold_in(mkeys[:, :, None, :],
                             torch.arange(self.retries + 1, device=dev))
        dropped = prng.uniform(rkeys) < self.dropout        # (t, m, r+1)
        still = torch.cumprod(dropped.to(torch.int32), dim=-1)
        arrived = still[..., -1] == 0
        strag_u = prng.uniform(prng.fold_in(mkeys, _STRAGGLE_TAG))
        straggling = arrived & (strag_u < self.straggle)
        return arrived, straggling, still

    def _flip(self, keys: torch.Tensor, n_pad: int, d: int) -> torch.Tensor:
        """(t, n_pad, d) bit-flip masks, row-keyed (fold_in per sample row
        under each trial's flip tag), drawn in row blocks."""
        t = keys.shape[0]
        kf = prng.fold_in(keys, _FLIP_TAG)[:, None, :]
        flip = torch.empty((t, n_pad, d), dtype=torch.bool,
                           device=keys.device)
        step = max(1, _FLIP_BLOCK // max(1, t * d))
        for r0 in range(0, n_pad, step):
            r1 = min(n_pad, r0 + step)
            rows = prng.fold_in(kf, torch.arange(r0, r1, device=keys.device))
            flip[:, r0:r1] = prng.uniform(rows, (d,)) < self.bitflip
        return flip

    def draw_batch(self, keys: torch.Tensor, n_pad: int, n_valid: int,
                   d: int):
        """Stacked fault realizations for a trial batch.

        Args:
          keys: (t, 2) per-trial fault keys (:func:`fault_trial_keys`).
          n_pad: padded sample count (bucket shape).
          n_valid: true sample count.
          d: feature count.
        Returns:
          ``(n_rows, flip, telemetry)`` on the keys' device — (t, d) int32
          delivered-row counts per feature, (t, n_pad, d) bool bit-flip
          mask (``None`` when ``bitflip == 0``), and (t, channels) f32
          integer-valued telemetry.
        """
        m = self.n_machines(d)
        r = self.retries
        arrived, straggling, still = self._machine_states(keys, m)
        nv = torch.tensor(int(n_valid), dtype=torch.int32,
                          device=keys.device)
        n_trunc = torch.minimum(
            torch.ceil(self.straggle_frac * nv.to(torch.float32)).to(
                torch.int32), nv)
        n_m = torch.where(arrived, torch.where(straggling, n_trunc, nv),
                          torch.zeros_like(nv))                   # (t, m)
        n_rows = n_m[:, self.feature_machines(d, keys.device)]  # (t, d)
        missing = still[..., :r].sum(dim=1)                       # (t, r)
        tele = torch.cat([
            torch.stack([(~arrived).sum(dim=1), straggling.sum(dim=1)],
                        dim=1).to(torch.float32),
            missing.to(torch.float32), (missing > 0).to(torch.float32)],
            dim=1)
        flip = self._flip(keys, n_pad, d) if self.bitflip > 0.0 else None
        return n_rows, flip, tele

    def draw_rowblock_batch(self, keys: torch.Tensor, n_pad: int,
                            n_valid: int, machines: int) -> torch.Tensor:
        """The fault realization as the MAC channel sees it: (t, machines)
        int32 DELIVERED-ROW counts per sample-row block on the keys'
        device — a dropped machine is a missing summand (count 0), a
        straggler superposes only the prefix ``ceil(straggle_frac *
        its_valid_rows)`` of its block.

        Drawn from the same :meth:`_machine_states` stream as
        :meth:`draw_batch` (same keys, same fold_in order), so when
        ``machines == n_machines(d)`` both views realize identical
        machine fates. No telemetry: the sweep takes it from the one
        :meth:`draw_batch` call, so nothing is counted twice.
        """
        if n_pad % machines != 0:
            raise ValueError(
                f"machines={machines} must divide n_pad={n_pad}")
        b = n_pad // machines
        # machine m's valid rows under the contiguous row-block partition
        block_valid = torch.clamp(
            int(n_valid) - torch.arange(machines, dtype=torch.int32,
                                        device=keys.device) * b, 0, b)
        n_trunc = torch.minimum(
            torch.ceil(self.straggle_frac * block_valid.to(torch.float32))
            .to(torch.int32), block_valid)
        arrived, straggling, _ = self._machine_states(keys, machines)
        return torch.where(arrived,
                           torch.where(straggling, n_trunc, block_valid),
                           torch.zeros_like(block_valid))


@functools.lru_cache(maxsize=None)
def _fault_trial_keys(plan: FaultPlan, reps: int, device: str):
    root = prng.fold_in(prng.key(plan.seed, device=device), _FAULT_ROOT)
    return prng.fold_in(root, torch.arange(reps, device=device))


def fault_trial_keys(plan: FaultPlan, reps: int, *, device=None
                     ) -> torch.Tensor:
    """(reps, 2) per-trial fault keys: ``fold_in(fold_in(key(seed),
    _FAULT_ROOT), rep)`` — one fault stream per trial, rooted apart from
    the sampler's trial keys. Cached per (plan, reps, device)."""
    return _fault_trial_keys(plan, int(reps), str(resolve_device(device)))
