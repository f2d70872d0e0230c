"""The wire's channel as a frozen plan value.

A copy of the plan values of ``repro.comm.channel``: the channel is an
axis of the design space that rides on
:class:`~repro_torch.core.strategy.Strategy` (``strategy.channel``)
beside method, rate, wire and placement.

* :class:`GatherChannel` — the paper's lossless all-gather, where every
  machine's message reaches the center as sent (the default).
* :class:`MACChannel` — a multiple-access channel (arXiv 1812.10437):
  machines hold contiguous sample-row blocks and the center receives
  only the SUM of their local sign Grams. Sign Grams are integers in
  f32, so the sum is exact in any order: a lossless MAC equals the
  gathered sign statistic bit for bit. A dropped machine is a missing
  summand.
* :class:`BudgetChannel` — per-machine code rates under a total bit
  budget B (arXiv 2001.08877), allocated by deterministic greedy
  level-filling: the next bit level goes to the lowest-rate machine
  whose increment still fits B. Machines whose budget ran out at rate 0
  stay silent.

On one device the estimators (``core.estimators.mac_*`` / ``budget_*``)
compute what these channels deliver. Across ranks, each channel's
:meth:`Channel.transmit` performs its collective over a process group
(``comm.collectives``): the gather, the MAC sum, the budget's int8 code
gather.

Plan values (dataclasses + numpy): this module imports nothing of the
port at module level, so ``core.strategy`` can import it at
class-definition time; the collectives are imported inside
``transmit``.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Channel:
    """Base of the channel family: frozen + hashable so it can ride a
    Strategy as a plan value. Subclasses pin the validity envelope
    (:meth:`validate`, :meth:`check_plan`) and the label suffix."""

    #: family tag the estimator layer dispatches on
    kind = "gather"

    def validate(self, strategy) -> None:
        """Raise if ``strategy`` cannot run over this channel. Called by
        ``Strategy.__post_init__`` after method/wire normalization."""

    def check_plan(self, d: int, faults=None) -> None:
        """Raise if this channel cannot serve a sweep over ``d`` features
        (optionally composed with a ``FaultPlan``); ``TrialPlan``
        validation calls it. The gather channel serves any."""

    @property
    def suffix(self) -> str:
        """Label suffix appended to ``Strategy.label`` ('' for gather)."""
        return ""

    def transmit(self, payload, group, *, axis: int, keep=None, fill=0):
        """THE communication this channel performs: reassemble the ranks'
        payloads over ``group`` along ``axis``. ``keep``/``fill`` are the
        fault plane's erasure: a dropped machine's entries arrive as the
        format's neutral fill (``comm.collectives.neutral_fill``)."""
        from .collectives import all_gather, erasure_all_gather

        if keep is None:
            return all_gather(payload, group, axis)
        return erasure_all_gather(payload, group, keep, axis=axis,
                                  fill=fill)


@dataclasses.dataclass(frozen=True)
class GatherChannel(Channel):
    """The paper's wire: one lossless gather of every machine's payload."""

    kind = "gather"


@dataclasses.dataclass(frozen=True)
class MACChannel(Channel):
    """Multiple-access superposition wire (arXiv 1812.10437): ``machines``
    sample-row blocks each transmit their local integer sign Gram and the
    center receives only the SUM. Restricted to the sign method on the
    int8 wire — integer Grams are what make the superposition exact."""

    machines: int = 2
    kind = "mac"

    def __post_init__(self):
        if self.machines < 1:
            raise ValueError(
                f"MACChannel needs machines >= 1, got {self.machines!r}")
        object.__setattr__(self, "machines", int(self.machines))

    def validate(self, strategy) -> None:
        if strategy.method != "sign" or strategy.wire != "int8":
            raise ValueError(
                "MACChannel superposes integer sign statistics: it needs "
                f"method='sign' on the 'int8' wire, got method="
                f"{strategy.method!r} wire={strategy.wire!r}")
        if strategy.placement != "replicated":
            raise ValueError(
                "MACChannel has no per-machine payload to row-block; "
                "use placement='replicated'")

    def check_plan(self, d: int, faults=None) -> None:
        if faults is not None and faults.n_machines(d) != self.machines:
            raise ValueError(
                f"a FaultPlan composes with MAC through shared machine "
                f"states: channel.machines={self.machines} must equal "
                f"faults.n_machines(d)={faults.n_machines(d)}")

    @property
    def suffix(self) -> str:
        return f"@mac{self.machines}"

    def block_rows(self, n_pad: int) -> int:
        """Rows per machine block at padded sample count ``n_pad``."""
        if n_pad % self.machines != 0:
            raise ValueError(
                f"MACChannel machines={self.machines} must divide the "
                f"padded sample count {n_pad} (pow2 buckets: use a "
                f"power-of-two machine count)")
        return n_pad // self.machines

    def transmit(self, payload, group, *, axis: int = 0, keep=None, fill=0):
        """Superpose the ranks' partial statistics: the MAC sum."""
        from .collectives import superposed_psum

        return superposed_psum(payload, group)


@dataclasses.dataclass(frozen=True)
class BudgetChannel(Channel):
    """Total-bit-budget wire (arXiv 2001.08877): ``machines`` contiguous
    feature blocks share ``budget_bits`` total bits per evaluation, with
    per-machine rates from :meth:`allocate`. Restricted to the per-symbol
    method on the int8 wire; the strategy's ``rate`` is the per-machine
    CAP."""

    budget_bits: int = 0
    machines: int = 2
    kind = "budget"

    def __post_init__(self):
        if self.budget_bits < 1:
            raise ValueError(
                f"BudgetChannel needs budget_bits >= 1, got "
                f"{self.budget_bits!r}")
        if self.machines < 1:
            raise ValueError(
                f"BudgetChannel needs machines >= 1, got {self.machines!r}")
        object.__setattr__(self, "budget_bits", int(self.budget_bits))
        object.__setattr__(self, "machines", int(self.machines))

    def validate(self, strategy) -> None:
        if strategy.method != "persymbol" or strategy.wire != "int8":
            raise ValueError(
                "BudgetChannel re-allocates per-symbol code rates: it "
                "needs method='persymbol' on the 'int8' wire, got method="
                f"{strategy.method!r} wire={strategy.wire!r}")
        if strategy.placement != "replicated":
            raise ValueError(
                "BudgetChannel centers decode the full mixed-rate payload;"
                " use placement='replicated'")

    def check_plan(self, d: int, faults=None) -> None:
        if d % self.machines != 0:
            raise ValueError(
                f"BudgetChannel machines={self.machines} must divide "
                f"d={d} (contiguous equal feature blocks)")

    @property
    def suffix(self) -> str:
        return f"@bgt{self.budget_bits}"

    def allocate(self, n: int, d: int, cap: int) -> tuple[int, ...]:
        """Deterministic greedy level-filling rate allocation.

        Machine m owns ``d / machines`` features; raising its rate by one
        bit costs ``n * d_m`` wire bits. Bits go to the lowest-rate
        machine first (ties broken by machine index) while the increment
        fits the remaining budget, capped at ``cap``. A function of (n,
        d, cap, budget_bits) only. Returns the (machines,) rate tuple;
        ``sum(n * d_m * r_m) <= budget_bits`` (rate-0 machines are
        silent).
        """
        m = self.machines
        if d % m != 0:
            raise ValueError(
                f"machines={m} must divide d={d} (equal feature blocks)")
        d_m = d // m
        step = int(n) * d_m  # bits per +1 rate on one machine
        rates = np.zeros(m, np.int64)
        remaining = int(self.budget_bits)
        while remaining >= step and step > 0:
            order = np.lexsort((np.arange(m), rates))
            i = next((j for j in order if rates[j] < cap), None)
            if i is None:
                break
            rates[i] += 1
            remaining -= step
        return tuple(int(r) for r in rates)

    def column_rates(self, n: int, d: int, cap: int) -> np.ndarray:
        """(d,) int32 per-FEATURE rate vector: the machine allocation
        repeated over each machine's contiguous feature block — the
        operand the encode and decode stages consume."""
        rates = self.allocate(n, d, cap)
        return np.repeat(np.asarray(rates, np.int32), d // self.machines)


#: the default channel shared by every Strategy that does not name one
GATHER = GatherChannel()
