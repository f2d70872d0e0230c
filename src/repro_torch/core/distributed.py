"""Communication accounting of the wire (the port of the accounting half of
``repro.core.distributed``).

:class:`CommReport` sets the paper's logical n*d*R bits beside the bytes
the wire actually moves, and the retry policy's measured cost.
:func:`comm_report` fills one in for every channel without drawing a
payload: the gather wire from the encode stage's payload layout
(``estimators.payload_layout``), the MAC wire from its (d, d) f32 sum
statistic, the budget wire from its int8 code payload, each with its
per-machine ledgers. ``WirePlan``'s stages, the mesh runtime and
``distributed_learn_structure`` arrive with the port's mesh runtime.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import estimators
from .strategy import Strategy


def communication_bits(n: int, d: int, rate: int) -> int:
    """The paper's LOGICAL communication cost: n*d*R bits (§3).

    This is the idealized budget (R information bits per symbol); what a
    given wire format actually moves is ``Strategy.wire_bits(n, d)``.
    """
    return n * d * rate


@dataclasses.dataclass(frozen=True)
class CommReport:
    """Honest communication accounting for one weights evaluation.

    Attributes:
      logical_bits: the paper's idealized n*d*R budget (§3) for the true
        sample count n.
      wire_bytes: bytes the gather assembles at the center, from the
        encode stage's payload layout at the shape the sweep gathers (so
        bucket padding, int8 framing and float32 wires all show up).
      collectives: collectives one weights evaluation issues in the wire
        runtime (the payload gather, + the rowblock row gather); 0 on a
        single device.
      retry_bytes: MEAN bytes per trial re-sent by the fault plane's
        retry policy, measured from the realized retransmission counts.
      retry_collectives: mean extra gather rounds per trial that carried
        at least one retransmission.
      retry_rounds: the configured retry budget (``FaultPlan.retries``).
      rates, machine_bits: the per-machine ledgers of the MAC and budget
        channels; ``None`` on the gather wire.
    """

    logical_bits: int
    wire_bytes: int
    collectives: int
    retry_bytes: float = 0.0
    retry_collectives: float = 0.0
    retry_rounds: int = 0
    rates: tuple[int, ...] | None = None
    machine_bits: tuple[int, ...] | None = None

    @property
    def wire_bits(self) -> int:
        return 8 * self.wire_bytes

    @property
    def retry_bits(self) -> float:
        """Measured mean retransmitted bits per trial (8 * retry_bytes)."""
        return 8.0 * self.retry_bytes

    @property
    def overhead(self) -> float:
        """wire bits / logical bits — 1.0 means the wire is as dense as
        the paper's budget. Retry bits are excluded."""
        return 8.0 * self.wire_bytes / max(self.logical_bits, 1)


def comm_report(strategy: Strategy, n: int, d: int, *,
                n_pad: int | None = None) -> CommReport:
    """Communication accounting of one (n, d) evaluation: ``wire_bytes``
    at the bucket ``n_pad`` the sweep ran (padding costs real bytes),
    ``logical_bits`` at the true n.

    * gather — the payload layout's bytes;
    * MAC — the center receives one superposed (d, d) f32 statistic; the
      ``machine_bits`` ledger bills each machine its delivered sign rows
      (its 1-bit airtime), ``rates`` is 1 for every machine;
    * budget — the (n_pad, d) int8 code payload, with the allocation's
      per-machine rates and bits (``sum(machine_bits) == logical_bits <=
      budget_bits``).
    """
    n_wire = n if n_pad is None else n_pad
    ch = strategy.channel
    if ch.kind == "mac":
        b = ch.block_rows(n_wire)
        delivered = [max(0, min(n - m * b, b)) for m in range(ch.machines)]
        return CommReport(
            logical_bits=communication_bits(n, d, strategy.rate),
            wire_bytes=d * d * 4, collectives=1,
            rates=(1,) * ch.machines,
            machine_bits=tuple(r * d for r in delivered))
    if ch.kind == "budget":
        rates = ch.allocate(n, d, strategy.rate)
        d_m = d // ch.machines
        machine_bits = tuple(n * d_m * r for r in rates)
        return CommReport(
            logical_bits=sum(machine_bits), wire_bytes=n_wire * d,
            collectives=1, rates=rates, machine_bits=machine_bits)
    shape, dtype = estimators.payload_layout(strategy, n_wire, d)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return CommReport(
        logical_bits=communication_bits(n, d, strategy.rate),
        wire_bytes=math.prod(shape) * itemsize,
        collectives=1 + (strategy.placement == "rowblock"))
