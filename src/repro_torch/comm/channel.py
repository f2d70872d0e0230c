"""The wire's channel as a frozen plan value.

A copy of the gather half of ``repro.comm.channel``: the paper's lossless
all-gather, where every machine's message reaches the center as sent.
The multiple-access (superposition) and bit-budget channels arrive with
the port's wire plane; a :class:`~repro_torch.core.strategy.Strategy`
naming any other channel raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Channel:
    """Base of the channel family: frozen + hashable so it can ride a
    Strategy as a plan value."""

    #: family tag the estimator layer dispatches on
    kind = "gather"

    def validate(self, strategy) -> None:
        """Raise if ``strategy`` cannot run over this channel."""

    def check_plan(self, d: int, faults=None) -> None:
        """Raise if this channel cannot serve a sweep over ``d`` features
        (optionally composed with a ``FaultPlan``); ``TrialPlan``
        validation calls it. The gather channel serves any."""

    @property
    def suffix(self) -> str:
        """Label suffix appended to ``Strategy.label`` ('' for gather)."""
        return ""


@dataclasses.dataclass(frozen=True)
class GatherChannel(Channel):
    """The paper's wire: one lossless gather of every machine's payload."""

    kind = "gather"


#: the default channel shared by every Strategy that does not name one
GATHER = GatherChannel()
