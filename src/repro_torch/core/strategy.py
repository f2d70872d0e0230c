"""Declarative estimation strategy: the front door of every pipeline.

A copy of ``repro.core.strategy``. A :class:`Strategy` pins down one
point of the paper's design space — quantization method x bit rate x wire
format x compute placement x MWST solver — as a single frozen, hashable
value; ``label`` matches the paper-figure legend names ("sign",
"R1".."R7", "original"), with the channel's suffix ("sign@mac4",
"R4@bgt49152") for the MAC and bit-budget channels.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.comm.channel import GATHER, Channel

Method = Literal["sign", "persymbol", "original"]
Wire = Literal["int8", "packed", "float32"]
Placement = Literal["replicated", "rowblock"]
Mst = Literal["boruvka", "kruskal"]
Structure = Literal["tree", "sparse"]

_METHODS = ("sign", "persymbol", "original")
_WIRES = ("int8", "packed", "float32")
_PLACEMENTS = ("replicated", "rowblock")
_MSTS = ("boruvka", "kruskal")
_STRUCTURES = ("tree", "sparse")


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One point of the method x rate x wire x placement x mst design space.

    Attributes:
      method: 'sign' (1-bit signs, §4) | 'persymbol' (R-bit quantizer, §5)
        | 'original' (unquantized baseline, eq. 1).
      rate: bits per symbol for 'persymbol' (1..7 on an int8 wire; must
        divide 8 for a packed wire). Forced to 1 for 'sign'.
      wire: transmitted format — 'int8' (one byte per code), 'packed'
        (dense R bits/symbol, the paper's budget), 'float32' (raw samples;
        forced for 'original').
      placement: distributed Gram placement — 'replicated' or 'rowblock'.
      mst: central MWST solver — 'boruvka' (on-device) or 'kruskal' (host
        reference). Both break ties identically.
      structure: 'tree' (Chow-Liu MWST) or 'sparse' (graphical lasso, §7).
      lam: l1 penalty of the glasso solve (sparse structures only).
      channel: the wire's channel model (``repro_torch.comm.channel``) —
        the default :class:`~repro_torch.comm.channel.GatherChannel` is
        the paper's lossless all-gather;
        :class:`~repro_torch.comm.channel.MACChannel` superposes machine
        sign Grams (sign method, int8 wire only);
        :class:`~repro_torch.comm.channel.BudgetChannel` allocates
        per-machine rates under a total bit budget (persymbol method,
        int8 wire; ``rate`` is the per-machine cap).
    """

    method: Method = "sign"
    rate: int = 1
    wire: Wire = "int8"
    placement: Placement = "replicated"
    mst: Mst = "boruvka"
    structure: Structure = "tree"
    lam: float = 0.0
    channel: Channel = GATHER

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(f"unknown method {self.method!r}")
        if self.structure not in _STRUCTURES:
            raise ValueError(f"unknown structure {self.structure!r}")
        if self.structure == "sparse":
            if not self.lam > 0.0:
                raise ValueError(
                    f"sparse structures need a glasso penalty lam > 0, "
                    f"got {self.lam!r}")
            object.__setattr__(self, "lam", float(self.lam))
        elif self.lam != 0.0:
            raise ValueError(
                f"lam is the sparse-structure glasso penalty; got "
                f"lam={self.lam!r} with structure='tree' (did you mean "
                f"structure='sparse'?)")
        if self.wire not in _WIRES:
            raise ValueError(f"unknown wire {self.wire!r}")
        if self.placement not in _PLACEMENTS:
            raise ValueError(f"unknown placement {self.placement!r}")
        if self.mst not in _MSTS:
            raise ValueError(f"unknown mst backend {self.mst!r}")
        if self.method == "sign":
            object.__setattr__(self, "rate", 1)
        elif self.method == "original":
            # unquantized baseline: raw f32 samples are the wire
            object.__setattr__(self, "wire", "float32")
            object.__setattr__(self, "rate", 32)
        else:
            if not 1 <= self.rate <= 7:
                raise ValueError(
                    f"persymbol rate must be in [1, 7], got {self.rate}")
            if self.wire == "packed" and 8 % self.rate != 0:
                raise ValueError(
                    f"packed wire needs rate | 8, got {self.rate}")
        if self.method != "original" and self.wire == "float32":
            raise ValueError("float32 wire is the unquantized baseline; "
                             "use method='original'")
        if not isinstance(self.channel, Channel):
            raise TypeError(
                f"channel must be a repro_torch.comm.channel.Channel, got "
                f"{type(self.channel)!r}")
        # the channel vetoes (method, wire, placement) combinations it
        # cannot carry, after the normalizations above
        self.channel.validate(self)

    @property
    def label(self) -> str:
        """Legend name used across the paper figures and result tables."""
        if self.method == "sign":
            base = "sign"
        elif self.method == "original":
            base = "original"
        else:
            base = f"R{self.rate}"
        if self.structure == "sparse":
            base = f"{base}+glasso{self.lam:g}"
        return base + self.channel.suffix

    @property
    def bits_per_symbol(self) -> int:
        """ACTUAL wire cost per transmitted symbol for this wire format:
        R on the dense 'packed' wire, 8 on 'int8', 32 on 'float32'."""
        if self.wire == "packed":
            return self.rate
        return 32 if self.wire == "float32" else 8

    def logical_bits(self, n: int, d: int) -> int:
        """The paper's idealized communication budget: n * d * R bits (§3)."""
        return n * d * self.rate

    def wire_bits(self, n: int, d: int) -> int:
        """Bits an (n, d) dataset ACTUALLY moves under this wire format."""
        return n * d * self.bits_per_symbol

    def communication_bits(self, n: int, d: int) -> int:
        """Alias of :meth:`wire_bits`."""
        return self.wire_bits(n, d)

    def packed_gram_ok(self, n: int) -> bool:
        """True when the dense packed payload of ``n`` samples can feed the
        Gram engine directly (XOR + popcount, no unpack): sign method,
        packed wire, and n a multiple of the 8-symbol byte granularity."""
        return self.method == "sign" and self.wire == "packed" and n % 8 == 0


def as_strategy(strategy: Strategy | None, **kw) -> Strategy:
    """Normalize the (strategy | loose kwargs) calling conventions."""
    if strategy is not None:
        if kw:
            strategy = dataclasses.replace(strategy, **kw)
        return strategy
    return Strategy(**kw)


#: The six-curve suite of Fig. 3 — the paper's headline comparison.
FIG3_STRATEGIES: tuple[Strategy, ...] = (
    Strategy("sign"),
    Strategy("persymbol", rate=1),
    Strategy("persymbol", rate=2),
    Strategy("persymbol", rate=3),
    Strategy("persymbol", rate=4),
    Strategy("original"),
)
