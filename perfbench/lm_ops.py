"""Which layer of an LM prefill a device operation of the trace belongs
to, by its name, in one place for every LM reader.

* ``attention``: the port's ``flash_prefill`` kernels
  (``flash_prefill_wgmma<...>``, ``flash_prefill_f32<...>``);
* ``matmul``: cuBLAS and CUTLASS GEMMs (``nvjet_*``, ``sm90_xmma_gemm_*``,
  ``cutlass*``, names with ``gemm``) and cuBLAS's split-K reduction;
* ``elementwise``: everything else: norms, RoPE, SwiGLU's product, the
  embedding's gather, casts, copies into the cache, memsets.
"""
from __future__ import annotations

import re

ATTENTION = re.compile(r"flash_prefill")
MATMUL = re.compile(r"gemm|nvjet|xmma|cutlass|splitKreduce", re.IGNORECASE)


def layer(name: str) -> str:
    if ATTENTION.search(name):
        return "attention"
    if MATMUL.search(name):
        return "matmul"
    return "elementwise"


def seconds(ops: dict, which: str) -> float:
    """The summed seconds of the operations of layer ``which``."""
    return sum(s for name, s in ops.items() if layer(name) == which)


def per_call(ctx) -> tuple[dict, int] | None:
    """(every device operation's seconds, the calls traced) of a traced
    LM run on the card, or None."""
    p = ctx.profile
    if ctx.unit != "token" or p is None or not ctx.on_card \
            or not p.get("ops") or not p.get("calls"):
        return None
    return p["ops"], p["calls"]
