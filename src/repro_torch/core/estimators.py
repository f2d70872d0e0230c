"""Statistic estimators used by the central machine (paper §4.2, §5).

The port of ``repro.core.estimators``. Every pairwise
(d, d) statistic routes its Gram through
:class:`repro_torch.core.gram.GramEngine`; pass ``engine=`` to pin a
backend (``None`` = the default engine, which follows the operands'
device).

The declarative entry points decompose into the three stages every
pipeline shares:

* :func:`strategy_payload` — **encode**: raw samples -> the strategy's
  wire payload (±1 int8 signs, int8 bin codes, dense packed bits, or raw
  f32 for the unquantized baseline), valid-length masked;
* :func:`payload_gram`    — **central contraction**: payload -> (d, d)
  Gram, straight off the wire bytes where the format allows it;
* :func:`weights_from_gram` — **central estimate**: Gram + sample count
  -> Chow-Liu weights (eqs. 1/4/30), or :func:`corr_from_gram` -> the
  correlation statistic of the sparse plane's glasso solve
  (:func:`strategy_corr`, :func:`strategy_corr_batch`).

The fault plane's per-feature row counts (``n_rows``) and bit flips
(``flip``) thread the masked-Gram degradation path: each feature column
is prefix-masked to its own count, the packed sign wire is unpacked to
±1/0 int8 under ``n_rows``, and the weights divide by the per-entry
:func:`effective_counts` with voided entries at weight 0.

The channel plane (``repro_torch.comm.channel``) swaps the middle stage
for non-gather strategies; the four ``strategy_*`` entry points dispatch
on ``strategy.channel.kind``:

* **MAC superposition** (:func:`mac_weights_batch`) — the machines' row
  blocks of ±1 int8 signs, undelivered rows zeroed (pad rows, a fault
  realization's dropped or truncated blocks), contracted in one
  ``sign_corr`` launch: the sum of every machine's partial Gram, exact.
  The center normalizes by the delivered-row count.
* **bit budget** (:func:`budget_weights_batch`) — each feature column
  encoded at its machine's allocated rate (one ``quantize_fused`` launch
  a rate 1..cap, then a select), decoded at the center through the
  padded per-rate codebook table, and contracted as f32 values in a full
  f32 product (the per-rate codebooks differ, so the one-codebook
  ``code_corr`` kernel does not apply). Rate-0 columns count 0 samples.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch import trace
from repro_torch._device import resolve_device

from .glasso import nearest_correlation  # noqa: F401  (callers' import)
from .gram import GramEngine, resolve_engine
from .quantizers import (MASKED_CODE, PerSymbolQuantizer, pack_codes,
                         sign_bits, sign_codes, unpack_codes_u8,
                         valid_row_mask, valid_sample_mask)
from .strategy import Strategy


def _dim(n) -> int:
    return n.dim() if isinstance(n, torch.Tensor) else np.ndim(n)


def theta_hat(u: torch.Tensor, *, engine: GramEngine | None = None):
    """UMVE of theta_jk = Pr(u_j u_k = 1) from sign data (eq. 8):
    theta_hat = 1/2 + (U^T U) / (2n)."""
    n = u.shape[0]
    return 0.5 + resolve_engine(engine).gram(u) / (2.0 * n)


def theta_hat_packed(packed, n: int, *, engine: GramEngine | None = None):
    """theta_hat (eq. 8) straight from the 1-bit packed wire payload —
    (d, ceil(n/8)) uint8 — via the XOR + popcount Gram. Exact: equals
    :func:`theta_hat` on the unpacked u."""
    gram = resolve_engine(engine).packed_sign_gram(packed, n)
    return 0.5 + gram / (2.0 * n)


def theta_from_rho(rho) -> torch.Tensor:
    """theta = 1/2 + arcsin(rho)/pi (eq. 3)."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    return 0.5 + torch.arcsin(torch.clamp(rho, -1.0, 1.0)) / math.pi


def rho_from_theta(theta) -> torch.Tensor:
    """Inverse of eq. (3): rho = sin(pi (theta - 1/2))."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    return torch.sin(math.pi * (theta - 0.5))


def binary_entropy(p: torch.Tensor) -> torch.Tensor:
    """h(p) in bits (eq. 5), safe at {0, 1}."""
    # epsilon representable in f32: 1 - 1e-12 rounds to 1.0 in f32
    p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
    return -(p * torch.log2(p) + (1.0 - p) * torch.log2(1.0 - p))


def mi_sign(theta: torch.Tensor) -> torch.Tensor:
    """I(u_j; u_k) = 1 - h(theta) in bits (eq. 4)."""
    return 1.0 - binary_entropy(theta)


def mi_gaussian(rho: torch.Tensor) -> torch.Tensor:
    """I(x_j; x_k) = -1/2 ln(1 - rho^2) (eq. 1); the clip keeps the
    (MWST-irrelevant) diagonal finite in f32."""
    r2 = torch.clamp(torch.square(rho), 0.0, 1.0 - 1e-7)
    return -0.5 * torch.log1p(-r2)


def sample_correlation(u: torch.Tensor, *,
                       engine: GramEngine | None = None) -> torch.Tensor:
    """rho_bar_q = (1/n) sum_i u_j^(i) u_k^(i) (eqs. 31/32): the paper's
    estimator does not renormalize by the sample variances (variables are
    standardized, Q_jj = 1)."""
    return resolve_engine(engine).gram(u) / u.shape[0]


def rho_squared_unbiased(rho_bar, n):
    """Unbiased estimator of rho^2 (eq. 30): n/(n+1) (rho_bar^2 - 1/n)."""
    return (n / (n + 1.0)) * (torch.square(rho_bar) - 1.0 / n)


def sign_method_weights(u_signs: torch.Tensor, *,
                        engine: GramEngine | None = None) -> torch.Tensor:
    """Chow-Liu weights of the sign method, hat I(u_j; u_k) (eq. 4), from
    (n, d) ±1 signs."""
    return mi_sign(theta_hat(u_signs, engine=engine))


def sign_method_weights_packed(packed: torch.Tensor, n: int, *,
                               engine: GramEngine | None = None
                               ) -> torch.Tensor:
    """Sign-method weights straight from the 1-bit packed payload (no
    unpack): mi_sign(theta_hat_packed(...))."""
    return mi_sign(theta_hat_packed(packed, n, engine=engine))


def persymbol_method_weights(u_centroids: torch.Tensor, *,
                             engine: GramEngine | None = None
                             ) -> torch.Tensor:
    """Per-symbol weights (§5) from (n, d) centroid values: eq. (30) on the
    quantized sample correlation (eq. 32), through the Gaussian MI."""
    return weights_from_gram(resolve_engine(engine).gram(u_centroids),
                             u_centroids.shape[0], "persymbol")


def persymbol_code_weights(codes: torch.Tensor, centroids, *,
                           engine: GramEngine | None = None) -> torch.Tensor:
    """Per-symbol weights straight from (n, d) int8 bin codes and their
    codebook: the decode happens inside the Gram (``code_corr`` on the
    card)."""
    return weights_from_gram(resolve_engine(engine).code_gram(
        codes, centroids), codes.shape[0], "persymbol")


def gaussian_weights(x: torch.Tensor, *,
                     engine: GramEngine | None = None) -> torch.Tensor:
    """Centralized (unquantized) baseline: MI from the sample
    correlation."""
    return weights_from_gram(resolve_engine(engine).gram(x), x.shape[0],
                             "original")


def effective_counts(n_rows) -> torch.Tensor:
    """(..., d) per-feature delivered-row counts -> (..., d, d) effective
    PAIRWISE sample counts: n_eff[j, k] = min(n_rows[j], n_rows[k])."""
    counts = torch.as_tensor(n_rows, dtype=torch.float32)
    return torch.minimum(counts[..., :, None], counts[..., None, :])


def _as_count(n, like: torch.Tensor):
    """A sample count as ``weights_from_gram`` divides by it: python
    numbers stay python (f32 weak scalars), arrays become f32 tensors."""
    if isinstance(n, (int, float)):
        return n
    return torch.as_tensor(n, dtype=torch.float32, device=like.device)


def weights_from_gram(gram: torch.Tensor, n, method, *,
                      normalized: bool = False) -> torch.Tensor:
    """Central-machine estimate: raw Gram + sample count -> Chow-Liu weights.

    ``gram`` is the (..., d, d) contraction of what the wire delivered,
    ``n`` the sample count it sums over (a python int, an f32 scalar
    tensor, or the (..., d, d) per-entry count matrix of
    :func:`effective_counts`), ``method`` a method string or a Strategy.

    * ``'sign'``      — eq. 8 UMVE theta_hat -> MI of signs (eq. 4);
    * ``'persymbol'`` — eq. 32 correlation -> unbiased rho^2 (eq. 30) ->
      Gaussian MI (eq. 1);
    * ``'original'``  — sample correlation -> Gaussian MI (eq. 1).

    A per-entry ``n`` divides by max(n_eff, 1) and zeroes entries whose
    effective count is < 2. ``normalized=True`` declares that ``gram`` is
    already gram / max(n, 1).
    """
    gram = torch.as_tensor(gram)
    with trace.span("repro_torch.weights", gram.device):
        method = getattr(method, "method", method)
        n = _as_count(n, gram)
        n_eff = None
        if _dim(n) >= 2:
            n_eff = n
            n = torch.clamp(n_eff, min=1.0)
        if method == "original":
            w = mi_gaussian(gram if normalized else gram / n)
        elif method == "sign":
            # I(theta) = I(1 - theta): take theta from |gram| so that
            # Grams of opposite sign give the same bits on every device.
            # From theta and 1 - theta, h would round differently on each
            # side, and how depends on the device's log2: the MWST's
            # choice between two such exactly tied edges would then
            # differ between the card and the CPU.
            g = gram.abs()
            w = mi_sign((0.5 + g / 2.0) if normalized
                        else (0.5 + g / (2.0 * n)))
        elif method == "persymbol":
            rho_bar = gram if normalized else gram / n
            r2 = torch.clamp(rho_squared_unbiased(rho_bar, n), 0.0,
                             1.0 - 1e-7)
            w = -0.5 * torch.log1p(-r2)
        else:
            raise ValueError(f"unknown method {method!r}")
        if n_eff is not None:
            w = torch.where(n_eff >= 2.0, w, 0.0)
        return w


def corr_from_gram(gram: torch.Tensor, n, method) -> torch.Tensor:
    """Central estimate for SPARSE structures: raw Gram + sample count ->
    the correlation statistic a glasso solve ingests.

    * ``'original'`` / ``'persymbol'`` — gram / n (eqs. 31/32);
    * ``'sign'`` — rho = sin(pi * gram / (2n)), eigen-clipped back to a
      valid correlation matrix (:func:`nearest_correlation`).

    A per-entry ``n`` neutralizes degenerate entries (count < 2) to the
    identity's.
    """
    method = getattr(method, "method", method)
    gram = torch.as_tensor(gram)
    n = _as_count(n, gram)
    n_eff = None
    if _dim(n) >= 2:
        n_eff = n
        n = torch.clamp(n_eff, min=1.0)
    if method in ("original", "persymbol"):
        rho = gram / n
    elif method == "sign":
        rho = torch.sin(math.pi * gram / (2.0 * n))
    else:
        raise ValueError(f"unknown method {method!r}")
    if n_eff is not None:
        eye = torch.eye(gram.shape[-1], dtype=rho.dtype, device=rho.device)
        rho = torch.where(n_eff >= 2.0, rho, eye)
    if method == "sign":
        return nearest_correlation(rho)
    return rho


def _sample_mask(n_pad: int, n_valid, device) -> torch.Tensor:
    return valid_sample_mask(n_pad, n_valid, device)[:, None]


def _payload_mask(n_pad: int, n_valid, n_rows, device):
    """The encode stage's row mask: (..., n, d) per-feature prefixes under
    fault counts ``n_rows`` (which win: they are clamped to n_valid
    already), (n, 1) under bucketing, else None."""
    if n_rows is not None:
        return valid_row_mask(n_pad, n_rows)
    if n_valid is not None:
        return _sample_mask(n_pad, n_valid, device)
    return None


def _packs(strategy: Strategy, n: int) -> bool:
    """Whether :func:`strategy_payload` packs n samples densely: the
    packed wire of a quantized method, n a whole number of bytes."""
    return (strategy.method != "original" and strategy.wire == "packed"
            and n % (8 // strategy.rate) == 0)


def payload_layout(strategy: Strategy, n: int, d: int
                   ) -> tuple[tuple[int, ...], torch.dtype]:
    """(shape, dtype) of :func:`strategy_payload` on (n, d) samples,
    without drawing one: sample-major (n, d) f32 values or int8
    signs/codes, or a feature-major (d, n*R/8) uint8 packed wire."""
    if strategy.method == "original":
        return (n, d), torch.float32
    if _packs(strategy, n):
        return (d, n * strategy.rate // 8), torch.uint8
    return (n, d), torch.int8


def strategy_payload(x: torch.Tensor, strategy: Strategy, *, n_valid=None,
                     n_rows=None, flip=None) -> torch.Tensor:
    """Encode stage: raw (..., n, d) f32 samples -> the strategy's wire
    payload — exactly what the paper's machines transmit.

    Layouts (leading batch axes pass through):
      * values / signs / bin codes — sample-major ``(..., n, d)`` (f32 /
        int8 ±1 / int8 in [0, 2^R));
      * packed wires — feature-major ``(..., d, n*R/8)`` uint8. Sign
        payloads pack whenever ``strategy.packed_gram_ok(n)``; per-symbol
        payloads pack when ``(8 // rate) | n`` (else int8 codes).

    ``n_valid`` masks pad rows: values/signs to 0, bin codes to
    ``MASKED_CODE`` (packed wires carry pad symbols as 0 bits;
    :func:`payload_operand` restores the sentinel at the center).

    ``n_rows`` — a fault plan's (..., d) per-feature delivered-row counts
    — masks each feature column to its own prefix and wins over
    ``n_valid``. ``flip`` — the (..., n, d) bool bit-flip mask — flips
    sign-method payloads' bits; per-symbol and float wires ignore it.
    """
    with trace.span("repro_torch.encode", x.device, n=x.shape[-2]):
        n_pad = x.shape[-2]
        mask = _payload_mask(n_pad, n_valid, n_rows, x.device)

        if strategy.method == "original":
            return x if mask is None else torch.where(mask, x, 0.0)
        if strategy.method == "sign":
            if _packs(strategy, n_pad):
                bits = sign_bits(x)
                if flip is not None:
                    bits ^= flip
                if mask is not None:
                    bits &= mask
                return pack_codes(bits.transpose(-2, -1), 1)  # (., d, n/8)
            u = sign_codes(x)
            if flip is not None:
                u = torch.where(flip, -u, u)
            return u if mask is None else u.masked_fill_(~mask, 0)
        codes = PerSymbolQuantizer(strategy.rate).encode(x)
        if _packs(strategy, n_pad):
            # dense R-bit wire: pad symbols travel as code 0 (the center
            # re-masks them from n_valid before contracting)
            if mask is not None:
                codes = codes.masked_fill_(~mask, 0)
            return pack_codes(codes.transpose(-2, -1), strategy.rate)
        if mask is not None:
            codes = codes.masked_fill_(~mask, MASKED_CODE)
        return codes


def payload_operand(payload: torch.Tensor, strategy: Strategy, *,
                    n_valid=None, n_rows=None) -> torch.Tensor:
    """Wire payload -> the Gram operand the engine kernels ingest.

    Identity for every format the engine contracts natively (values, ±1
    signs, bin codes, 1-bit packed signs). The per-symbol packed wire is
    unpacked back to sample-major int8 bin codes with ``MASKED_CODE``
    restored on pad rows — integer-exact.

    Under fault counts ``n_rows`` the 1-bit packed sign wire is unpacked
    too, to ±1 int8 with undelivered rows 0: the packed Gram's uniform
    shift assumes one prefix length for every feature. Its integer Gram
    equals the packed one whenever the counts are uniform (the zero-fault
    bit-identity).
    """
    if payload.dtype != torch.uint8:
        return payload
    if strategy.method == "sign":
        if n_rows is None:
            return payload  # the packed Gram contracts the bytes directly
        u = unpack_codes_u8(payload, 1).transpose(-2, -1).to(
            torch.int8, memory_format=torch.contiguous_format)
        u.mul_(2).sub_(1)
        return u.masked_fill_(~valid_row_mask(u.shape[-2], n_rows), 0)
    if strategy.method != "persymbol":
        return payload
    # feature-major bytes -> sample-major int8 codes (a contiguous copy:
    # the Gram kernels read rows of samples)
    codes = unpack_codes_u8(payload, strategy.rate).transpose(
        -2, -1).contiguous().view(torch.int8)
    mask = _payload_mask(codes.shape[-2], n_valid, n_rows, codes.device)
    if mask is not None:
        codes = codes.masked_fill_(~mask, MASKED_CODE)
    return codes


def payload_gram(payload: torch.Tensor, strategy: Strategy, *, n_valid=None,
                 n_rows=None, payload_rows=None, n_rows_rows=None,
                 engine: GramEngine | None = None) -> torch.Tensor:
    """Central contraction: (gathered) wire payload -> (..., d, d) Gram.

    Batched payloads go through the engine's ``*_batch`` entry points.
    1-bit packed sign payloads are contracted DIRECTLY (XOR + popcount on
    the wire bytes); everything else goes through :func:`payload_operand`.
    ``payload_rows`` (a feature-slice payload of the same format) gives
    the rectangular (..., d_rows, d) block of those rows against the full
    payload. ``n_valid`` applies the integer-exact masked-count shift to
    the packed sign identity (G = n_valid - 2*popcount).

    ``n_rows`` / ``n_rows_rows`` are the fault plane's per-feature counts
    of the full payload and of the row slice: the packed sign wire then
    goes through :func:`payload_operand` (unpacked), and each Gram entry
    sums exactly its ``effective_counts(n_rows)`` surviving rows.
    """
    with trace.span("repro_torch.gram", payload.device):
        eng = resolve_engine(engine)
        batched = payload.ndim == 3

        if (strategy.method == "sign" and payload.dtype == torch.uint8
                and n_rows is None):
            n_pad = payload.shape[-1] * 8
            fn = (eng.packed_sign_gram_batch if batched
                  else eng.packed_sign_gram)
            if payload_rows is not None:
                gram = fn(payload_rows, n_pad, payload)
            else:
                gram = fn(payload, n_pad)
            if n_valid is not None:
                # pad bits are 0 in every row, so they xor away and only the
                # integer-exact shift to the true count remains
                gram = gram - (n_pad - torch.as_tensor(
                    n_valid, dtype=torch.float32, device=gram.device))
            return gram

        u = payload_operand(payload, strategy, n_valid=n_valid, n_rows=n_rows)
        rows = None
        if payload_rows is not None:
            rows = payload_operand(payload_rows, strategy, n_valid=n_valid,
                                   n_rows=n_rows_rows)
        if strategy.method == "persymbol":
            cb = PerSymbolQuantizer(strategy.rate).centroids_np
            fn = eng.code_gram_batch if batched else eng.code_gram
            if rows is not None:
                return fn(rows, cb, u)
            return fn(u, cb)
        fn = eng.gram_batch if batched else eng.gram
        return fn(u if rows is None else rows, u if rows is not None else None)


# --------------------------------------------------------------------------
# Channel plane: MAC superposition + budgeted rates
# --------------------------------------------------------------------------

def mac_delivered_rows(channel, n_pad: int, n_valid=None, *,
                       device=None) -> torch.Tensor:
    """Lossless per-machine delivered-row counts under the MAC row-block
    partition: machine m owns the padded rows ``[m*b, (m+1)*b)`` (``b =
    n_pad / machines``), so with ``n_valid`` real samples it delivers
    ``clip(n_valid - m*b, 0, b)`` of them. (machines,) int32 on
    ``device`` (default cuda); they sum to ``n_valid``. A FaultPlan's
    ``draw_rowblock_batch`` counts take their place under faults."""
    b = channel.block_rows(n_pad)
    nv = n_pad if n_valid is None else n_valid
    blocks = torch.arange(channel.machines, dtype=torch.int32,
                          device=resolve_device(device, nv))
    return torch.clamp(torch.as_tensor(nv, dtype=torch.int32,
                                       device=blocks.device) - blocks * b,
                       0, b)


def mac_sign_codes(x: torch.Tensor, strategy: Strategy, *, n_valid=None,
                   delivered=None, flip=None) -> torch.Tensor:
    """Encode stage of the MAC plane: raw (..., n, d) samples -> the ±1
    int8 sign codes the machines contract locally before their partial
    Grams superpose. Rows a machine did not deliver (pad rows, or the
    dropped / truncated blocks of a ``delivered`` fault realization) are
    zeroed: they superpose to nothing. Lossless, the keep mask is the
    valid-sample prefix, so the codes equal the gather sign payload bit
    for bit.

    ``delivered``: the (..., machines) per-block delivered-row counts
    (default :func:`mac_delivered_rows`), a tensor on x's device, so the
    mask is built on the device with no host read. ``flip`` flips sign
    bits as on the gather wire.
    """
    ch = strategy.channel
    n_pad = x.shape[-2]
    b = ch.block_rows(n_pad)
    u = sign_codes(x)
    if flip is not None:
        u = torch.where(flip, -u, u)
    if delivered is None:
        delivered = mac_delivered_rows(ch, n_pad, n_valid, device=x.device)
    rows = torch.arange(n_pad, device=x.device)
    counts = torch.as_tensor(delivered, dtype=torch.int32, device=x.device)
    keep = (rows % b) < counts[..., rows // b]          # (..., n_pad)
    return u.masked_fill_(~keep[..., None], 0)


def mac_effective_count(strategy: Strategy, n_pad: int, *, n_valid=None,
                        delivered=None, device=None) -> torch.Tensor:
    """Total sample count inside the superposed statistic: the sum of the
    delivered block rows, (...,) f32 — ``n_valid`` lossless, less when a
    fault realization dropped summands."""
    if delivered is None:
        delivered = mac_delivered_rows(strategy.channel, n_pad, n_valid,
                                       device=device)
    return torch.as_tensor(delivered, dtype=torch.int32).sum(dim=-1).to(
        torch.float32)


def mac_estimate(gram: torch.Tensor, strategy: Strategy, n_eff, *,
                 corr: bool = False) -> torch.Tensor:
    """Central estimate from the SUPERPOSED sum statistic, which is the
    masked Gram exactly: the effective count ``n_eff`` ((...,)) goes
    through the estimate tails' per-entry path, so degenerate trials
    (count < 2, e.g. every machine dropped) are neutralized as the fault
    plane's voided entries are."""
    n = torch.as_tensor(n_eff, dtype=torch.float32,
                        device=gram.device)[..., None, None]
    tail = corr_from_gram if corr else weights_from_gram
    return tail(gram, n, strategy)


def mac_weights_batch(x: torch.Tensor, strategy: Strategy, *, n_valid=None,
                      delivered=None, flip=None,
                      engine: GramEngine | None = None,
                      corr: bool = False) -> torch.Tensor:
    """The single-device MAC path: encode + mask, contract the masked
    codes in one launch (== the sum of every machine's partial Gram,
    exactly), estimate from the effective count."""
    u = mac_sign_codes(x, strategy, n_valid=n_valid, delivered=delivered,
                       flip=flip)
    eng = resolve_engine(engine)
    gram = (eng.gram_batch if u.ndim == 3 else eng.gram)(u)
    del u
    n_eff = mac_effective_count(strategy, x.shape[-2], n_valid=n_valid,
                                delivered=delivered, device=x.device)
    return mac_estimate(gram, strategy, n_eff, corr=corr)


def budget_centroid_table(cap: int) -> np.ndarray:
    """Host (cap+1, 2^cap) f32 padded codebook table of the mixed-rate
    decode: row r holds ``PerSymbolQuantizer(r)``'s centroids (zero-
    padded), row 0 is all zeros (a silent machine decodes to nothing)."""
    tbl = np.zeros((cap + 1, 1 << cap), np.float32)
    for r in range(1, cap + 1):
        cb = PerSymbolQuantizer(r).centroids_np
        tbl[r, : cb.shape[0]] = cb
    return tbl


@functools.lru_cache(maxsize=None)
def _flat_centroid_table(cap: int, device: str) -> torch.Tensor:
    return torch.from_numpy(budget_centroid_table(cap).reshape(-1)).to(device)


#: elements of one block of the mixed-rate decode: its transient int32
#: index is 4 bytes an element of the block, not of the whole payload
_DECODE_BLOCK = 1 << 24


def budget_payload(x: torch.Tensor, strategy: Strategy, rates, *,
                   n_valid=None, n_rows=None) -> torch.Tensor:
    """Encode stage of the budget plane: raw (..., n, d) samples + the
    (d,) per-FEATURE rate vector (``BudgetChannel.column_rates``) ->
    mixed-rate int8 bin codes. Each column is encoded at its own rate by
    a select over full-block encodes at rates 1..cap (the strategy's
    ``rate`` is the cap; one ``quantize_fused`` launch each on the card);
    rate-0 columns and undelivered rows carry ``MASKED_CODE``.
    Columnwise and rowwise ops only, so a feature-sliced encode followed
    by a gather reassembles the payload bit for bit."""
    n_pad = x.shape[-2]
    rates = torch.as_tensor(rates, dtype=torch.int32, device=x.device)
    out = torch.full(x.shape, MASKED_CODE, dtype=torch.int8, device=x.device)
    for r in range(1, strategy.rate + 1):
        out = torch.where(rates == r, PerSymbolQuantizer(r).encode(x), out)
    mask = _payload_mask(n_pad, n_valid, n_rows, x.device)
    return out if mask is None else out.masked_fill_(~mask, MASKED_CODE)


def budget_operand(codes: torch.Tensor, strategy: Strategy,
                   rates) -> torch.Tensor:
    """Mixed-rate decode at the center: int8 codes + (d,) rates -> f32
    centroid values ``tbl[rates, codes]`` through the flattened padded
    table, with ``MASKED_CODE`` entries 0 (they contract to nothing).

    One int32 index ``rate * 2^cap + code`` an element picks from the
    flat table (``MASKED_CODE`` picks the all-zero row 0), block by block
    of ``_DECODE_BLOCK`` elements, so no payload-sized int64 index is
    ever built."""
    cap = strategy.rate
    levels = 1 << cap
    tbl = _flat_centroid_table(cap, str(codes.device))
    r = torch.as_tensor(rates, dtype=torch.int32, device=codes.device)
    base = r.clamp(0, cap) * levels                     # (d,)
    d = codes.shape[-1]
    flat = codes.reshape(-1, d)
    out = torch.empty(flat.shape, dtype=torch.float32, device=codes.device)
    step = max(1, _DECODE_BLOCK // max(1, d))
    for r0 in range(0, flat.shape[0], step):
        c = flat[r0:r0 + step]
        idx = (base + c.clamp(0, levels - 1)).masked_fill_(
            c == MASKED_CODE, 0)
        out[r0:r0 + step] = tbl.index_select(0, idx.view(-1)).view(c.shape)
    return out.view(codes.shape)


def budget_counts(rates, n_pad: int, *, n_valid=None, n_rows=None,
                  device=None) -> torch.Tensor:
    """(..., d, d) effective pairwise counts under the rate allocation: a
    rate-0 column delivered nothing, so its count is 0 and the estimate
    tails neutralize its entries — the same degradation as a dropped
    machine. Composes with a fault realization's per-feature ``n_rows``."""
    dev = resolve_device(None, rates) if device is None else device
    rates = torch.as_tensor(rates, dtype=torch.int32, device=dev)
    if n_rows is not None:
        n_col = torch.as_tensor(n_rows, dtype=torch.int32,
                                device=rates.device)
    else:
        nv = n_pad if n_valid is None else n_valid
        n_col = torch.as_tensor(nv, dtype=torch.int32,
                                device=rates.device) * torch.ones_like(rates)
    return effective_counts(torch.where(rates > 0, n_col, 0))


def budget_estimate(codes: torch.Tensor, strategy: Strategy, rates, *,
                    n_valid=None, n_rows=None,
                    engine: GramEngine | None = None,
                    corr: bool = False) -> torch.Tensor:
    """Central contraction + estimate of the (gathered) mixed-rate
    payload: decode through :func:`budget_operand`, Gram through the
    engine (f32 values), normalize by :func:`budget_counts`."""
    vals = budget_operand(codes, strategy, rates)
    eng = resolve_engine(engine)
    gram = (eng.gram_batch if vals.ndim == 3 else eng.gram)(vals)
    del vals
    n = budget_counts(rates, codes.shape[-2], n_valid=n_valid, n_rows=n_rows,
                      device=gram.device)
    tail = corr_from_gram if corr else weights_from_gram
    return tail(gram, n, strategy)


def budget_weights_batch(x: torch.Tensor, strategy: Strategy, rates, *,
                         n_valid=None, n_rows=None,
                         engine: GramEngine | None = None,
                         corr: bool = False) -> torch.Tensor:
    """The single-device budget path: mixed-rate encode -> decode -> Gram
    -> estimate."""
    codes = budget_payload(x, strategy, rates, n_valid=n_valid,
                           n_rows=n_rows)
    return budget_estimate(codes, strategy, rates, n_valid=n_valid,
                           n_rows=n_rows, engine=engine, corr=corr)


def _channel_stat(x, strategy, *, corr, n_valid=None, n_rows=None,
                  flip=None, engine=None, rates=None, delivered=None):
    """The statistic of a non-gather channel strategy (None for gather):
    the head of every ``strategy_*`` entry point. Unbatched callers get
    the budget allocation at x's own sample count."""
    ch = strategy.channel
    if ch.kind == "mac":
        with trace.span("repro_torch.weights", x.device):
            return mac_weights_batch(x, strategy, n_valid=n_valid,
                                     delivered=delivered, flip=flip,
                                     engine=engine, corr=corr)
    if ch.kind == "budget":
        if rates is None:
            raise ValueError("budget-channel strategies need the (d,) "
                             "per-feature rates operand")
        with trace.span("repro_torch.weights", x.device):
            return budget_weights_batch(x, strategy, rates, n_valid=n_valid,
                                        n_rows=n_rows, engine=engine,
                                        corr=corr)
    return None


def _own_rates(x: torch.Tensor, strategy: Strategy):
    """The budget allocation of one unbatched (n, d) dataset (None for
    the other channels)."""
    ch = strategy.channel
    if ch.kind != "budget":
        return None
    return ch.column_rates(x.shape[0], x.shape[1], strategy.rate)


def strategy_weights(x: torch.Tensor, strategy: Strategy, *,
                     engine: GramEngine | None = None) -> torch.Tensor:
    """(n, d) raw samples -> (d, d) Chow-Liu weight matrix for a Strategy:
    :func:`strategy_payload` -> :func:`payload_gram` ->
    :func:`weights_from_gram`. Non-gather channels dispatch to their
    planes (a budget allocation at x's sample count)."""
    w = _channel_stat(x, strategy, corr=False, engine=engine,
                      rates=_own_rates(x, strategy))
    if w is not None:
        return w
    payload = strategy_payload(x, strategy)
    gram = payload_gram(payload, strategy, engine=engine)
    return weights_from_gram(gram, x.shape[0], strategy)


def _batch_gram(x, strategy, n_valid, n_rows, flip, engine):
    """The batched encode + Gram shared by the weights and corr stages:
    (Gram, the count it sums over)."""
    n_pad = x.shape[-2]
    payload = strategy_payload(x, strategy, n_valid=n_valid, n_rows=n_rows,
                               flip=flip)
    gram = payload_gram(payload, strategy, n_valid=n_valid, n_rows=n_rows,
                        engine=engine)
    if n_rows is not None:
        return gram, effective_counts(n_rows)
    return gram, (n_pad if n_valid is None else torch.as_tensor(
        n_valid, dtype=torch.float32, device=gram.device))


def strategy_weights_batch(x: torch.Tensor, strategy: Strategy, *,
                           n_valid=None, n_rows=None, flip=None,
                           engine: GramEngine | None = None, rates=None,
                           delivered=None) -> torch.Tensor:
    """(t, n, d) stacked raw samples -> (t, d, d) Chow-Liu weights, the
    trial axis through the Gram engine's ``*_batch`` entry points.

    ``n_valid`` enables shape bucketing: rows >= n_valid are padding,
    masked in :func:`strategy_payload`, and every normalization uses
    n_valid; integer-exact paths are bit-equal to the unpadded ones.

    ``n_rows`` / ``flip`` thread a ``FaultPlan`` realization: the Gram is
    prefix-masked per feature and the weights divide by the per-entry
    :func:`effective_counts`, voided entries (count < 2) at weight 0. A
    zero-fault realization (every count n_valid, no flip) is
    bit-identical to the faultless call.

    ``rates`` / ``delivered`` are the channel plane's operands: the (d,)
    per-feature rate vector of a budget strategy (required for it) and
    the (t, machines) delivered-row counts a fault plan draws for a MAC
    strategy. Gather strategies ignore both.
    """
    w = _channel_stat(x, strategy, corr=False, n_valid=n_valid,
                      n_rows=n_rows, flip=flip, engine=engine, rates=rates,
                      delivered=delivered)
    if w is not None:
        return w
    gram, n = _batch_gram(x, strategy, n_valid, n_rows, flip, engine)
    return weights_from_gram(gram, n, strategy)


def strategy_corr(x: torch.Tensor, strategy: Strategy, *,
                  engine: GramEngine | None = None) -> torch.Tensor:
    """(n, d) raw samples -> the (d, d) correlation statistic a sparse
    Strategy's glasso solve ingests: :func:`strategy_payload` ->
    :func:`payload_gram` -> :func:`corr_from_gram` (non-gather channels
    through their planes, as :func:`strategy_weights`)."""
    corr = _channel_stat(x, strategy, corr=True, engine=engine,
                         rates=_own_rates(x, strategy))
    if corr is not None:
        return corr
    payload = strategy_payload(x, strategy)
    gram = payload_gram(payload, strategy, engine=engine)
    return corr_from_gram(gram, x.shape[0], strategy)


def strategy_corr_batch(x: torch.Tensor, strategy: Strategy, *,
                        n_valid=None, n_rows=None, flip=None,
                        engine: GramEngine | None = None, rates=None,
                        delivered=None) -> torch.Tensor:
    """(t, n, d) stacked raw samples -> (t, d, d) correlation statistics
    of a sparse Strategy: :func:`strategy_weights_batch` with
    :func:`corr_from_gram` as the tail (the same bucketing, fault and
    channel operands; under a fault plan the per-entry
    :func:`effective_counts`, degenerate entries at the identity's)."""
    corr = _channel_stat(x, strategy, corr=True, n_valid=n_valid,
                         n_rows=n_rows, flip=flip, engine=engine,
                         rates=rates, delivered=delivered)
    if corr is not None:
        return corr
    gram, n = _batch_gram(x, strategy, n_valid, n_rows, flip, engine)
    return corr_from_gram(gram, n, strategy)
