"""Distributed structure learning over a mesh of ranks (the port of
``repro.core.distributed``).

The paper's topology — d leaf machines each holding one feature, a central
machine running Chow-Liu — maps onto a mesh as a *vertical* sharding:

  * features are sharded over the ``model`` mesh axis (each rank plays a
    block of the paper's machines M_j),
  * samples are sharded over the ``data`` mesh axis,
  * "transmit R-bit codes to the center" becomes: quantize locally, then
    **all-gather the codes over the model axis**; the gathered payload is
    the paper's communication cost (ndR bits, §3),
  * the center's Gram is a contraction every rank performs on its sample
    shard, followed by a **sum over the data axis**; the MWST then runs on
    the replicated weights.

``repro`` runs one controller and ``shard_map``s a body over the mesh;
here every rank is a process (``torch.distributed``) that calls the same
entry point on its own block, and the mesh is a ``DeviceMesh``
(``launch.mesh``) whose axis groups carry the collectives
(``comm.collectives``). Every rank returns the same tensor.

The runtime is three stages, carried by :class:`WirePlan`:

  * :meth:`WirePlan.encode`  — per-machine local quantization of the
    rank's feature slice (``estimators.strategy_payload``);
  * :meth:`WirePlan.wire`    — THE communication the paper counts, by the
    strategy's channel (``Channel.transmit``): the tiled all-gather over
    the model axis, or the MAC's superposing sum;
  * :meth:`WirePlan.central` — the center: the Gram of the gathered
    payload (``estimators.payload_gram``, placement-aware) and the
    Chow-Liu weights or the glasso precision.

:func:`build_weights_fn` composes them for one dataset;
``experiments.run_trials(plan, mesh=...)`` runs the same stages over the
trial plane. :class:`CommReport` / :func:`comm_report` set the paper's
logical n*d*R bits beside the bytes the wire moves: the gather wire from
the encode stage's payload layout (``estimators.payload_layout``), the
MAC wire from its (d, d) f32 sum statistic, the budget wire from its int8
code payload, each with its per-machine ledgers.

Every Gram goes through :class:`~repro_torch.core.gram.GramEngine` (the
CUDA kernels on a card). Two compute placements:

  * ``replicated``: every rank computes the full (d, d) Gram of its
    sample shard — one all-gather + one sum;
  * ``rowblock``: each model rank computes only its (d/M, d) row block
    (the kernels' rectangular path), and the row blocks are all-gathered
    at the end.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.comm.collectives import all_gather, neutral_fill, psum

from . import estimators, glasso
from .glasso import DEFAULT_STEPS as GLASSO_STEPS
from .gram import GramEngine
from .path import PathPlan, glasso_path_select
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
        runtime (the payload gather, + the rowblock row gather); 0 where
        no wire runtime ran (a single device, or a data-only mesh).
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


def _as_wire_strategy(strategy: Strategy | None, method: str, rate: int,
                      compute: str, wire: str) -> Strategy:
    """Normalize (strategy | loose kwargs) to the runtime's Strategy. The
    loose spelling ``wire='float32'`` (raw samples gathered, eq.-1
    weights) is the unquantized baseline: ``method='original'``."""
    if strategy is not None:
        return strategy
    if wire == "float32":
        return Strategy("original", placement=compute)
    return Strategy(method, rate=rate, wire=wire, placement=compute)


@dataclasses.dataclass(frozen=True)
class WirePlan:
    """Stage-decomposed wire runtime for one Strategy on a mesh.

    Frozen and hashable, as ``repro``'s. ``mesh`` is the
    ``DeviceMesh`` whose ``model_axis`` group carries the wire (and whose
    ``data_axis`` group sums the sample-sharded Gram): the stages that
    communicate take their group from it. Every rank of the mesh calls
    each stage on its own operands:

      ``encode`` (per machine) -> ``wire`` (THE collective) ->
      ``central`` (Gram + estimate at the center).

    Payloads may carry a leading batch axis (the trial plane's trials).
    ``engine`` pins the Gram backend; ``glasso_steps`` is the ISTA budget
    of a sparse strategy's central solve; ``path`` (a
    :class:`~repro_torch.core.path.PathPlan`) swaps that fixed-penalty
    solve for the warm-started lambda grid with EBIC selection.
    """

    strategy: Strategy
    data_axis: str = "data"
    model_axis: str = "model"
    engine: GramEngine | None = None
    glasso_steps: int = GLASSO_STEPS
    path: PathPlan | None = None
    mesh: object = None

    def _group(self, axis: str):
        if self.mesh is None:
            raise ValueError("this WirePlan stage communicates: give the "
                             "WirePlan its mesh")
        return self.mesh.get_group(axis)

    # ---- stage 1: local encoding, R bits/symbol (paper step 1) ----------

    def encode(self, x_loc: torch.Tensor, *, n_valid=None, n_rows=None,
               flip=None, rates=None) -> torch.Tensor:
        """Per-machine quantization of the rank's (..., n, d_loc) feature
        slice into its wire payload (``estimators.strategy_payload``
        layouts). ``n_valid`` is the trial plane's valid-length mask;
        ``n_rows`` / ``flip`` are this rank's feature slice of a fault
        realization (delivered-row counts, sign bit flips).

        ``rates`` is the budget channel's (d_loc,) slice of the per-feature
        rate allocation: the payload becomes the mixed-rate codes of
        ``estimators.budget_payload``. Gather/MAC strategies must not pass
        it.
        """
        s = self.strategy
        if s.channel.kind == "budget":
            if rates is None:
                raise ValueError(
                    "budget-channel encode needs this rank's rates slice")
            return estimators.budget_payload(x_loc, s, rates,
                                             n_valid=n_valid, n_rows=n_rows)
        if rates is not None:
            raise ValueError("rates= is the budget channel's operand")
        if s.wire == "packed" and x_loc.shape[-2] % (8 // s.rate):
            raise ValueError(
                f"packed wire needs the sample count to be a multiple of "
                f"{8 // s.rate} (got {x_loc.shape[-2]}); bucket n (pow2 "
                f"buckets always qualify) or use the int8 wire")
        return estimators.strategy_payload(x_loc, s, n_valid=n_valid,
                                           n_rows=n_rows, flip=flip)

    # ---- stage 2: transmit to center == all-gather over model (step 2) --

    def feature_axis(self, payload: torch.Tensor) -> int:
        """Index of the feature axis in a payload (packed wires are
        feature-major, everything else sample-major)."""
        return payload.ndim - (2 if payload.dtype == torch.uint8 else 1)

    def wire(self, payload: torch.Tensor, keep=None) -> torch.Tensor:
        """THE communication the paper counts, by the strategy's channel
        (``strategy.channel.transmit``) over the model axis: the tiled
        all-gather of the payload for gather/budget channels (the full
        feature dimension in rank order, bit-identical to encoding the
        unsliced data), the superposing sum for the MAC channel (the
        payload is then this rank's partial statistic).

        ``keep`` — optional (..., d_loc) bool per-feature survival flags
        (a fault plan's ``n_rows > 0``): the gather still runs, but a
        dropped machine's entries arrive as the format's masked value
        (``comm.collectives.erasure_all_gather`` with
        ``comm.collectives.neutral_fill``).
        """
        return self.strategy.channel.transmit(
            payload, self._group(self.model_axis),
            axis=self.feature_axis(payload), keep=keep,
            fill=neutral_fill(self.strategy.method, payload.dtype))

    # ---- stage 3: central statistic + weights (paper step 3) ------------

    def central(self, payload_full: torch.Tensor, n, *, n_valid=None,
                n_rows=None, n_rows_own=None, own_payload=None,
                data_sharded: bool = False) -> torch.Tensor:
        """The center: the Gram of the gathered payload and the central
        estimate, through the same ``estimators`` stages every other
        pipeline runs — the Chow-Liu weights (``weights_from_gram``) for
        a tree strategy, the glasso precision of the correlation
        statistic (``corr_from_gram``) for a sparse one (the path-selected
        one under ``path``).

        ``n`` is the sample count of the normalization (ignored under
        ``n_rows``, the fault plan's (..., d) full-feature delivered-row
        counts, which select the masked Gram and the per-entry
        ``effective_counts``). ``n_rows_own`` is this rank's slice of
        ``n_rows`` and ``own_payload`` its pre-gather payload: the row
        block under ``rowblock``. ``data_sharded``: samples are sharded
        over the data axis, so the Gram is summed over it.
        """
        s = self.strategy
        gram = self._assemble_gram(payload_full, n_valid=n_valid,
                                   n_rows=n_rows, n_rows_own=n_rows_own,
                                   own_payload=own_payload,
                                   data_sharded=data_sharded)
        if n_rows is not None:
            n = estimators.effective_counts(n_rows)
        if s.structure == "sparse":
            corr = estimators.corr_from_gram(gram, n, s)
            if self.path is not None:
                # EBIC's likelihood scale is the sample count; under the
                # fault plane's per-entry counts, their mean
                n_eff = torch.as_tensor(n, dtype=torch.float32,
                                        device=corr.device).mean()
                return glasso_path_select(corr, self.path, n_eff,
                                          n_steps=self.glasso_steps)[0]
            solve = glasso.glasso_batch if corr.ndim == 3 else glasso.glasso
            return solve(corr, s.lam, n_steps=self.glasso_steps)
        return estimators.weights_from_gram(gram, n, s)

    def _assemble_gram(self, payload_full, *, n_valid=None, n_rows=None,
                       n_rows_own=None, own_payload=None,
                       data_sharded: bool = False) -> torch.Tensor:
        """The center's full (..., d, d) Gram of the gathered payload:
        the placement-aware contraction, the sum over the data axis and
        the rowblock row gather. ``n_rows`` / ``n_rows_own`` select the
        fault plane's per-feature masked contraction."""
        s = self.strategy
        rows = own_payload if s.placement == "rowblock" else None
        gram = estimators.payload_gram(
            payload_full, s, n_valid=n_valid, n_rows=n_rows,
            payload_rows=rows,
            n_rows_rows=n_rows_own if rows is not None else None,
            engine=self.engine)
        if data_sharded:
            gram = psum(gram, self._group(self.data_axis))
        if s.placement == "rowblock":
            gram = all_gather(gram, self._group(self.model_axis),
                              gram.ndim - 2)
        # (``repro`` also takes a pmean over the model axis here when the
        # Gram is replicated, only to show its checker the replication:
        # every rank already holds the same Gram, so there is none here)
        return gram

    def central_corr(self, payload_full: torch.Tensor, n, *, n_valid=None,
                     n_rows=None, n_rows_own=None, own_payload=None,
                     data_sharded: bool = False) -> torch.Tensor:
        """The center's PRE-SOLVE statistic of a sparse strategy: the
        Gram of the gathered payload and ``estimators.corr_from_gram``,
        without the glasso solve. The sparse trial plane and the path
        runtime end their collectives here and solve as one device does,
        so their supports equal the mesh-less run's."""
        s = self.strategy
        if s.structure != "sparse":
            raise ValueError("central_corr is the sparse center")
        gram = self._assemble_gram(payload_full, n_valid=n_valid,
                                   n_rows=n_rows, n_rows_own=n_rows_own,
                                   own_payload=own_payload,
                                   data_sharded=data_sharded)
        if n_rows is not None:
            n = estimators.effective_counts(n_rows)
        return estimators.corr_from_gram(gram, n, s)

    def central_from_sum(self, gram_sum: torch.Tensor, n_eff, *,
                         corr: bool = False) -> torch.Tensor:
        """The MAC center: the channel delivered the SUPERPOSED sum of
        every machine's partial sign Gram, so the estimate is a function
        of the sum and the effective sample count alone
        (``estimators.mac_estimate``)."""
        if self.strategy.channel.kind != "mac":
            raise ValueError("central_from_sum is the MAC channel's center")
        return estimators.mac_estimate(gram_sum, self.strategy, n_eff,
                                       corr=corr)

    # ---- composed runtime + accounting ----------------------------------

    def _sample_count(self, x_loc: torch.Tensor) -> int:
        return x_loc.shape[0] * self.mesh.size(
            self.mesh.mesh_dim_names.index(self.data_axis))

    def local_weights(self, x_loc: torch.Tensor) -> torch.Tensor:
        """The sample+feature sharded runtime: this rank's (n_loc, d_loc)
        block -> the (d, d) estimate every rank returns (the body
        :func:`build_weights_fn` returns)."""
        n = self._sample_count(x_loc)
        payload = self.encode(x_loc)
        full = self.wire(payload)
        return self.central(full, n, own_payload=payload, data_sharded=True)

    def local_corr(self, x_loc: torch.Tensor) -> torch.Tensor:
        """:meth:`local_weights` ending at the correlation statistic
        (:meth:`central_corr`): the path runtime's collectives."""
        n = self._sample_count(x_loc)
        payload = self.encode(x_loc)
        full = self.wire(payload)
        return self.central_corr(full, n, own_payload=payload,
                                 data_sharded=True)

    def comm_report(self, n: int, d: int, *,
                    n_pad: int | None = None) -> CommReport:
        """Communication accounting of one (n, d) evaluation
        (:func:`comm_report`)."""
        return comm_report(self.strategy, n, d, n_pad=n_pad)


def build_weights_fn(mesh, *, strategy: Strategy | None = None,
                     method: Literal["sign", "persymbol"] = "sign",
                     rate: int = 1, data_axis: str = "data",
                     model_axis: str = "model",
                     compute: Literal["replicated", "rowblock"] = "replicated",
                     wire: Literal["int8", "packed", "float32"] = "int8",
                     engine: GramEngine | None = None,
                     glasso_steps: int = GLASSO_STEPS,
                     path: PathPlan | None = None):
    """The wire pipeline of one dataset: ``(fn, sharding)``, where
    ``sharding`` (``data.ggm.vertical_sharding(mesh)``) cuts the global
    (n, d) samples to this rank's (n/D, d/M) block and ``fn`` maps that
    block to the (d, d) central estimate — the Chow-Liu weights, or the
    glasso precision of a sparse strategy (``glasso_steps`` ISTA steps;
    ``path`` swaps the fixed-penalty solve for the warm-started path with
    EBIC selection, solved after the collectives). Every rank of the mesh
    calls ``fn`` and gets the same estimate.

    ``strategy`` wins over the loose ``method``/``rate``/``compute``/
    ``wire`` kwargs. Wires: 'int8' (one byte a symbol), 'packed' (dense R
    bits a symbol; the sign Gram contracts it directly), 'float32' (raw
    samples). Placements: 'replicated' or 'rowblock'.
    """
    from repro_torch.data.ggm import vertical_sharding

    strat = _as_wire_strategy(strategy, method, rate, compute, wire)
    if strat.channel.kind != "gather":
        raise ValueError(
            "build_weights_fn is the gather-wire runtime; MAC/budget "
            "channel strategies run through experiments.run_trials (the "
            "trial plane threads their rate/delivered operands)")
    if path is not None and strat.structure != "sparse":
        raise ValueError(
            "path= is the sparse plane's regularization-path engine; "
            "tree strategies have no penalty to select")
    plan = WirePlan(strat, data_axis=data_axis, model_axis=model_axis,
                    engine=engine, glasso_steps=glasso_steps, path=path,
                    mesh=mesh)
    sharding = vertical_sharding(mesh, data_axis, model_axis)
    if path is None:
        return plan.local_weights, sharding

    def fused_path(x_loc):
        corr = plan.local_corr(x_loc)
        n = torch.tensor(plan._sample_count(x_loc), dtype=torch.float32,
                         device=corr.device)
        return glasso_path_select(corr, path, n, n_steps=glasso_steps)[0]

    return fused_path, sharding


def distributed_weights(x, mesh, *, strategy: Strategy | None = None,
                        method: Literal["sign", "persymbol"] = "sign",
                        rate: int = 1, data_axis: str = "data",
                        model_axis: str = "model",
                        compute: Literal["replicated",
                                         "rowblock"] = "replicated",
                        wire: Literal["int8", "packed",
                                      "float32"] = "int8",
                        engine: GramEngine | None = None,
                        glasso_steps: int = GLASSO_STEPS,
                        path: PathPlan | None = None,
                        device=None) -> torch.Tensor:
    """Central estimate from vertically sharded data: the Chow-Liu
    weights, or the glasso precision of a sparse strategy (path-selected
    under ``path=``). Every rank passes the global (n, d) samples ``x``
    (a tensor decides the device; host arrays go to ``device``, default
    cuda), keeps its (n/D, d/M) block — the paper's vertical partition —
    and returns the (d, d) estimate, the same on every rank."""
    fn, sharding = build_weights_fn(
        mesh, strategy=strategy, method=method, rate=rate,
        data_axis=data_axis, model_axis=model_axis, compute=compute,
        wire=wire, engine=engine, glasso_steps=glasso_steps, path=path)
    x = as_tensor(x, resolve_device(device, x), torch.float32)
    return fn(sharding(x))


def distributed_learn_structure(x, mesh, *, strategy: Strategy | None = None,
                                method: Literal["sign",
                                                "persymbol"] = "sign",
                                rate: int = 1, backend: str | None = None,
                                **kw) -> list[tuple[int, int]]:
    """End-to-end distributed structure learning: the estimated edges.

    Tree strategies return the Chow-Liu MWST edges; sparse strategies
    return the glasso support edges (``glasso.support`` at ``kw['tol']``
    if given). ``path=PathPlan(...)`` in ``kw`` makes them the
    EBIC-selected structure. The MWST solver is ``backend`` if given,
    else ``strategy.mst``, else the on-device Boruvka.
    """
    from .chow_liu import adjacency_to_edges, boruvka_mst, kruskal_mst

    if strategy is not None and strategy.structure == "sparse":
        if backend is not None:
            raise ValueError(
                "backend= names an MWST solver; sparse strategies recover "
                "a glasso support (tune tol= instead)")
        tol = kw.pop("tol", glasso.SUPPORT_TOL)
        w = distributed_weights(x, mesh, strategy=strategy, method=method,
                                rate=rate, **kw)
        return adjacency_to_edges(glasso.support(w, tol))
    w = distributed_weights(x, mesh, strategy=strategy, method=method,
                            rate=rate, **kw)
    if backend is None:
        backend = strategy.mst if strategy is not None else "boruvka"
    if backend == "boruvka":
        return adjacency_to_edges(boruvka_mst(w))
    return kruskal_mst(w)
