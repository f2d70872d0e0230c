"""The trial plane: batched Monte-Carlo sweeps on one device or over a
mesh of ranks (the port of ``repro.core.experiments``).

The paper's results are Monte-Carlo estimates — Pr(T_hat != T) over many
(tree, data, method, R, n) trials (Figs. 3-11). :func:`run_trials` runs
a whole :class:`TrialPlan` as batched device work:

* **Shape bucketing** — each n is padded up to a bucket (powers of two by
  default) and a valid-length mask runs through sampler -> quantizer ->
  Gram -> weights. The sampler draws row i of trial k from
  ``fold_in(keys[k], i)`` (``sampler.sample_tree_ggm_rows_batch``, the
  port's threefry in ``core.prng``), so a padded draw equals the
  unpadded one on its valid rows, and the port draws ``repro``'s trials.
* **Batched kernel grids** — every strategy's weights come from the trial
  axis through ``GramEngine``'s ``*_batch`` entry points (one kernel
  launch a strategy and point on the card), and the MWST + metric stage
  is one (S*reps, d, d) Boruvka solve with a fixed round count.
* **One device->host transfer a sweep** — the metric sums (and the fault
  telemetry) stay on the device until the single read-back at the end;
  ``TrialResult.host_syncs`` counts the reads.
* **Faults** — a :class:`~repro_torch.core.faults.FaultPlan` injects
  machine dropout, straggler truncation and sign bit flips, drawn from
  ``repro``'s fold_in streams, and the center degrades through the
  masked-Gram path; a zero-fault plan is bit-identical to none.
* **Sparse plane** (the paper's §7 extension) — strategies with
  ``structure="sparse"`` sweep random sparse precision ground truths
  (``tree="sparse"``) through the same sample -> quantize -> Gram chain
  into correlation statistics, and the MWST stage becomes one batched
  glasso solve of every point's (S*reps, d, d) stack at once
  (``glasso.glasso_batch``; point by point, as ``repro`` solves, where
  all of them do not fit half the memory budget) with the support
  thresholded on partial correlations; five integer support
  channels give precision, recall and micro-F1 exactly. A ``path=``
  plan (``path.PathPlan``) solves a warm-started lambda grid instead and
  selects by EBIC or StARS on the device; the full path's channels ride
  the same read-back onto ``TrialResult.path``.

``mst="host_kruskal"`` reads the weights back once and runs host Kruskal
and numpy metrics per trial (metric-identical to the device path).
:func:`evaluate_strategies` scores strategies on one dataset, and
:func:`mc_sign_crossover` / :func:`mc_persymbol_corr_error` are the
scalar Monte-Carlo engines of Figs. 5-6, 8 and 9.

The glasso solver waits for the host in every step (``torch.linalg.eigh``
checks its status there) and, for a path plan, polls an all-lanes-done
flag; ``host_syncs`` counts the sweep's result reads, which stay 1.

Strategies of every channel sweep together: a MAC strategy's delivered
rows come from the plan's fault stream as row blocks
(``FaultPlan.draw_rowblock_batch``), a budget strategy's allocation at
each point's true n rides one (S, d) rate upload a point.

Under a mesh (``launch.mesh``; every rank calls ``run_trials`` with the
same plan) the sweep runs on ``torch.distributed``:

* 1-D ``("data",)`` — the rep axis is sharded over the data axis: rank r
  takes reps ``[r*reps/D, (r+1)*reps/D)``, whose keys draw exactly the
  trials the mesh-less sweep draws (row-keyed samplers), and the metric
  sums and fault telemetry (integer-valued f32) are summed over the axis
  exactly.
* 2-D ``("data", "model")`` — the DISTRIBUTED trial plane: reps over
  data and features over model. Each rank samples its reps' full-feature
  rows, keeps its feature block and runs the wire runtime
  (``distributed.WirePlan``: encode -> all-gather -> central; the MAC's
  row-share partial Grams -> sum; the budget's per-rate encode -> code
  gather -> table decode).

Sparse plans end the collectives at the correlation statistics, which
are gathered over the data axis; every rank then solves them as the
mesh-less sweep does, so metrics equal the mesh-less run's. Every rank
returns the same result, with one read-back.

Torch has no trace compile, so ``repro``'s compile caches and their
warm-up threads have no counterpart; the per-plan setup cache (trees and
keys, per device) takes their place in :func:`compile_cache_size` and
:func:`clear_compile_caches`.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import trace
from repro_torch._device import as_tensor, resolve_device
from repro_torch.comm.collectives import all_gather, psum

from . import estimators, faults as faults_mod, glasso, prng, sampler, trees
from . import path as path_engine
from .chow_liu import boruvka_mst, boruvka_mst_batch, kruskal_mst
from .distributed import CommReport, WirePlan, comm_report
from .faults import FaultPlan, fault_trial_keys
from .gram import (GramConfig, GramEngine, default_memory_budget,
                   gram_working_set_bytes, resolve_engine)
from .path import PathPlan
from .quantizers import PerSymbolQuantizer
from .strategy import FIG3_STRATEGIES, Strategy

TREE_KINDS = ("random", "star", "chain", "skeleton")
#: ground-truth generators of the sparse trial plane: random sparse
#: precision matrices (``glasso.random_sparse_precision``)
SPARSE_KINDS = ("sparse",)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (and >= 8, the packed-wire byte floor)."""
    return max(8, 1 << max(int(n) - 1, 1).bit_length())


def _gram_path(s: Strategy) -> str:
    """Which GramEngine path a strategy's payload contracts through
    (the key of ``gram.gram_working_set_bytes``)."""
    if s.method == "original":
        return "f32"
    if s.method == "sign":
        return "packed" if s.wire == "packed" else "int8"
    return "code"


# --------------------------------------------------------------------------
# Declarative sweep plan + result
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrialPlan:
    """A full Monte-Carlo sweep: reps trials per (strategy, n) point.

    Trial ``rep`` draws its tree and edge correlations from
    ``np.random.default_rng(seed0 + rep)`` — topology per ``tree`` kind,
    correlations Uniform[rho_min, rho_max] — and its samples from the key
    ``fold_in(key(seed0), rep)``, folded again per sample row.

    ``n_buckets``: ``"pow2"`` (default) pads each n to the next power of
    two; an explicit tuple gives the bucket sizes (each n takes the
    smallest bucket >= n); ``None`` runs exact shapes.

    ``faults``: an optional :class:`FaultPlan` (``None`` = pristine wire).
    ``memory_budget_bytes``: the per-device budget the sweep's working
    sets must fit (``None`` = ``gram.default_memory_budget()``): pow2
    padding backs off to the minimal 8-multiple, the Gram engine streams
    (:meth:`budget_engine`) and the MWST stage runs in slabs
    (:meth:`metrics_chunk`) where the monolithic forms would not fit.

    Sparse plans (``tree="sparse"`` with sparse strategies) draw trial
    ``rep``'s precision from the same rng (``density``, strengths
    Uniform[rho_min, rho_max]) and solve ``glasso_steps`` ISTA steps,
    thresholding partial correlations at ``glasso_tol``; ``path`` (a
    :class:`~repro_torch.core.path.PathPlan`) solves and selects from a
    lambda grid instead of the strategies' ``lam``.
    """

    d: int
    ns: tuple[int, ...]
    strategies: tuple[Strategy, ...] = FIG3_STRATEGIES
    reps: int = 30
    tree: str = "random"
    rho_min: float = 0.4
    rho_max: float = 0.9
    seed0: int = 0
    n_buckets: tuple[int, ...] | str | None = "pow2"
    #: edge density of the sparse ground truth (sparse plans only)
    density: float = 0.2
    #: partial-correlation support threshold of the sparse metric stage
    glasso_tol: float = glasso.SUPPORT_TOL
    #: ISTA iteration budget of the batched glasso solve
    glasso_steps: int = glasso.DEFAULT_STEPS
    faults: FaultPlan | None = None
    memory_budget_bytes: int | None = None
    #: regularization-path plan of the sparse plane (None = fixed lam)
    path: PathPlan | None = None

    def __post_init__(self):
        if self.tree not in TREE_KINDS + SPARSE_KINDS:
            raise ValueError(f"unknown tree kind {self.tree!r}")
        if self.tree == "skeleton" and self.d != 20:
            raise ValueError("skeleton topology is the 20-joint body")
        if self.reps < 1 or self.d < 2:
            raise ValueError("need reps >= 1 and d >= 2")
        object.__setattr__(self, "ns", tuple(int(n) for n in self.ns))
        object.__setattr__(self, "strategies", tuple(self.strategies))
        structures = {s.structure for s in self.strategies}
        if len(structures) > 1:
            raise ValueError(
                "a plan must be homogeneous in Strategy.structure (tree "
                f"and sparse metrics differ), got {sorted(structures)}")
        if (self.tree in SPARSE_KINDS) != (structures == {"sparse"}):
            raise ValueError(
                f"tree kind {self.tree!r} does not match the strategies' "
                f"structure {sorted(structures)}: sparse strategies sweep "
                "over tree='sparse' ground truths and vice versa")
        if self.tree in SPARSE_KINDS and not 0.0 < self.density <= 1.0:
            raise ValueError(f"density must be in (0, 1], got {self.density}")
        nb = self.n_buckets
        if isinstance(nb, str):
            if nb != "pow2":
                raise ValueError(f"unknown bucketing scheme {nb!r}")
        elif nb is not None:
            nb = tuple(sorted(int(b) for b in nb))
            if not nb or nb[0] < 1:
                raise ValueError(f"invalid n_buckets {self.n_buckets!r}")
            if self.ns and max(self.ns) > nb[-1]:
                raise ValueError(
                    f"n_buckets {nb} do not cover max(ns)={max(self.ns)}")
            object.__setattr__(self, "n_buckets", nb)
        if self.faults is not None:
            if not isinstance(self.faults, FaultPlan):
                raise TypeError(
                    f"faults must be a FaultPlan, got {type(self.faults)!r}")
            self.faults.n_machines(self.d)  # machines must divide d
        for s in self.strategies:
            s.channel.check_plan(self.d, self.faults)
        if (self.memory_budget_bytes is not None
                and self.memory_budget_bytes <= 0):
            raise ValueError(
                f"memory_budget_bytes must be positive, "
                f"got {self.memory_budget_bytes}")
        if self.path is not None:
            if not isinstance(self.path, PathPlan):
                raise TypeError(
                    f"path must be a PathPlan, got {type(self.path)!r}")
            if self.tree not in SPARSE_KINDS:
                raise ValueError(
                    "path plans ride the sparse plane: TrialPlan(path=...) "
                    "requires tree='sparse' + sparse strategies")

    @property
    def effective_memory_budget(self) -> int:
        """The budget plan decisions run against (bytes): the explicit
        ``memory_budget_bytes`` or ``gram.default_memory_budget()``."""
        if self.memory_budget_bytes is not None:
            return self.memory_budget_bytes
        return default_memory_budget()

    def stage_bytes(self, n_pad: int, *, backend: str = "torch",
                    config: GramConfig | None = None) -> int:
        """Analytic peak transient bytes of one weights stage at bucket
        ``n_pad``: the (reps, n_pad, d) f32 samples, the worst strategy's
        Gram working set and the (S, reps, d, d) f32 stage output."""
        samples = 4 * self.reps * n_pad * self.d
        gram_ws = max(
            gram_working_set_bytes(
                _gram_path(s), n_pad, self.d, backend=backend,
                config=config, batch=self.reps)
            for s in self.strategies)
        out = 4 * len(self.strategies) * self.reps * self.d * self.d
        return samples + gram_ws + out

    def bucket_for(self, n: int) -> int:
        """The padded sample count the weights stage runs at. Under
        ``"pow2"``, when the stage's working set at the pow2 bucket
        exceeds the budget, padding backs off to the minimal 8-multiple;
        explicit buckets and ``None`` are respected as given."""
        if self.n_buckets is None:
            return n
        if self.n_buckets == "pow2":
            b = next_pow2(n)
            floor_b = max(8, -(-n // 8) * 8)
            if (b > floor_b
                    and self.stage_bytes(b) > self.effective_memory_budget):
                return floor_b
            return b
        for b in self.n_buckets:
            if b >= n:
                return b
        raise ValueError(f"no bucket >= {n} in {self.n_buckets}")

    def budget_engine(self, engine: GramEngine, device=None) -> GramEngine:
        """Clamp ``engine``'s streaming knobs to the plan's memory budget.

        If the monolithic Gram working set at the largest bucket exceeds
        half the budget, returns a copy with the largest (d_tile, n_chunk)
        whose working set fits. Engines with explicit d_tile/n_chunk are
        returned unchanged. ``device`` (default cuda) decides what an
        ``auto`` engine runs: the kernels on a card, torch on the CPU.
        """
        if (engine.d_tile is not None or engine.n_chunk is not None
                or not self.ns):
            return engine
        backend = engine.backend
        if backend == "auto":
            dev = resolve_device(device)
            backend = "kernel" if dev.type == "cuda" else "torch"
        budget = self.effective_memory_budget // 2
        n_max = max(self.bucket_for(n) for n in self.ns)
        paths = {_gram_path(s) for s in self.strategies}

        def worst(cfg: GramConfig) -> int:
            return max(
                gram_working_set_bytes(p, n_max, self.d, backend=backend,
                                       config=cfg, batch=self.reps)
                for p in paths)

        if worst(GramConfig()) <= budget:
            return engine
        for t in (1024, 512, 256, 128):
            if t >= self.d:
                continue
            for nc in (None, 8192, 2048):
                cfg = GramConfig(d_tile=t, n_chunk=nc)
                if worst(cfg) <= budget:
                    return dataclasses.replace(
                        engine, d_tile=t, n_chunk=nc)
        # nothing fits the declared budget: stream as hard as we can
        return dataclasses.replace(
            engine, d_tile=min(128, self.d), n_chunk=1024)

    def metrics_chunk(self) -> int | None:
        """Slab size of the MWST or glasso stage (``None`` = one batch of
        all S*reps trials): the per-trial solver scratch (~10 (d, d) f32
        planes, and a path solve's K (d, d) bool supports) of a slab must
        fit half the budget."""
        trials = len(self.strategies) * self.reps
        per_trial = 40 * self.d * self.d
        if self.path is not None:
            per_trial = (40 + self.path.k) * self.d * self.d
        budget = self.effective_memory_budget // 2
        if trials * per_trial <= budget:
            return None
        return max(1, min(trials, budget // per_trial))

    @property
    def buckets(self) -> dict[int, int]:
        """n -> padded bucket for every sweep point."""
        return {n: self.bucket_for(n) for n in self.ns}

    @property
    def structure(self) -> str:
        """'tree' or 'sparse' — which trial plane the plan runs on."""
        return "sparse" if self.tree in SPARSE_KINDS else "tree"

    @property
    def points(self) -> int:
        return len(self.ns) * len(self.strategies)

    @property
    def trials(self) -> int:
        return self.points * self.reps


@dataclasses.dataclass
class TrialResult:
    """Per-(strategy, n) Monte-Carlo metrics + engine telemetry."""

    plan: TrialPlan
    #: label -> [Pr(T_hat != T) per n in plan.ns]
    error_rate: dict[str, list[float]]
    #: label -> [mean edge symmetric difference |E_hat ^ E| per n]
    edit_distance: dict[str, list[float]]
    #: label -> [edge F1 per n]: mean shared edges / (d - 1) for trees,
    #: micro-F1 2*shared/(est+true) for sparse supports
    edge_f1: dict[str, list[float]]
    seconds: float
    #: device->host reads the whole sweep performed: exactly 1
    host_syncs: int
    #: label -> [edge precision per n] (== recall == F1 for trees;
    #: micro-averaged shared/est for sparse supports)
    precision: dict[str, list[float]] = dataclasses.field(
        default_factory=dict)
    #: label -> [edge recall per n]
    recall: dict[str, list[float]] = dataclasses.field(default_factory=dict)
    #: label -> [CommReport per n]: logical n*d*R bits beside the bytes
    #: the wire gathers at the bucket the sweep ran (and, under a fault
    #: plan with retries, the measured retry bytes and rounds)
    comm: dict[str, list[CommReport]] = dataclasses.field(default_factory=dict)
    #: n -> padded bucket the weights stage ran at
    buckets: dict[int, int] = dataclasses.field(default_factory=dict)
    #: setup-cache entries live after this sweep (:func:`compile_cache_size`)
    compile_cache_size: int = 0
    #: fault plans only: per-n realized fault telemetry means — ``{"n",
    #: "dropped_machines", "straggling_machines", "retransmissions",
    #: "retry_rounds_used"}`` — measured from the sweep's draws
    faults: list[dict] | None = None
    #: ``{"memory_budget_bytes", "d_tile", "n_chunk", "metrics_chunk"}``:
    #: the streaming knobs the sweep ran with (None = monolithic)
    tiling: dict = dataclasses.field(default_factory=dict)
    #: path plans only: ``{"select", "k", "lams" (label -> per-n mean
    #: grids), "error_rate" / "edge_f1" (label -> per-n per-lam curves),
    #: "iters" (label -> per-n mean solver steps per lam),
    #: "selected_hist" (label -> per-n selection counts per lam)}``; the
    #: headline metrics score the selected support. None otherwise.
    path: dict | None = None
    #: ranks of the mesh the sweep ran under (1 = one device; on a 2-D
    #: wire mesh data * model)
    mesh_devices: int = 1

    @property
    def trials_per_s(self) -> float:
        return self.plan.trials / max(self.seconds, 1e-9)


# --------------------------------------------------------------------------
# Host setup: stacked trees + trial keys (O(reps * d), cached per plan)
# --------------------------------------------------------------------------

def _draw_tree(kind: str, d: int, rng: np.random.Generator):
    if kind == "random":
        return trees.random_tree(d, rng)
    if kind == "star":
        return trees.star_tree(d)
    if kind == "chain":
        return trees.chain_tree(d)
    return list(trees.SKELETON_EDGES)


@functools.lru_cache(maxsize=None)
def _host_setup(d: int, reps: int, tree: str, rho_min: float,
                rho_max: float, seed0: int):
    """(parents, rhos) of the plan's trees as (reps, d) numpy arrays."""
    parents = np.zeros((reps, d), np.int32)
    rhos = np.zeros((reps, d), np.float32)
    for rep in range(reps):
        rng = np.random.default_rng(seed0 + rep)
        edges = _draw_tree(tree, d, rng)
        w = rng.uniform(rho_min, rho_max, size=d - 1)
        parents[rep], rhos[rep], _ = trees.topological_parents(d, edges, w)
    return parents, rhos


@functools.lru_cache(maxsize=None)
def _plan_setup(d: int, reps: int, tree: str, rho_min: float, rho_max: float,
                seed0: int, device: str):
    """Cached device setup: (parents, rhos, adj_true, keys) on ``device``.

    Keyed on the plan fields the ground truth depends on (not ns,
    strategies or buckets) and on the device, so repeated sweeps of a
    plan skip the host tree loop, the uploads and the key folds."""
    parents, rhos = _host_setup(d, reps, tree, rho_min, rho_max, seed0)
    parents_t = torch.from_numpy(parents).to(device)
    keys = prng.fold_in(prng.key(seed0, device=device),
                        torch.arange(reps, device=device))
    return (parents_t, torch.from_numpy(rhos).to(device),
            trees.adjacency_from_parents(parents_t), keys)


def _setup_key(plan: TrialPlan):
    return (plan.d, plan.reps, plan.tree, plan.rho_min, plan.rho_max,
            plan.seed0)


def stacked_trees(plan: TrialPlan, *, device=None):
    """``(parents, rhos, adj_true)`` of the plan's ``reps`` ground-truth
    trees, (reps, d), (reps, d) and (reps, d, d), on ``device`` (default
    cuda). Cached per plan and device with the trial keys. Sparse plans
    have no trees: see :func:`sparse_ground_truth`."""
    if plan.structure == "sparse":
        raise ValueError(
            "sparse plans draw precision-matrix ground truths, not trees; "
            "use sparse_ground_truth(plan)")
    return _plan_setup(*_setup_key(plan), str(resolve_device(device)))[:3]


def trial_keys(plan: TrialPlan, *, device=None) -> torch.Tensor:
    """(reps, 2) keys: one sampling stream per trial (``fold_in(key(seed0),
    rep)``), from the same cache as the plan's ground truths."""
    dev = str(resolve_device(device))
    if plan.structure == "sparse":
        return _sparse_plan_setup(*_sparse_setup_key(plan), dev)[2]
    return _plan_setup(*_setup_key(plan), dev)[3]


@functools.lru_cache(maxsize=None)
def _sparse_host_setup(d: int, reps: int, density: float, rho_min: float,
                       rho_max: float, seed0: int):
    """(chols, adj) of the plan's sparse ground truths as (reps, d, d)
    numpy arrays: trial ``rep`` draws ``glasso.random_sparse_precision``
    from ``np.random.default_rng(seed0 + rep)`` (strengths Uniform[rho_min,
    rho_max]); ``chols`` are the float64 Cholesky factors of its
    covariance cast to f32, ``adj`` its support."""
    chols = np.zeros((reps, d, d), np.float32)
    adj = np.zeros((reps, d, d), bool)
    for rep in range(reps):
        rng = np.random.default_rng(seed0 + rep)
        theta = glasso.random_sparse_precision(
            d, density, rng, strength=(rho_min, rho_max))
        chols[rep] = np.linalg.cholesky(np.linalg.inv(theta))
        a = np.abs(theta) > 1e-8
        np.fill_diagonal(a, False)
        adj[rep] = a
    return chols, adj


@functools.lru_cache(maxsize=None)
def _sparse_plan_setup(d: int, reps: int, density: float, rho_min: float,
                       rho_max: float, seed0: int, device: str):
    """Cached device setup of a sparse plan: (chols, adj_true, keys) on
    ``device``, the keys the tree plane's (``fold_in(key(seed0), rep)``)."""
    chols, adj = _sparse_host_setup(d, reps, density, rho_min, rho_max,
                                    seed0)
    keys = prng.fold_in(prng.key(seed0, device=device),
                        torch.arange(reps, device=device))
    return (torch.from_numpy(chols).to(device),
            torch.from_numpy(adj).to(device), keys)


def _sparse_setup_key(plan: TrialPlan):
    return (plan.d, plan.reps, plan.density, plan.rho_min, plan.rho_max,
            plan.seed0)


def sparse_ground_truth(plan: TrialPlan, *, device=None):
    """``(chols, adj_true)`` of the sparse plan's ``reps`` ground truths,
    (reps, d, d) each, on ``device`` (default cuda): the Cholesky mixers
    the trials sample through and the supports they are scored against.
    Cached per plan and device with the trial keys."""
    return _sparse_plan_setup(*_sparse_setup_key(plan),
                              str(resolve_device(device)))[:2]


# --------------------------------------------------------------------------
# Stages
# --------------------------------------------------------------------------

def _needs_rates(strategies) -> bool:
    """True when the strategy set carries a budget channel, whose stages
    take the stacked per-feature ``rates`` operand."""
    return any(s.channel.kind == "budget" for s in strategies)


def _rates_operand(strategies, n: int, d: int, device):
    """The stacked (S, d) int32 per-feature rate vectors of one sweep
    point on ``device`` (None when no strategy has a budget channel).

    Budget strategies get their channel's greedy allocation at the TRUE
    sample count n (``BudgetChannel.column_rates``); every other row is
    a constant fill at its own rate, never read. Built on the host, one
    upload a point."""
    if not _needs_rates(strategies):
        return None
    rows = [s.channel.column_rates(n, d, s.rate)
            if s.channel.kind == "budget" else np.full(d, s.rate, np.int32)
            for s in strategies]
    return torch.from_numpy(np.stack(rows)).to(device)


def _channel_operands(strategies, rates, faults, fault_keys, n_pad: int,
                      n_valid: int) -> list[dict]:
    """Per-strategy estimator kwargs of the non-gather channels: budget
    strategies get their (d,) row of ``rates``; MAC strategies under a
    fault plan get the (t, machines) delivered-row counts drawn from the
    same trial fault stream as the feature-block view
    (``FaultPlan.draw_rowblock_batch``), drawn once for each distinct
    machine count. Gather strategies get ``{}``."""
    ops: list[dict] = [{} for _ in strategies]
    delivered: dict[int, torch.Tensor] = {}
    for i, s in enumerate(strategies):
        kind = s.channel.kind
        if kind == "budget":
            ops[i] = {"rates": rates[i]}
        elif kind == "mac" and faults is not None:
            m = s.channel.machines
            if m not in delivered:
                delivered[m] = faults.draw_rowblock_batch(
                    fault_keys, n_pad, n_valid, m)
            ops[i] = {"delivered": delivered[m]}
    return ops


def _stacked_stats(x, strategies, n_valid: int, engine, faults, fault_keys,
                   rates, estimate):
    """Every strategy's (reps, d, d) statistic of the shared samples ``x``
    through ``estimate`` (``strategy_weights_batch`` or
    ``strategy_corr_batch``), stacked as (S, reps, d, d). With a fault
    plan the one fault realization of each trial masks every strategy's
    payload, and the return is ``(stats, telemetry sums)``."""
    reps, n_pad, d = x.shape
    with trace.span("repro_torch.stats", x.device, n_valid=n_valid):
        n_rows = flip = tele = None
        if faults is not None:
            n_rows, flip, tele = faults.draw_batch(fault_keys, n_pad, n_valid,
                                                   d)
        ops = _channel_operands(strategies, rates, faults, fault_keys, n_pad,
                                n_valid)
        out = torch.empty((len(strategies), reps, d, d), dtype=torch.float32,
                          device=x.device)
        for i, s in enumerate(strategies):
            out[i] = estimate(x, s, n_valid=n_valid, n_rows=n_rows,
                              flip=flip, engine=engine, **ops[i])
        return out if faults is None else (out, tele.sum(dim=0))


def _stacked_weights(keys, parents, rhos, n_valid: int, strategies, n_pad,
                     engine, faults=None, fault_keys=None, rates=None):
    """Sample the bucket-shaped data once and emit every strategy's
    (reps, d, d) weights stacked as (S, reps, d, d) (with a fault plan:
    ``(weights, telemetry sums)``). ``rates`` is the point's
    :func:`_rates_operand` (needed when a strategy has a budget
    channel)."""
    with trace.span("repro_torch.sample", keys.device, n_pad=n_pad):
        x = sampler.sample_tree_ggm_rows_batch(keys, n_pad, parents, rhos)
    return _stacked_stats(x, strategies, n_valid, engine, faults,
                          fault_keys, rates,
                          estimators.strategy_weights_batch)


def structure_metric_channels(adj_est: torch.Tensor,
                              adj_ref: torch.Tensor) -> torch.Tensor:
    """(..., d, d) estimated vs reference adjacencies -> (..., 3)
    [error, hamming, shared-edge] channels.

    All three are integer-valued f32 (the error indicator, the edge
    symmetric difference, and |E_hat & E_ref|), so their sums are exact
    in any order. The serving plane takes them against the previous
    solve: hamming is the per-tenant structure-drift counter.
    """
    adj_est = torch.as_tensor(adj_est)
    adj_ref = torch.as_tensor(adj_ref)
    err = trees.structure_error(adj_est, adj_ref).to(torch.float32)
    ham = trees.structure_hamming(adj_est, adj_ref).to(torch.float32)
    shared = (adj_est & adj_ref).sum(dim=(-2, -1)).to(torch.float32) / 2
    return torch.stack([err, ham, shared], dim=-1)


def _metric_sums(w: torch.Tensor, adj_true: torch.Tensor,
                 chunk: int | None = None) -> torch.Tensor:
    """(S, r, d, d) weights + (r, d, d) truth -> (S, 3) metric SUMS over
    the rep axis: one Boruvka solve of the flattened (S*r) stack with a
    fixed round count (no host sync), in ``chunk``-trial slabs."""
    S, r, d, _ = w.shape
    with trace.span("repro_torch.mst", w.device, trials=S * r):
        est = boruvka_mst_batch(w.reshape(S * r, d, d), chunk,
                                early_exit=False).reshape(S, r, d, d)
        return structure_metric_channels(est, adj_true[None]).sum(dim=1)


# --------------------------------------------------------------------------
# Sparse stages (the §7 extension: glasso over quantized data)
# --------------------------------------------------------------------------

def _stacked_corr(keys, chols, n_valid: int, strategies, n_pad, engine,
                  faults=None, fault_keys=None, rates=None):
    """The sparse twin of :func:`_stacked_weights`: sample the bucket-
    shaped data once through the Cholesky mixers and emit every
    strategy's (reps, d, d) correlation statistic, stacked as (S, reps,
    d, d) (with a fault plan: ``(corr, telemetry sums)``; channel
    operands as there)."""
    with trace.span("repro_torch.sample", keys.device, n_pad=n_pad):
        x = sampler.sample_ggm_rows_batch(keys, n_pad, chols)
    return _stacked_stats(x, strategies, n_valid, engine, faults,
                          fault_keys, rates, estimators.strategy_corr_batch)


def _support_metric_channels(est: torch.Tensor,
                             adj_true: torch.Tensor) -> torch.Tensor:
    """(..., d, d) bool support estimates + truths -> (..., 5) channels
    [error, hamming, shared, est_edges, true_edges], all integer-valued
    f32: precision, recall and micro-F1 come exactly from their sums."""
    err = trees.structure_error(est, adj_true).to(torch.float32)
    ham = trees.structure_hamming(est, adj_true).to(torch.float32)
    shared, n_est, n_true = trees.edge_counts(est, adj_true)
    return torch.stack([err, ham, shared.to(torch.float32),
                        n_est.to(torch.float32), n_true.to(torch.float32)],
                       dim=-1)


def _sparse_metric_sums(corr: torch.Tensor, adj_true: torch.Tensor,
                        lams: tuple, tol: float, n_steps: int,
                        chunk: int | None = None) -> torch.Tensor:
    """(P, S, r, d, d) statistics of P sweep points + (r, d, d) truths ->
    (P, S, 5) support channel sums over the rep axis: one batched glasso
    solve of all P*S*r trials (the strategies' penalties as a lam
    vector), in ``chunk``-trial slabs. Trials are independent lanes, so
    solving the points together gives each trial what a solve of its own
    point would."""
    P, S, r, d, _ = corr.shape
    lam = torch.tensor(lams, dtype=torch.float32,
                       device=corr.device).repeat_interleave(r).repeat(P)
    theta = glasso.glasso_batch(corr.reshape(P * S * r, d, d), lam,
                                n_steps=n_steps, chunk=chunk)
    est = glasso.support_from_theta(theta, tol).reshape(P, S, r, d, d)
    return _support_metric_channels(est, adj_true).sum(dim=2)


def _sparse_path_metric_sums(corr: torch.Tensor, adj_true: torch.Tensor,
                             ns: Sequence[int], path: PathPlan, tol: float,
                             n_steps: int, chunk: int | None = None):
    """(P, S, r, d, d) statistics of the points at sample counts ``ns`` +
    (r, d, d) truths -> the path plane's sums over the rep axis, on the
    device: one warm-started grid solve of all P*S*r trials, then EBIC per
    trial (at its point's n) or StARS per point and strategy (its reps the
    subsample batch). Returns (selected (P, S, 5), per_lam (P, S, K, 5),
    iters (P, S, K), hist (P, S, K), lam_sums (P, S, K)), every one a sum
    of integer-valued f32 channels but the grids'."""
    P, S, r, d, _ = corr.shape
    L = P * S * r
    flat = corr.reshape(L, d, d)
    lams = path_engine.path_lambdas(path, flat)                 # (L, K)
    K = lams.shape[-1]
    solve = path_engine.glasso_path_batch(
        flat, lams, n_steps=n_steps, conv_tol=path.conv_tol,
        support_tol=tol, chunk=chunk)
    sup = solve.support.reshape(K, P, S, r, d, d)
    ch = _support_metric_channels(sup, adj_true)              # (K, P, S, r, 5)
    per_lam = ch.sum(dim=3).permute(1, 2, 0, 3)               # (P, S, K, 5)
    if path.select == "ebic":
        n = torch.tensor(ns, dtype=torch.float32,
                         device=corr.device).repeat_interleave(S * r)
        idx = path_engine.select_ebic(path_engine.ebic_scores(
            solve.logdet, solve.tr_s_theta, solve.edges, n, d,
            path.ebic_gamma))                                   # (L,)
    else:
        sup = sup.reshape(K, P * S, r, d, d)
        xi = torch.stack([path_engine.stars_instability(sup[:, i])
                          for i in range(P * S)], dim=1)        # (K, P*S)
        idx = path_engine.select_stars(xi, path.stars_beta) \
            .repeat_interleave(r)
    idx = idx.long()
    sel = torch.take_along_dim(ch.reshape(K, L, 5), idx[None, :, None],
                               dim=0)[0]
    hist = torch.nn.functional.one_hot(idx, K).to(torch.float32)
    iters = solve.iters.reshape(K, P, S, r).sum(dim=3).permute(1, 2, 0)
    return (sel.reshape(P, S, r, 5).sum(dim=2), per_lam,
            iters.to(torch.float32), hist.reshape(P, S, r, K).sum(dim=2),
            lams.reshape(P, S, r, K).sum(dim=2))


def _sparse_sums(plan: TrialPlan, corr: torch.Tensor, adj_true: torch.Tensor,
                 ns: Sequence[int], chunk: int | None) -> list:
    """The solve stage of a sparse plan over the (P, S, r, d, d)
    statistics of its points at sample counts ``ns``: the sums that
    ride the read-back, each with the point axis leading."""
    if plan.path is None:
        return [_sparse_metric_sums(
            corr, adj_true, tuple(s.lam for s in plan.strategies),
            plan.glasso_tol, plan.glasso_steps, chunk)]
    return list(_sparse_path_metric_sums(corr, adj_true, ns, plan.path,
                                         plan.glasso_tol, plan.glasso_steps,
                                         chunk))


def _solve_points_together(plan: TrialPlan) -> bool:
    """Whether a sparse sweep solves every point's trials in one batch:
    the solver scratch of all len(ns)*S*reps lanes (``metrics_chunk``'s
    bytes a trial) and their held (d, d) f32 statistics fit half the
    budget. Otherwise each point is solved after its own corr stage, in
    :meth:`TrialPlan.metrics_chunk` slabs, as ``repro`` solves it."""
    lanes = plan.points * plan.reps
    k = 0 if plan.path is None else plan.path.k
    return lanes * (44 + k) * plan.d * plan.d \
        <= plan.effective_memory_budget // 2


class SparsePoint(NamedTuple):
    """One strategy's trials at one point of a sparse sweep, solved on
    their own (:func:`sparse_point`)."""

    #: (reps, d, d) supports, or (K, reps, d, d) along a path
    support: torch.Tensor
    #: (reps, d, d) precision estimates of a fixed-lam solve; a path's
    #: (K, reps, d, d) iterates with ``keep_thetas``, else None
    theta: torch.Tensor | None
    #: a path's solve and its (reps,) selected indices (None at fixed lam)
    solve: path_engine.PathSolve | None
    picks: torch.Tensor | None
    #: what these trials give as a one-point, one-strategy sweep
    result: TrialResult

    def mismatches(self, run: TrialResult, j: int) -> list[str]:
        """The fields in which ``run``'s point ``j`` of this strategy
        differs from this solve of its own; none when the sweep gave the
        point what its own solve gives."""
        mine, (label,) = self.result, self.result.error_rate.keys()
        out = [f for f in _SPARSE_FIELDS
               if getattr(run, f)[label][j] != getattr(mine, f)[label][0]]
        if run.path is not None:
            out += [f"path.{f}" for f in _PATH_FIELDS
                    if run.path[f][label][j] != mine.path[f][label][0]]
        return out


_SPARSE_FIELDS = ("error_rate", "edit_distance", "edge_f1", "precision",
                  "recall")
_PATH_FIELDS = ("lams", "error_rate", "edge_f1", "iters", "selected_hist")


def sparse_point(plan: TrialPlan, n: int, i: int, *, device=None,
                 keep_thetas: bool = False) -> SparsePoint:
    """Strategy ``i``'s trials at sample count ``n`` of a sparse plan,
    solved on their own: the statistics from the sweep's corr stage (its
    faults included), one solve of just these reps lanes (the strategy's
    lam, or the plan's path and selection at this n), and the metrics
    they give as a sweep of their own. :func:`run_trials` solves every
    point's lanes in one batch; lanes are independent, so
    :meth:`SparsePoint.mismatches` finds nothing on a sweep that routed
    each lane's penalty, sample count and selection group right."""
    if plan.structure != "sparse":
        raise ValueError("sparse_point takes a sparse plan")
    dev = resolve_device(device)
    engine = plan.budget_engine(resolve_engine(None), device=dev)
    chols, adj_true, keys = _sparse_plan_setup(*_sparse_setup_key(plan),
                                               str(dev))
    fkeys = (None if plan.faults is None
             else fault_trial_keys(plan.faults, plan.reps, device=dev))
    corr = _stacked_corr(keys, chols, n, plan.strategies, plan.bucket_for(n),
                         engine, plan.faults, fkeys,
                         _rates_operand(plan.strategies, n, plan.d, dev))
    corr = (corr if plan.faults is None else corr[0])[i]
    s = plan.strategies[i]
    solve = picks = None
    if plan.path is None:
        theta = glasso.glasso_batch(corr, s.lam, n_steps=plan.glasso_steps)
        sup = glasso.support_from_theta(theta, plan.glasso_tol)
        sums = [_support_metric_channels(sup, adj_true).sum(dim=0)]
    else:
        lams = path_engine.path_lambdas(plan.path, corr)          # (r, K)
        solve = path_engine.glasso_path_batch(
            corr, lams, n_steps=plan.glasso_steps,
            conv_tol=plan.path.conv_tol, support_tol=plan.glasso_tol,
            keep_thetas=keep_thetas)
        picks = path_engine.path_select(solve, plan.path, n, plan.d).long()
        sup, theta, K = solve.support, solve.thetas, lams.shape[-1]
        ch = _support_metric_channels(sup, adj_true)             # (K, r, 5)
        sel = ch[picks, torch.arange(plan.reps, device=ch.device)]
        sums = [sel.sum(dim=0), ch.sum(dim=1), solve.iters.sum(dim=1),
                torch.bincount(picks, minlength=K), lams.sum(dim=0)]
    host = [p[None, None].to(torch.float32).cpu().numpy() for p in sums]
    one = dataclasses.replace(plan, strategies=(s,), ns=(n,), faults=None)
    result = _package_result(one, host[0] / np.float32(plan.reps),
                             seconds=0.0, host_syncs=1, fault_sums=None,
                             tiling={}, path_extras=host[1:] or None)
    return SparsePoint(sup, theta, solve, picks, result)


def _own_reference(plan: TrialPlan, ref: TrialResult, i: int, j: int,
                   device, faults: list):
    """``ref_point`` for a reference sweep of the port itself on
    ``device``: the point solved alone there, which must give exactly what
    ``ref`` gave it."""
    n = plan.ns[j]
    own = sparse_point(plan, n, i, device=device, keep_thetas=True)
    faults += [f"{plan.strategies[i].label} n={n}: the reference sweep's "
               f"{f} is not the point's own" for f in own.mismatches(ref, j)]
    if own.solve is None:
        return own.theta.cpu(), None, None
    scores = None if plan.path.select == "stars" else path_engine.ebic_scores(
        own.solve.logdet, own.solve.tr_s_theta, own.solve.edges, n, plan.d,
        plan.path.ebic_gamma).cpu()
    return own.theta.cpu(), own.picks.cpu(), scores


def sparse_sweep_faults(plan: TrialPlan, run: TrialResult, ref: TrialResult,
                        ref_point=None, *, device=None, ref_device="cpu"):
    """Hold a sparse sweep ``run`` to a reference sweep ``ref`` of the
    same plan (the port's on another device, or ``repro``'s) ->
    ``(parted, faults)``; no faults means they agree.

    Each point's metrics (and a path's per-lam curves and selection
    counts) must be equal, or differ where two f32 solvers may part
    (``ROADMAP.md`` §3). A point that differs is solved on its own on
    ``device`` (:func:`sparse_point`), which must give exactly what
    ``run`` gave it; then its supports are held to the reference's own
    solve of the point by :func:`path.parting_faults`. ``ref_point(i, j)``
    gives that solve of strategy ``i`` at ``plan.ns[j]`` as (precision
    estimates, selected indices, EBIC scores); without it the reference
    is the port's sweep on ``ref_device``, whose points solved alone
    there must give exactly what ``ref`` gave them. ``parted`` lists
    (label, n, support entries parted) of the points solved again."""
    parted, faults = [], []
    for i, s in enumerate(plan.strategies):
        for j, n in enumerate(plan.ns):
            same = all(getattr(run, f)[s.label][j] == getattr(ref, f)[
                s.label][j] for f in _SPARSE_FIELDS)
            if plan.path is not None:
                same = same and all(
                    run.path[f][s.label][j] == ref.path[f][s.label][j]
                    for f in ("error_rate", "edge_f1", "selected_hist"))
            if same:
                continue
            where = f"{s.label} n={n}"
            point = sparse_point(plan, n, i, device=device)
            faults += [f"{where}: the sweep's {f} is not the point's own"
                       for f in point.mismatches(run, j)]
            theta, picks, scores = (
                _own_reference(plan, ref, i, j, ref_device, faults)
                if ref_point is None else ref_point(i, j))
            diff, why = path_engine.parting_faults(
                point.support, theta, plan.glasso_tol,
                picks=None if point.picks is None else point.picks.cpu(),
                ref_picks=picks, ref_scores=scores)
            faults += [f"{where}: {w}" for w in why]
            parted.append((s.label, n, diff))
    return parted, faults


# --------------------------------------------------------------------------
# Mesh stages (the rep-sharded and distributed trial planes)
# --------------------------------------------------------------------------
#
# Every rank of the mesh calls a stage on its shard of the reps (the
# keys, trees or Cholesky mixers of reps [r*reps/D, (r+1)*reps/D)); the
# stage sums its integer-valued metric channels and fault telemetry over
# the data axis, exactly in any order, so every rank returns the mesh-less
# sweep's sums. ``repro`` jits and caches each one; here they are plain
# functions that build the point's closure.

def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _split(out, faults):
    """A stage's output -> (result, telemetry sums or None)."""
    return (out, None) if faults is None else out


def _sharded_point_fn(strategies, n_pad: int, engine, mesh, data_axis: str,
                      faults=None, chunk: int | None = None):
    """One sweep point with the rep axis sharded over ``data_axis``:
    ``point(keys, fault_keys, parents, rhos, adj_true, n_valid, rates)``
    of this rank's reps -> the (S, 3) metric sums summed over the axis
    (with a fault plan: ``(sums, telemetry sums)``)."""
    group = mesh.get_group(data_axis)

    def point(keys, fkeys, parents, rhos, adj_true, n_valid, rates):
        w, tele = _split(_stacked_weights(
            keys, parents, rhos, n_valid, strategies, n_pad, engine, faults,
            fkeys, rates), faults)
        sums = psum(_metric_sums(w, adj_true, chunk), group)
        return sums if faults is None else (sums, psum(tele, group))

    return point


def _check_mac_rowsplit(strategies, n_pad: int, n_model: int) -> None:
    """Wire-plane MAC strategies split the SAMPLE axis over the model mesh
    axis (each rank contracts its row share of the superposition), so the
    bucket must divide evenly."""
    if n_pad % n_model and any(s.channel.kind == "mac" for s in strategies):
        raise ValueError(
            f"MAC channel strategies need the sample bucket to split over "
            f"the model mesh axis: n_pad={n_pad} is not a multiple of "
            f"n_model={n_model}")


def _mac_wire_stat(s, plan, x, midx, n_model, n_pad, n_valid, flip, fkeys,
                   faults, engine, delivered_by_m, *, corr):
    """One MAC-channel strategy's statistic on the wire plane. Every rank
    masks the FULL sample block down to the delivered machine row blocks
    (from the shared fault keys, so the ranks agree bit for bit),
    contracts ITS row share of the superposition (``sign_corr`` on an
    (n/M, d) share) and ``plan.wire`` — the MAC's ``superposed_psum`` —
    adds the partial sign Grams over the model axis. They are
    integer-valued f32 below 2^24, so any row partition sums to the same
    bits; the center normalizes by the delivered-row count."""
    delivered = None
    if faults is not None:
        m = s.channel.machines
        if m not in delivered_by_m:
            delivered_by_m[m] = faults.draw_rowblock_batch(
                fkeys, n_pad, n_valid, m)
        delivered = delivered_by_m[m]
    u = estimators.mac_sign_codes(x, s, n_valid=n_valid, delivered=delivered,
                                  flip=flip)
    n_loc = n_pad // n_model
    part = resolve_engine(engine).gram_batch(
        u[:, midx * n_loc:(midx + 1) * n_loc])
    del u
    gram = plan.wire(part)
    n_eff = estimators.mac_effective_count(
        s, n_pad, n_valid=n_valid, delivered=delivered, device=x.device)
    return plan.central_from_sum(gram, n_eff, corr=corr)


def _budget_wire_stat(s, plan, x_loc, midx, d_loc, rates_row, n_valid,
                      n_rows, n_rows_loc, keep_loc, engine, *, corr):
    """One budget-channel strategy's statistic on the wire plane. The rank
    encodes its feature block at the block's allocated rates (its slice
    of the (d,) rate vector: one ``quantize_fused`` a rate, then a
    select; a columnwise encode, so the gathered payload is the
    single-device one bit for bit), the int8 codes are gathered, and the
    center decodes them through the rate-indexed centroid table."""
    rates_loc = rates_row[midx * d_loc:(midx + 1) * d_loc]
    payload = plan.encode(x_loc, n_valid=n_valid, n_rows=n_rows_loc,
                          rates=rates_loc)
    full = plan.wire(payload, keep=keep_loc)
    return estimators.budget_estimate(
        full, s, rates_row, n_valid=n_valid, n_rows=n_rows, engine=engine,
        corr=corr)


def _wire_stats(strategies, x, n_pad: int, n_valid: int, engine, mesh,
                data_axis: str, model_axis: str, faults, fkeys, rates, *,
                corr: bool):
    """Every strategy's (r, d, d) statistic of this rank's full-feature
    samples ``x`` through the wire runtime, stacked as (S, r, d, d) (with
    a fault plan: ``(stats, telemetry sums)``).

    The rank keeps its feature block (its group of the paper's machines)
    and runs ``WirePlan.encode -> wire -> central`` a strategy; the MAC
    and budget channels swap the middle (:func:`_mac_wire_stat`,
    :func:`_budget_wire_stat`). With a fault plan every rank draws the
    FULL realization from the shared fault keys, masks its own slice
    machine-side, and the wire erases dropped features
    (``WirePlan.wire(keep=)``)."""
    n_model = _axis_size(mesh, model_axis)
    reps, _, d = x.shape
    d_loc = d // n_model
    midx = mesh.get_local_rank(model_axis)
    cols = slice(midx * d_loc, (midx + 1) * d_loc)
    x_loc = x[..., cols]
    n = torch.as_tensor(n_valid, dtype=torch.float32, device=x.device)
    n_rows = flip = n_rows_loc = flip_loc = keep_loc = tele = None
    if faults is not None:
        n_rows, flip, tele = faults.draw_batch(fkeys, n_pad, n_valid, d)
        n_rows_loc = n_rows[..., cols]
        if flip is not None:
            flip_loc = flip[..., cols]
        keep_loc = n_rows_loc > 0
    out = torch.empty((len(strategies), reps, d, d), dtype=torch.float32,
                      device=x.device)
    delivered_by_m: dict = {}
    for i, s in enumerate(strategies):
        plan = WirePlan(s, data_axis=data_axis, model_axis=model_axis,
                        engine=engine, mesh=mesh)
        kind = s.channel.kind
        if kind == "mac":
            out[i] = _mac_wire_stat(s, plan, x, midx, n_model, n_pad,
                                    n_valid, flip, fkeys, faults, engine,
                                    delivered_by_m, corr=corr)
        elif kind == "budget":
            out[i] = _budget_wire_stat(s, plan, x_loc, midx, d_loc, rates[i],
                                       n_valid, n_rows, n_rows_loc, keep_loc,
                                       engine, corr=corr)
        else:
            payload = plan.encode(x_loc, n_valid=n_valid, n_rows=n_rows_loc,
                                  flip=flip_loc)
            full = plan.wire(payload, keep=keep_loc)
            central = plan.central_corr if corr else plan.central
            out[i] = central(full, n, n_valid=n_valid, n_rows=n_rows,
                             n_rows_own=n_rows_loc, own_payload=payload)
    return out if faults is None else (out, tele.sum(dim=0))


def _wire_point_fn(strategies, n_pad: int, engine, mesh, data_axis: str,
                   model_axis: str, faults=None, chunk: int | None = None):
    """One sweep point on the DISTRIBUTED trial plane — trials sharded
    over ``data_axis``, features over ``model_axis``: ``point(keys,
    fault_keys, parents, rhos, adj_true, n_valid, rates)`` -> the (S, 3)
    metric sums summed over the data axis (every rank of a data row
    already holds the same weights: the gathered payload, the gathered row
    blocks or the superposed Gram). The gathered payload is the
    single-device encode of the unsliced data bit for bit, so the metrics
    equal the mesh-less sweep's."""
    _check_mac_rowsplit(strategies, n_pad, _axis_size(mesh, model_axis))
    group = mesh.get_group(data_axis)

    def point(keys, fkeys, parents, rhos, adj_true, n_valid, rates):
        x = sampler.sample_tree_ggm_rows_batch(keys, n_pad, parents, rhos)
        w, tele = _split(_wire_stats(
            strategies, x, n_pad, n_valid, engine, mesh, data_axis,
            model_axis, faults, fkeys, rates, corr=False), faults)
        del x
        sums = psum(_metric_sums(w, adj_true, chunk), group)
        return sums if faults is None else (sums, psum(tele, group))

    return point


def _sparse_sharded_corr_fn(strategies, n_pad: int, engine, mesh,
                            data_axis: str, faults=None):
    """The SPARSE corr stage with the rep axis sharded over
    ``data_axis``: ``corr_fn(keys, fault_keys, chols, n_valid, rates)``
    -> the (S, reps, d, d) statistics of every rep, gathered over the
    axis (with a fault plan: ``(corr, telemetry sums)``). The collectives
    end here: every rank then solves the statistics as the mesh-less
    sweep does."""
    group = mesh.get_group(data_axis)

    def corr_fn(keys, fkeys, chols, n_valid, rates):
        corr, tele = _split(_stacked_corr(
            keys, chols, n_valid, strategies, n_pad, engine, faults, fkeys,
            rates), faults)
        corr = all_gather(corr, group, 1)
        return corr if faults is None else (corr, psum(tele, group))

    return corr_fn


def _sparse_wire_corr_fn(strategies, n_pad: int, engine, mesh,
                         data_axis: str, model_axis: str, faults=None):
    """The SPARSE corr stage on the DISTRIBUTED trial plane: trials over
    ``data_axis``, features over ``model_axis``, each trial through the
    wire runtime (``WirePlan.encode -> wire -> central_corr``), the
    statistics gathered over the data axis as in
    :func:`_sparse_sharded_corr_fn`."""
    _check_mac_rowsplit(strategies, n_pad, _axis_size(mesh, model_axis))
    group = mesh.get_group(data_axis)

    def corr_fn(keys, fkeys, chols, n_valid, rates):
        x = sampler.sample_ggm_rows_batch(keys, n_pad, chols)
        corr, tele = _split(_wire_stats(
            strategies, x, n_pad, n_valid, engine, mesh, data_axis,
            model_axis, faults, fkeys, rates, corr=True), faults)
        del x
        corr = all_gather(corr, group, 1)
        return corr if faults is None else (corr, psum(tele, group))

    return corr_fn


def _mesh_shard(plan: TrialPlan, mesh, data_axis: str, model_axis: str,
                dev: torch.device) -> tuple[slice, bool]:
    """(this rank's slice of the reps, whether the mesh runs the wire
    plane), after ``repro``'s size checks."""
    shards = _axis_size(mesh, data_axis)
    if plan.reps % shards != 0:
        raise ValueError(
            f"reps={plan.reps} must divide over the {shards}-way "
            f"{data_axis!r} mesh axis")
    wire_plane = model_axis in mesh.mesh_dim_names
    if wire_plane and plan.d % _axis_size(mesh, model_axis) != 0:
        raise ValueError(
            f"d={plan.d} must divide over the "
            f"{_axis_size(mesh, model_axis)}-way {model_axis!r} mesh axis")
    if mesh.device_type != dev.type:
        raise ValueError(f"a {mesh.device_type} mesh cannot run a sweep on "
                         f"{dev}")
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    per = plan.reps // shards
    r = mesh.get_local_rank(data_axis)
    return slice(r * per, (r + 1) * per), wire_plane


# --------------------------------------------------------------------------
# Setup-cache hygiene
# --------------------------------------------------------------------------

def _setup_caches():
    return (_host_setup, _plan_setup, _sparse_host_setup, _sparse_plan_setup,
            faults_mod._fault_trial_keys)


def compile_cache_size() -> int:
    """Live entries of the per-plan setup caches (trees, uploads, keys).
    The name is ``repro``'s, whose caches also hold compiled stages."""
    return sum(c.cache_info().currsize for c in _setup_caches())


def clear_compile_caches() -> int:
    """Drop every cached per-plan setup bundle; returns how many."""
    n = compile_cache_size()
    for c in _setup_caches():
        c.cache_clear()
    return n


# --------------------------------------------------------------------------
# The sweep engine
# --------------------------------------------------------------------------

def _comm_reports(plan: TrialPlan, fault_sums: np.ndarray | None = None,
                  wire_plane: bool = False) -> dict[str, list[CommReport]]:
    """Per-strategy CommReport per n: logical bits at the true n beside
    the payload bytes at the bucket the sweep ran. Collective counts
    apply only where the wire runtime ran (``wire_plane``: a 2-D mesh).
    Under a fault plan with retries, the retry bytes are measured from
    the realized retransmission counts: mean machines re-requested a
    round times the per-machine wire bytes."""
    f = plan.faults
    comm: dict[str, list[CommReport]] = {}
    for s in plan.strategies:
        reports = []
        for i, n in enumerate(plan.ns):
            rep = comm_report(s, n, plan.d, n_pad=plan.bucket_for(n))
            if not wire_plane:
                rep = dataclasses.replace(rep, collectives=0)
            if f is not None and f.retries > 0 and fault_sums is not None:
                machines = f.n_machines(plan.d)
                retrans = fault_sums[i, 2:2 + f.retries] / plan.reps
                used = fault_sums[i, 2 + f.retries:2 + 2 * f.retries] \
                    / plan.reps
                rep = dataclasses.replace(
                    rep,
                    retry_bytes=float(np.sum(retrans))
                    * rep.wire_bytes / machines,
                    retry_collectives=float(np.sum(used)),
                    retry_rounds=f.retries)
            reports.append(rep)
        comm[s.label] = reports
    return comm


def _fault_stats(plan: TrialPlan,
                 fault_sums: np.ndarray | None) -> list[dict] | None:
    """(len(ns), channels) realized telemetry sums -> the per-n
    ``TrialResult.faults`` dicts (means over reps)."""
    if fault_sums is None:
        return None
    r = plan.faults.retries
    stats = []
    for i, n in enumerate(plan.ns):
        row = np.asarray(fault_sums[i], np.float64) / plan.reps
        stats.append({
            "n": int(n),
            "dropped_machines": float(row[0]),
            "straggling_machines": float(row[1]),
            "retransmissions": [float(v) for v in row[2:2 + r]],
            "retry_rounds_used": [float(v) for v in row[2 + r:2 + 2 * r]],
        })
    return stats


def _path_stats(plan: TrialPlan, extras) -> dict | None:
    """The path plane's host sums (per_lam, iters, hist, lam_sums, each
    (S, len(ns), K, ...)) -> ``TrialResult.path``, with ``repro``'s f32
    arithmetic."""
    if extras is None:
        return None
    per_lam, iters, hist, lam_sums = extras
    reps = np.float32(plan.reps)
    labels = [s.label for s in plan.strategies]

    def _grid_cols(a: np.ndarray) -> dict[str, list[list[float]]]:
        return {lab: [[float(v) for v in row] for row in a[i]]
                for i, lab in enumerate(labels)}

    shared, n_est, n_true = (per_lam[..., 2], per_lam[..., 3],
                             per_lam[..., 4])
    return {
        "select": plan.path.select,
        "k": plan.path.k,
        "lams": _grid_cols(lam_sums / reps),
        "error_rate": _grid_cols(per_lam[..., 0] / reps),
        "edge_f1": _grid_cols(
            2.0 * shared / np.maximum(n_est + n_true, np.float32(1e-9))),
        "iters": _grid_cols(iters / reps),
        "selected_hist": _grid_cols(hist),
    }


def _package_result(plan: TrialPlan, m: np.ndarray, *, seconds: float,
                    host_syncs: int, fault_sums: np.ndarray | None,
                    tiling: dict, path_extras=None, mesh_devices: int = 1,
                    wire_plane: bool = False) -> TrialResult:
    """Mean metrics -> TrialResult, with ``repro``'s f32 arithmetic for
    the derived metrics. Tree plans carry (S, len(ns), 3) channels: edge
    F1 == shared / (d - 1) for spanning trees, and precision == recall ==
    F1. Sparse plans carry (S, len(ns), 5) [error, hamming, shared, est,
    true]: P = shared/est, R = shared/true, F1 = 2*shared/(est+true)."""
    labels = [s.label for s in plan.strategies]

    def _cols(a: np.ndarray) -> dict[str, list[float]]:
        return {lab: [float(v) for v in a[i]] for i, lab in enumerate(labels)}

    if plan.structure == "sparse":
        shared, n_est, n_true = m[:, :, 2], m[:, :, 3], m[:, :, 4]
        tiny = np.float32(1e-9)
        precision = _cols(shared / np.maximum(n_est, tiny))
        recall = _cols(shared / np.maximum(n_true, tiny))
        edge_f1 = _cols(2.0 * shared / np.maximum(n_est + n_true, tiny))
    else:
        edge_f1 = _cols(m[:, :, 2] / np.float32(plan.d - 1))
        precision = {lab: list(v) for lab, v in edge_f1.items()}
        recall = {lab: list(v) for lab, v in edge_f1.items()}
    return TrialResult(
        plan=plan, error_rate=_cols(m[:, :, 0]),
        edit_distance=_cols(m[:, :, 1]), edge_f1=edge_f1,
        precision=precision, recall=recall,
        seconds=seconds, host_syncs=host_syncs,
        comm=_comm_reports(plan, fault_sums, wire_plane),
        buckets=plan.buckets, compile_cache_size=compile_cache_size(),
        faults=_fault_stats(plan, fault_sums), tiling=tiling,
        path=_path_stats(plan, path_extras), mesh_devices=mesh_devices)


def _host_kruskal_trials(plan: TrialPlan, engine: GramEngine,
                         dev: torch.device) -> TrialResult:
    """``mst="host_kruskal"``: the device weights stage, then host Kruskal
    and numpy metrics per trial. Every weight tensor (and the fault
    telemetry) comes back in ONE read."""
    parents, rhos, _, keys = _plan_setup(*_setup_key(plan), str(dev))
    host_adj = trees.adjacency_from_parents(
        torch.from_numpy(_host_setup(*_setup_key(plan))[0])).numpy()
    faults = plan.faults
    fkeys = (fault_trial_keys(faults, plan.reps, device=dev)
             if faults is not None else None)
    t0 = time.perf_counter()
    ws, fsums = [], []
    for n in plan.ns:
        out = _stacked_weights(keys, parents, rhos, n, plan.strategies,
                               plan.bucket_for(n), engine, faults, fkeys,
                               _rates_operand(plan.strategies, n, plan.d,
                                              dev))
        if faults is None:
            ws.append(out)
        else:
            ws.append(out[0])
            fsums.append(out[1])
    stacked = torch.stack(ws)  # (len(ns), S, reps, d, d)
    flat = [stacked.flatten()]
    if faults is not None:  # the telemetry rides the same read
        flat.append(torch.stack(fsums).flatten())
    with trace.span("repro_torch.readback"):
        trace.count("host_reads")
        host = torch.cat(flat).cpu().numpy()
    syncs = 1
    host_w = host[:stacked.numel()].reshape(stacked.shape)
    host_f = (host[stacked.numel():].reshape(len(plan.ns), -1)
              if faults is not None else None)
    d = plan.d
    sums = np.zeros((len(plan.strategies), len(plan.ns), 3), np.float32)
    for i_n in range(len(plan.ns)):
        for i_s in range(len(plan.strategies)):
            for rep in range(plan.reps):
                est = np.zeros((d, d), dtype=bool)
                for j, k in kruskal_mst(host_w[i_n, i_s, rep]):
                    est[j, k] = est[k, j] = True
                true = host_adj[rep]
                sums[i_s, i_n, 0] += (est != true).any()
                sums[i_s, i_n, 1] += (est != true).sum() // 2
                sums[i_s, i_n, 2] += (est & true).sum() // 2
    m = sums / np.float32(plan.reps)
    return _package_result(
        plan, m, seconds=time.perf_counter() - t0, host_syncs=syncs,
        fault_sums=host_f,
        tiling={"memory_budget_bytes": plan.effective_memory_budget,
                "d_tile": engine.d_tile, "n_chunk": engine.n_chunk,
                "metrics_chunk": None})


def run_trials(plan: TrialPlan, *, engine: GramEngine | None = None,
               mesh=None, data_axis: str = "data", model_axis: str = "model",
               mst: str = "device", device=None) -> TrialResult:
    """Run a full Monte-Carlo sweep with ONE host read.

    For each n the trial data (reps, n_bucket, d) is sampled once and
    shared by every strategy (methods see the same draws); every
    strategy's weights come through the batched Gram entry points, and
    one fixed-round Boruvka solve of the (S*reps, d, d) stack gives the
    per-point metric sums, which stay on the device until the single
    read-back of the (S, len(ns), 3) tensor (with the fault telemetry).

    Sparse plans run the same chain into correlation statistics and solve
    every point's at once with one batched glasso (or, with
    ``plan.path``, one warm-started grid solve and on-device selection),
    giving (S, len(ns), 5) support channel sums; the path's per-lam sums
    ride the same read-back. Where all points' lanes do not fit half the
    memory budget, each point is solved after its corr stage instead, in
    ``plan.metrics_chunk()`` slabs. The solver's ``eigh`` waits for the
    host in every step, so the sweep makes more device->host copies than
    reads (``host_syncs``, still 1).

    ``mesh`` (``launch.mesh.make_trial_mesh``; every rank calls with the
    same plan) shards the reps over ``data_axis`` (``plan.reps`` must
    divide over it) and, on a 2-D mesh, the features over ``model_axis``
    (``plan.d`` must divide over it), each trial running the wire runtime
    (``distributed.WirePlan``); see the module docstring. Every rank
    returns the mesh-less sweep's result, with ``mesh_devices`` and the
    wire's collective counts on ``comm``.

    ``device`` (default cuda; raises without it) is where the sweep runs;
    the tests pass ``device="cpu"``. ``engine`` pins the Gram backend
    (default: the kernels on a card, torch on the CPU) and is clamped to
    the plan's memory budget. ``mst="host_kruskal"`` reads the weights
    back once and solves on the host (tree plans, no mesh). A fault plan
    runs the masked-Gram path and reports the realized telemetry on
    ``TrialResult.faults``; a zero-fault plan is bit-identical to none.
    """
    dev = resolve_device(device)
    with trace.span("repro_torch.run_trials", dev, trials=plan.trials,
                    d=plan.d):
        return _run_trials(plan, engine, mesh, data_axis, model_axis, mst,
                           dev)


def _run_trials(plan: TrialPlan, engine, mesh, data_axis: str,
                model_axis: str, mst: str, dev) -> TrialResult:
    labels = [s.label for s in plan.strategies]
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate strategy labels: {labels}")
    if mst not in ("device", "host_kruskal"):
        raise ValueError(f"unknown mst mode {mst!r}")
    sparse = plan.structure == "sparse"
    if mst == "host_kruskal":
        if mesh is not None:
            raise ValueError(
                "mst='host_kruskal' is the single-process escape hatch; "
                "run it without a mesh")
        if sparse:
            raise ValueError(
                "mst='host_kruskal' is a tree-plane escape hatch; sparse "
                "plans solve glasso, not an MWST")
    engine = plan.budget_engine(resolve_engine(engine), device=dev)
    if engine.autotune:
        # resolve every (bucket, path) point before the sweeps, as repro
        # pre-tunes before tracing them
        for b in sorted({plan.bucket_for(n) for n in plan.ns}):
            for path in sorted({_gram_path(s) for s in plan.strategies}):
                engine.tune(path, b, plan.d, device=dev,
                            budget=plan.effective_memory_budget // 2)
    if mst == "host_kruskal":
        return _host_kruskal_trials(plan, engine, dev)
    shard, wire_plane = slice(None), False
    if mesh is not None:
        shard, wire_plane = _mesh_shard(plan, mesh, data_axis, model_axis,
                                        dev)
    chunk = plan.metrics_chunk()
    together = sparse and _solve_points_together(plan)
    if sparse:
        chols, adj_true, keys = _sparse_plan_setup(*_sparse_setup_key(plan),
                                                   str(dev))
    else:
        parents, rhos, adj_true, keys = _plan_setup(*_setup_key(plan),
                                                    str(dev))
    faults = plan.faults
    fkeys = (fault_trial_keys(faults, plan.reps, device=dev)
             if faults is not None else None)
    # this rank's reps (all of them without a mesh)
    keys_r = keys[shard]
    fkeys_r = fkeys[shard] if faults is not None else None
    point_sums, fault_sums = [], []
    t0 = time.perf_counter()
    for n in plan.ns:
        n_pad = plan.bucket_for(n)
        # the budget channels' allocation at this n: a host->device upload
        rates = _rates_operand(plan.strategies, n, plan.d, dev)
        if sparse:
            if mesh is None:
                out = _stacked_corr(keys, chols, n, plan.strategies, n_pad,
                                    engine, faults, fkeys, rates)
            else:
                corr_fn = (
                    _sparse_wire_corr_fn(plan.strategies, n_pad, engine,
                                         mesh, data_axis, model_axis, faults)
                    if wire_plane else
                    _sparse_sharded_corr_fn(plan.strategies, n_pad, engine,
                                            mesh, data_axis, faults))
                # every rank gets every rep's statistics and solves them
                # as the mesh-less sweep does
                out = corr_fn(keys_r, fkeys_r, chols[shard], n, rates)
            w, fsum = _split(out, faults)
            if together:
                # the statistics wait for the one solve of every point:
                # each solver step waits for the host, so one loop over
                # all the sweep's trials takes len(ns) times fewer of them
                point_sums.append(w)
            else:
                point_sums.append(_sparse_sums(plan, w[None], adj_true,
                                               (n,), chunk))
            del w, out
        elif mesh is None:
            w, fsum = _split(_stacked_weights(
                keys, parents, rhos, n, plan.strategies, n_pad, engine,
                faults, fkeys, rates), faults)
            point_sums.append(_metric_sums(w, adj_true, chunk))
            del w
        else:
            point_fn = (
                _wire_point_fn(plan.strategies, n_pad, engine, mesh,
                               data_axis, model_axis, faults, chunk)
                if wire_plane else
                _sharded_point_fn(plan.strategies, n_pad, engine, mesh,
                                  data_axis, faults, chunk))
            sums, fsum = _split(point_fn(
                keys_r, fkeys_r, parents[shard], rhos[shard],
                adj_true[shard], n, rates), faults)
            point_sums.append(sums)
        if fsum is not None:
            fault_sums.append(fsum)
        del rates
    if not sparse:
        parts = [torch.stack(point_sums, dim=1)]
    else:
        if together:
            point_sums = [_sparse_sums(plan, torch.stack(point_sums),
                                       adj_true, plan.ns, chunk)]
        parts = [torch.cat(p).transpose(0, 1) for p in zip(*point_sums)]
    del point_sums
    # the metric sums (and the path's per-lam sums, and the fault
    # telemetry), still on the device: THE read-back. host_syncs counts
    # result reads.
    if faults is not None:
        parts.append(torch.stack(fault_sums))
    with trace.span("repro_torch.readback"):
        trace.count("host_reads")
        host = torch.cat([p.flatten().to(torch.float32) for p in parts]) \
            .cpu().numpy()
    syncs = 1
    seconds = time.perf_counter() - t0
    arrays, at = [], 0
    for p in parts:
        arrays.append(host[at:at + p.numel()].reshape(p.shape))
        at += p.numel()
    fsums = arrays.pop() if faults is not None else None
    # the means divide on the host: CUDA divides a tensor by a python
    # scalar as a product with its reciprocal, which rounds unlike the
    # CPU's (and XLA's) division
    m = arrays[0] / np.float32(plan.reps)
    return _package_result(
        plan, m, seconds=seconds, host_syncs=syncs, fault_sums=fsums,
        tiling={"memory_budget_bytes": plan.effective_memory_budget,
                "d_tile": engine.d_tile, "n_chunk": engine.n_chunk,
                "metrics_chunk": chunk},
        path_extras=arrays[1:] or None,
        mesh_devices=mesh.size() if mesh is not None else 1,
        wire_plane=wire_plane)


# --------------------------------------------------------------------------
# Single-dataset evaluation (Figs. 10-11: one big x, several strategies)
# --------------------------------------------------------------------------

def learned_adjacency(x, strategy: Strategy, *,
                      engine: GramEngine | None = None,
                      glasso_tol: float = glasso.SUPPORT_TOL,
                      glasso_steps: int = glasso.DEFAULT_STEPS,
                      device=None) -> torch.Tensor:
    """Device-side structure estimate of one (n, d) dataset as a (d, d)
    bool adjacency on the data's device (host data goes to ``device``):
    quantize -> Gram -> weights -> fixed-round Boruvka for tree
    strategies, quantize -> Gram -> correlation -> glasso -> partial-
    correlation support for sparse ones (``glasso_tol``/``glasso_steps``
    as in :class:`TrialPlan`)."""
    x = as_tensor(x, resolve_device(device, x), torch.float32)
    engine = resolve_engine(engine)
    if strategy.structure == "sparse":
        corr = estimators.strategy_corr(x, strategy, engine=engine)
        theta = glasso.glasso_batch(corr[None], strategy.lam,
                                    n_steps=glasso_steps)[0]
        return glasso.support_from_theta(theta, glasso_tol)
    return boruvka_mst(estimators.strategy_weights(
        x, strategy, engine=engine), early_exit=False)


def evaluate_strategies(x, adj_true, strategies: Sequence[Strategy], *,
                        engine: GramEngine | None = None,
                        glasso_tol: float = glasso.SUPPORT_TOL,
                        glasso_steps: int = glasso.DEFAULT_STEPS,
                        device=None) -> dict[str, dict[str, float]]:
    """Score several strategies on ONE dataset against a reference
    adjacency; the per-strategy metrics come back in one read.

    Returns ``{label: {error, edit_distance, edge_f1}}`` where
    ``edit_distance`` is the edge symmetric difference |E_hat ^ E_ref|
    (``edge_f1`` is the general support formula; only sparse strategies
    read the glasso knobs).
    """
    x = as_tensor(x, resolve_device(device, x), torch.float32)
    adj_true = as_tensor(adj_true, x.device).bool()
    stacked = []
    for strat in strategies:
        est = learned_adjacency(x, strat, engine=engine,
                                glasso_tol=glasso_tol,
                                glasso_steps=glasso_steps)
        stacked.append(torch.stack([
            trees.structure_error(est, adj_true).to(torch.float32),
            trees.structure_hamming(est, adj_true).to(torch.float32),
            trees.edge_f1(est, adj_true),
        ]))
    m = torch.stack(stacked).cpu().numpy()
    return {
        strat.label: {
            "error": float(m[i, 0]),
            "edit_distance": float(m[i, 1]),
            "edge_f1": float(m[i, 2]),
        }
        for i, strat in enumerate(strategies)
    }


# --------------------------------------------------------------------------
# Scalar Monte-Carlo engines (Figs. 5-6, 8, 9) — batched, one read a call
# --------------------------------------------------------------------------

def _mix(rho: torch.Tensor, x: torch.Tensor, z: torch.Tensor):
    """rho * x + sqrt(1 - rho^2) * z in f32."""
    return rho * x + torch.sqrt(1 - rho ** 2) * z


def mc_sign_crossover(n: int, rho_e: float, rho_ep: float, reps: int,
                      seed: int = 0, *, device=None) -> float:
    """Monte-Carlo Pr(theta_hat_e <= theta_hat_e') for the Fig. 4 shared-
    node pair — the crossover event of Figs. 5-6 — over ``reps`` trials
    of n samples each, drawn as ``repro`` draws them (one read)."""
    dev = resolve_device(device)
    kk, kj, ks = prng.split(prng.key(seed, device=dev), 3)
    rho_e = torch.tensor(rho_e, dtype=torch.float32, device=dev)
    rho_ep = torch.tensor(rho_ep, dtype=torch.float32, device=dev)
    xk = prng.normal(kk, (reps, n))
    xj = _mix(rho_e, xk, prng.normal(kj, (reps, n)))
    xs = _mix(rho_ep, xk, prng.normal(ks, (reps, n)))
    # theta_hat = agreements / n: comparing the counts is comparing them
    agree_e = (torch.sign(xj) * torch.sign(xk) > 0).sum(dim=1)
    agree_ep = (torch.sign(xk) * torch.sign(xs) > 0).sum(dim=1)
    hits = (agree_e <= agree_ep).sum().cpu().numpy()
    return float(np.float32(hits) / np.float32(reps))


def mc_persymbol_corr_error(n: int, rho: float, rate: int, reps: int, *,
                            against_empirical: bool = False, seed: int = 0,
                            device=None) -> float:
    """Monte-Carlo E|ref - mean(x_q * y_q)| for the R-bit per-symbol
    quantizer on a correlated Gaussian pair (``reps`` trials of n).

    ``against_empirical=True`` scores against the unquantized empirical
    correlation (the Fig. 8 relative error); False against the true rho
    (the Fig. 9 estimation error under a fixed bit budget).
    """
    dev = resolve_device(device)
    q = PerSymbolQuantizer(rate)
    kx, ke = prng.split(prng.key(seed, device=dev))
    rho_t = torch.tensor(rho, dtype=torch.float32, device=dev)
    x = prng.normal(kx, (reps, n))
    y = _mix(rho_t, x, prng.normal(ke, (reps, n)))
    est = (q.quantize(x) * q.quantize(y)).mean(dim=1)
    ref = (x * y).mean(dim=1) if against_empirical else rho_t
    return float((ref - est).abs().mean().cpu())
