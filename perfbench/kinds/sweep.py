"""Traffic kind ``sweep``: whole Monte-Carlo sweeps over a pool of plans.

Set-up builds the traffic's pool of plans (seed0 from ``--seed``, spaced
``reps`` apart; a real study pays its trees' set-up once, the pool stands
for that) and runs each once. The window runs ``run_trials(plan)`` whole,
cycling the pool. A staged sweep runs one plan's stages one by one
(sample -> weights -> MWST and metric sums, each n of the plan) for the
spans and for the check of its intermediates.

The check stages every plan of the pool and follows the program step by
step: the reference works out the samples again from the plan's keys,
and the weights and trees from the program's samples, so that a sign
flip of a sample a few ulps from 0 does not move an integer Gram; the sampler is held to the reference's
samples by itself.
"""
from __future__ import annotations

import contextlib

import torch

from .. import gen, reference, roofline
from ..reference import TF32


def label(s: dict) -> str:
    """The paper's legend name of a strategy."""
    m = s.get("method", "sign")
    return m if m in ("sign", "original") else f"R{s.get('rate', 1)}"


class Program:
    """The system under test: ``repro_torch``'s trial plane."""

    def __init__(self, strategies: list[dict], device):
        from repro_torch.core import estimators, experiments, sampler
        from repro_torch.core.chow_liu import boruvka_mst_batch
        from repro_torch.core.gram import GramEngine
        from repro_torch.core.strategy import Strategy

        self.ex, self.est, self.smp = experiments, estimators, sampler
        self.mst, self.engine = boruvka_mst_batch, GramEngine
        self.strategies = tuple(Strategy(**s) for s in strategies)
        self.device = torch.device(device)

    def plan(self, cfg: dict, seed0: int):
        return self.ex.TrialPlan(
            d=cfg["d"], ns=tuple(cfg["ns"]), strategies=self.strategies,
            reps=cfg["reps"], tree=cfg["tree"], rho_min=cfg["rho_min"],
            rho_max=cfg["rho_max"], seed0=seed0)

    def run(self, plan) -> dict:
        res = self.ex.run_trials(plan, device=self.device)
        return {s.label: (res.error_rate[s.label], res.edit_distance[s.label])
                for s in self.strategies}

    def _setup(self, plan):
        return self.ex._plan_setup(*self.ex._setup_key(plan),
                                   str(self.device))

    def sample(self, plan, n: int):
        parents, rhos, _, keys = self._setup(plan)
        return self.smp.sample_tree_ggm_rows_batch(
            keys, plan.bucket_for(n), parents, rhos)

    def weights(self, plan, x, n: int):
        engine = plan.budget_engine(self.engine(), device=self.device)
        return torch.stack([self.est.strategy_weights_batch(
            x, s, n_valid=n, engine=engine) for s in plan.strategies])

    def trees(self, plan, w):
        """The MWST stage as ``experiments._metric_sums`` runs it: one
        fixed-round Boruvka of the (S * reps) stack, then the metric
        sums; returns the trees."""
        S, r, d, _ = w.shape
        adj = self.mst(w.reshape(S * r, d, d), plan.metrics_chunk(),
                       early_exit=False).reshape(S, r, d, d)
        self.ex.structure_metric_channels(adj, self._setup(plan)[2][None]) \
            .sum(dim=1)
        return adj


class Control:
    """The reference in the program's place, in TF32 (the sampler's
    mixing and the Grams; the program states full f32)."""

    def __init__(self, strategies: list[dict], device):
        self.strategies = strategies
        self.device = torch.device(device)

    def plan(self, cfg: dict, seed0: int) -> dict:
        parents, rhos = reference.trial_truth(
            cfg["d"], cfg["reps"], seed0, cfg["rho_min"], cfg["rho_max"],
            self.device)
        return {"cfg": cfg, "seed0": seed0, "parents": parents,
                "rhos": rhos, "truth": reference.truth_adjacency(parents)}

    def run(self, plan: dict) -> dict:
        out = {label(s): ([], []) for s in self.strategies}
        for n in plan["cfg"]["ns"]:
            adj = self.trees(plan, self.weights(plan, self.sample(plan, n), n))
            m = reference.point_metrics(adj, plan["truth"])
            for i, s in enumerate(self.strategies):
                out[label(s)][0].append(float(m[i, 0]))
                out[label(s)][1].append(float(m[i, 1]))
        return out

    def sample(self, plan: dict, n: int):
        return reference.sweep_samples(plan["seed0"], plan["cfg"]["reps"], n,
                                       plan["parents"], plan["rhos"], TF32)

    def weights(self, plan: dict, x, n: int):
        return reference.sweep_weights(x, self.strategies, n, TF32)

    def trees(self, plan: dict, w):
        S, r, d, _ = w.shape
        return reference.max_spanning_tree(w.reshape(S * r, d, d))[1] \
            .reshape(S, r, d, d)


SYSTEMS = {"program": Program, "control": Control}


class Workload:
    unit = "trial"
    #: traced: whole sweeps timed, staged sweeps, profiled sweeps
    trace_reps = (2, 2, 2)

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 system: str = "program"):
        self.cfg, self.seed, self.device = config, int(seed), device
        self.d, self.ns, self.reps = (int(config["d"]),
                                      [int(n) for n in config["ns"]],
                                      int(config["reps"]))
        self.strategies = traffic["strategies"]
        self.labels = [label(s) for s in self.strategies]
        self.pool = int(traffic.get("pool", 4))
        self.sys = SYSTEMS[system](self.strategies, device)
        self.seeds = gen.plan_seeds(self.seed, self.pool, self.reps)
        self.plans, self.first = [], []

    def setup(self) -> None:
        self.plans = [self.sys.plan(self.cfg, s0) for s0 in self.seeds]
        self.first = [self.sys.run(p) for p in self.plans]

    def call(self, i: int):
        k = i % self.pool
        return k, self.sys.run(self.plans[k])

    def units(self, answer) -> int:
        return len(self.ns) * len(self.strategies) * self.reps

    def staged(self, spans) -> dict:
        return self._stage(self.seed % self.pool, spans)

    def _stage(self, k: int, spans) -> dict:
        """Plan ``k``'s sweep stage by stage, each stage under a span."""
        plan = self.plans[k]
        out = {"plan": k, "x": {}, "w": {}, "adj": {}}
        for n in self.ns:
            with spans("sample"):
                x = self.sys.sample(plan, n)
            with spans("weights"):
                w = self.sys.weights(plan, x, n)
            with spans("mst"):
                adj = self.sys.trees(plan, w)
            out["x"][n], out["w"][n], out["adj"][n] = x, w, adj
        return out

    def counts(self) -> dict:
        """(operations, bytes) of a whole sweep: its Grams' distinct
        entries over the valid samples (the sampler's O(n d) and the
        MWST's are left out)."""
        S, r, d = len(self.strategies), self.reps, self.d
        ops = sum(S * r * roofline.gram_ops(n, d) for n in self.ns)
        return {"whole": (ops, 0)}

    def check(self, answers, staged: dict | None) -> tuple[dict, list]:
        """(the numbers compared, and for each answer its own numbers),
        over every plan of the pool (the staged call's plan from its
        stages, the others staged here): ``sample_gap`` (max |x - x_ref|
        of the samples), ``stat_gap`` (max over strategies and n of
        :func:`reference.stat_gap`), ``tree_gap`` (max over the trials,
        as the tree kind reads it), ``metric_gap`` (max |error rate or
        edit distance - the reference's from the staged trees| over
        every answer of the plan and its set-up answer) and
        ``answers_differ`` (sweeps unlike the set-up's of their plan)."""
        per = [{"answers_differ": float(res != self.first[k])}
               for k, res in answers]
        numbers = {"sample_gap": 0.0, "stat_gap": 0.0, "tree_gap": 0.0,
                   "metric_gap": 0.0,
                   "answers_differ": sum(a["answers_differ"] for a in per)}
        if staged is None:
            return numbers, per
        for k in range(self.pool):
            st = staged if k == staged["plan"] else self._stage(
                k, lambda name: contextlib.nullcontext())
            ref = self._check_plan(k, st, numbers)
            del st
            for a, (kk, res) in zip(per + [{}],
                                    answers + [(k, self.first[k])]):
                if kk != k:
                    continue
                g = max(abs(u - v) for lab in self.labels for j in (0, 1)
                        for u, v in zip(res[lab][j], ref[lab][j]))
                a["metric_gap"] = g
                numbers["metric_gap"] = max(numbers["metric_gap"], g)
        return numbers, per

    def _check_plan(self, k: int, st: dict, numbers: dict) -> dict:
        """Plan ``k``'s staged samples, weights and trees against the
        reference (raising ``numbers`` in place); returns the reference's
        error rate and edit distance of the staged trees by strategy."""
        dev, d, r = self.device, self.d, self.reps
        parents, rhos = reference.trial_truth(
            d, r, self.seeds[k], self.cfg["rho_min"], self.cfg["rho_max"],
            dev)
        truth = reference.truth_adjacency(parents)
        xr = reference.sweep_samples(self.seeds[k], r, max(self.ns),
                                     parents, rhos)
        numbers["sample_gap"] = max(numbers["sample_gap"], *(
            float((st["x"][n] - xr[:, :n]).abs().max()) for n in self.ns))
        del xr
        ref = {lab: ([], []) for lab in self.labels}
        S = len(self.strategies)
        for n in self.ns:
            # each stage's tensors are let go once read
            wr = reference.sweep_weights(st["x"].pop(n), self.strategies, n)
            w = st["w"].pop(n)
            for i, s in enumerate(self.strategies):
                numbers["stat_gap"] = max(
                    numbers["stat_gap"],
                    reference.stat_gap(w[i], wr[i], s.get("method", "sign")))
            del w
            adj = st["adj"].pop(n)
            gaps = reference.tree_gaps(adj.reshape(S * r, d, d),
                                       wr.reshape(S * r, d, d))
            numbers["tree_gap"] = max(numbers["tree_gap"],
                                      float(gaps.max()))
            m = reference.point_metrics(adj, truth)
            for i, lab in enumerate(self.labels):
                ref[lab][0].append(float(m[i, 0]))
                ref[lab][1].append(float(m[i, 1]))
            del wr, gaps, adj
        return ref
