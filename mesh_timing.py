#!/usr/bin/env python3
"""The mesh and wire plane on several cards: N ranks, one a card, on NCCL.

  python3 mesh_timing.py --ranks 4        # a host with 4 cards

The script spawns ``--ranks`` processes (``torch.multiprocessing.spawn``,
a ``FileStore`` under ``build/``), rank r on ``cuda:r``, and checks and
times the port's wire runtime across them:

- ``PRODUCTION`` (d = 4096, n = 2^20, sign, int8): every rank holds rank
  0's batch (sampled there, broadcast), keeps its block of each
  (data, model) mesh with data * model = N, and runs
  ``distributed_learn_structure`` replicated and rowblock. The edges must
  be ``learn_structure``'s on the rank's card and the weights
  ``strategy_weights``' bit for bit (the Gram's sum over the data axis is
  of integers). Logs the wall seconds (median of 3 after a warm-up)
  beside ``learn_structure``'s, and the wire's own ms: the all-gather of
  the rank's (n/D, d/M) payload over the model axis and the sum of the
  (d, d) Gram over the data axis (CUDA-event medians).
- The trial plane: ``run_trials`` over ``make_trial_mesh(N)`` and the
  wire meshes ``(N/M, model=M)`` on ``chip_smoke.py``'s d = 1024 Fig. 3
  plan and its d = 1024 channel plan under ``MIXED_FAULTS``, each equal
  to the rank's mesh-less run bit for bit; warm trials/s beside it.

``--device cpu`` with small ``--d``/``--n``/``--trial-d`` rehearses the
same runs on gloo ranks. The parent prints the card's name and power
limit, then one JSON line a rank; a failed check exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(fn, dev, reps=3):
    """(result, median wall seconds of ``reps`` synchronised calls after a
    warm-up)."""
    out = fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


def _event_ms(fn, dev, reps=5):
    """Median CUDA-event ms of fn() after a warm-up (host ms on the CPU)."""
    import torch

    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _expect(cond, what):
    if not cond:
        raise AssertionError(what)


def _shapes(ranks: int) -> list[tuple[int, int]]:
    """Every (data, model) with data * model = ranks."""
    return [(ranks // m, m) for m in range(1, ranks + 1) if ranks % m == 0]


def _tree_runs(dev, args, out):
    import torch
    from repro_torch.comm.collectives import psum
    from repro_torch.configs import PRODUCTION
    from repro_torch.core import estimators
    from repro_torch.core.chow_liu import learn_structure
    from repro_torch.core.distributed import (WirePlan,
                                              distributed_learn_structure,
                                              distributed_weights)
    from repro_torch.core.strategy import Strategy
    from repro_torch.data import GGMDataset
    from repro_torch.data.ggm import vertical_sharding
    from repro_torch.launch.mesh import make_host_mesh

    x = GGMDataset(d=args.d, seed=PRODUCTION.seed).sample(args.n,
                                                          device=dev)
    torch.distributed.broadcast(x, 0)  # every rank: rank 0's batch
    s = Strategy(method=PRODUCTION.method)
    edges, t_single = _wall(lambda: learn_structure(x, strategy=s), dev)
    out["learn_structure_s"] = t_single
    for shape in _shapes(args.ranks):
        mesh = make_host_mesh(*shape, device=dev.type)
        for placement in ("replicated", "rowblock"):
            sp = Strategy(method=PRODUCTION.method, placement=placement)
            what = f"{shape} {placement}"
            got, t = _wall(lambda: distributed_learn_structure(
                x, mesh, strategy=sp), dev)
            _expect(got == edges, f"{what}: edges differ from "
                    f"learn_structure's")
            w = distributed_weights(x, mesh, strategy=sp)
            _expect(torch.equal(w, estimators.strategy_weights(x, sp)),
                    f"{what}: weights differ from strategy_weights")
            del w
            out[f"tree {what} s"] = t
        plan = WirePlan(s, mesh=mesh)
        payload = plan.encode(vertical_sharding(mesh)(x))
        out[f"wire {shape} all-gather ms"] = _event_ms(
            lambda: plan.wire(payload), dev)
        out[f"wire {shape} payload bytes"] = payload.numel()
        del payload
        gram = torch.zeros((args.d, args.d), device=dev)
        out[f"wire {shape} Gram sum ms"] = _event_ms(
            lambda: psum(gram, mesh.get_group("data")), dev)
        del gram
    del x


def _trial_runs(dev, args, out):
    import dataclasses

    from repro_torch.core import FIG3_STRATEGIES
    from repro_torch.core.experiments import TrialPlan, run_trials
    from repro_torch.core.faults import FaultPlan
    from repro_torch.launch.mesh import make_trial_mesh

    import chip_smoke as cs

    channels = TrialPlan(strategies=cs._channel_strategies(
        cs.WIDE_MACHINES, cs.WIDE_BUDGET), d=args.trial_d,
        ns=cs.CHANNEL_WIDE["ns"], reps=cs.CHANNEL_WIDE["reps"])
    plans = {"fig3": TrialPlan(strategies=FIG3_STRATEGIES, d=args.trial_d,
                               ns=cs.TRIALS_BIGD["ns"],
                               reps=cs.TRIALS_BIGD["reps"]),
             "channels mixed": dataclasses.replace(
                 channels, faults=FaultPlan(**cs.MIXED_FAULTS))}
    meshes = {f"data{args.ranks}": make_trial_mesh(args.ranks,
                                                   device=dev.type)}
    for data, model in _shapes(args.ranks)[1:]:
        meshes[f"wire{data}x{model}"] = make_trial_mesh(
            data, model=model, device=dev.type)
    for name, plan in plans.items():
        alone = run_trials(plan, device=dev)
        out[f"{name} mesh-less trials/s"] = run_trials(
            plan, device=dev).trials_per_s
        for m, mesh in meshes.items():
            for _ in range(2):  # cold, then warm
                got = run_trials(plan, mesh=mesh, device=dev)
                for f in ("error_rate", "edit_distance", "edge_f1",
                          "faults", "buckets", "host_syncs"):
                    _expect(getattr(got, f) == getattr(alone, f),
                            f"{name} {m}: {f} differs from mesh-less")
            out[f"{name} {m} trials/s"] = got.trials_per_s


def _rank(rank, args, store, work):
    import torch
    from repro_torch.launch.mesh import init_rank

    dev = init_rank(rank, args.ranks, store, device=(
        f"cuda:{rank}" if args.device == "cuda" else "cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    out = {"rank": rank, "device": str(dev)}
    _tree_runs(dev, args, out)
    _trial_runs(dev, args, out)
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    import chip_smoke as cs

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--d", type=int, default=cs.D)
    p.add_argument("--n", type=int, default=cs.MAIN_N)
    p.add_argument("--trial-d", type=int, default=cs.TRIALS_BIGD["d"])
    args = p.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"mesh_timing: needs {args.ranks} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    work = os.path.join(ROOT, "build", "mesh_timing")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    mp.spawn(_rank, args=(args, os.path.join(work, "store"), work),
             nprocs=args.ranks)
    for r in range(args.ranks):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            print(json.dumps(pickle.load(f)), flush=True)
    shutil.rmtree(work)
    print(f"mesh_timing: {args.ranks} ranks, every check passed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
