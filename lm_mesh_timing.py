#!/usr/bin/env python3
"""The LM mesh on several cards: N ranks, one a card, on NCCL.

  python3 lm_mesh_timing.py --ranks 4        # a host with 4 cards

The script spawns ``--ranks`` processes (``torch.multiprocessing.spawn``,
a ``FileStore`` under ``build/``), rank r on ``cuda:r``, and checks and
times the port's LM mesh across them:

- llama4-scout-17b-a16e whole (48 layers, bf16) over (1, N): every rank
  draws each full leaf in turn and keeps its quarter, then serves a batch
  of 8 prompts of 2048 tokens and 32 greedy tokens (``launch.serve``'s
  ``serve``). Logs prefill and decode tok/s, the peak memory of each
  card, the held parameters, the dropped assignments and the kernels'
  launches.
- granite-8b over every (D, M) with D * M = N, beside the mesh-less run
  on the rank's own card at the same shape (phase 7's): prefill and
  decode tok/s, and the mesh's logits on the mesh-less run's tokens
  within ``chip_smoke.MESH_BF16_ULPS`` bf16 ulps of the largest logit,
  ids equal but at near-ties.
- stablelm-3b's train step over (N, 1) and (N/2, 2): 6 steps at full width
  in bf16 (batch 4, 2048 tokens, phase 16's shape), warm s a step, tok/s
  and the peak memory of each card beside the mesh-less card's; and the
  reduced model's 3 f32 steps held to the mesh-less card's by phase 16
  (c)'s rule (``chip_smoke.TRAIN_RTOL``, ``TRAIN_PARAM_REL``).
- ``compressed_pmean`` at rate 4 over the N ranks on stablelm-3b's
  gradient (one call a parameter) beside the f32 all-reduce of the same
  leaves: CUDA-event ms and the bytes each puts on the wire a rank.

``--device cpu --reduced`` rehearses the same runs on gloo ranks at the
reduced sizes. The parent prints the card's name and power limit, then
one JSON line a rank; a failed check exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
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

SCOUT, GRANITE, TRAIN = "llama4-scout-17b-a16e", "granite-8b", "stablelm-3b"


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _expect(cond, what):
    if not cond:
        raise AssertionError(what)


def _peak(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _event_ms(fn, dev, reps=3):
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


def _cfg(arch, args, **repl):
    from repro_torch.models.arch import get_arch

    cfg = get_arch(arch)
    cfg = cfg.reduced() if args.reduced else cfg
    return dataclasses.replace(cfg, **repl) if repl else cfg


def _model(cfg, dev, dtype, mesh=None, **layout):
    import torch
    from repro_torch.models.transformer import Transformer

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return Transformer(cfg, device=dev, dtype=dtype, generator=gen,
                       mesh=mesh, **layout)


def _serve(model, args, dev):
    """Warm-up, then ``serve`` at (batch, prompt, gen): (result, launches,
    peak bytes)."""
    from repro_torch.kernels import launches, reset_launches
    from repro_torch.launch.serve import random_embeds, random_prompts, serve

    b, s, n = args.batch, args.prompt, args.gen
    prompts = random_prompts(model, b, s)
    w = min(64, s)
    serve(model, prompts[:, :w], gen=2, **random_embeds(model, b, w))
    _reset_peak(dev)
    reset_launches()
    res = serve(model, prompts, gen=n, **random_embeds(model, b, s))
    return res, launches(), _peak(dev)


def _rates(res, args) -> dict:
    b, s, n = args.batch, args.prompt, args.gen
    return {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
            "prefill_tok_s": b * s / res.prefill_s,
            "decode_tok_s": b * (n - 1) / res.decode_s}


def _scout(dev, args, out):
    """llama4-scout (whole, or ``--scout-layers``) over (1, N)."""
    import chip_smoke as cs
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import random_embeds, random_prompts

    cfg = _cfg(SCOUT, args, **({"n_layers": args.scout_layers}
                               if args.scout_layers else {}))
    mesh = make_host_mesh(1, args.ranks, device=dev.type)
    _reset_peak(dev)
    t0 = time.perf_counter()
    model = _model(cfg, dev, torch.bfloat16, mesh)
    _sync(dev)
    t_init = time.perf_counter() - t0
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    init_peak = _peak(dev)
    res, counts, peak = _serve(model, args, dev)
    _expect(res.logits_finite, "scout: a logit is not finite")
    _expect(int(res.ids.max()) < cfg.vocab, "scout: a padding id")
    b, s = args.batch, args.prompt
    _, _, drops = cs.mesh_greedy(model, random_prompts(model, b, s),
                                 random_embeds(model, b, s), 1)
    out["scout"] = {"layers": cfg.n_layers, "mesh": [1, args.ranks],
                    "params": model.param_count(), "held_bytes": held,
                    "init_s": t_init, "init_peak_bytes": init_peak,
                    "serve_peak_bytes": peak,
                    "dropped_prefill_and_1_step": drops,
                    "launches": counts, "ids0": res.ids[0, :12].tolist(),
                    **_rates(res, args)}
    del model
    _reset_peak(dev)


def _granite(dev, args, out):
    """granite-8b over every (D, M), beside the mesh-less card run."""
    import chip_smoke as cs
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import random_embeds, random_prompts

    cfg = _cfg(GRANITE, args)
    b, s, n = args.batch, args.prompt, args.gen
    model = _model(cfg, dev, torch.bfloat16)
    alone, _, peak = _serve(model, args, dev)
    prompts, emb = random_prompts(model, b, s), random_embeds(model, b, s)
    ref, ref_ids, _ = cs.mesh_greedy(model, prompts, emb, n - 1)
    del model
    bound = cs.MESH_BF16_ULPS * 2.0 ** -8 * float(
        ref[..., :cfg.vocab].abs().max())
    runs = {"mesh-less": {**_rates(alone, args), "peak_bytes": peak}}
    for d in [r for r in range(1, args.ranks + 1) if args.ranks % r == 0]:
        shape = (d, args.ranks // d)
        mesh = make_host_mesh(*shape, device=dev.type)
        _reset_peak(dev)
        model = _model(cfg, dev, torch.bfloat16, mesh)
        res, counts, peak = _serve(model, args, dev)
        lg, ids, _ = cs.mesh_greedy(model, prompts, emb, n - 1,
                                    ref_ids.to(dev))
        err = float((lg - ref)[..., :cfg.vocab].abs().max())
        _expect(err <= bound, f"granite {shape}: logits {err} > {bound}")
        ties = []
        for r, i in (ids != ref_ids).nonzero().tolist():
            top = ref[i, r].topk(2).values
            gap = float(top[0] - top[1])
            _expect(gap <= bound, f"granite {shape}: id at ({r}, {i}) "
                    f"differs, top-2 gap {gap}")
            ties.append((r, i, gap))
        runs[f"{shape}"] = {**_rates(res, args), "peak_bytes": peak,
                            "max_logit_err": err, "bound": bound,
                            "near_ties": ties, "launches": counts}
        del model
    out["granite"] = runs


def _train(dev, args, out):
    """stablelm-3b's steps over (N, 1) and (N/2, 2): full width bf16
    timing; the reduced model's f32 steps against the mesh-less card's."""
    import chip_smoke as cs
    import torch
    from repro_torch.data import TokenStream, token_batches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shapes import InputShape
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamW, linear_warmup_cosine

    shapes = [(args.ranks, 1)] + ([(args.ranks // 2, 2)]
                                  if args.ranks % 2 == 0 else [])
    cfg = _cfg(TRAIN, args)
    b, s, steps = args.train_batch, args.train_seq, 6
    runs = {}
    for shape in [None] + shapes:
        mesh = None if shape is None else make_host_mesh(*shape,
                                                         device=dev.type)
        _reset_peak(dev)
        model = _model(cfg, dev, torch.bfloat16, mesh,
                       **({} if mesh is None else {"fsdp": True}))
        model.requires_grad_(True)
        opt = AdamW(model.parameters())
        step = make_train_step(cfg, InputShape("cli", "train", s, b),
                               linear_warmup_cosine(3e-4, 2, steps))
        stream = TokenStream(cfg.vocab, s, b, seed=0)
        walls, losses = [], []
        for batch in token_batches(stream, device=dev, stop=steps,
                                   prefetch=4):
            _sync(dev)
            t0 = time.perf_counter()
            m = step(model, opt, batch)
            losses.append(float(m["loss"]))
            _sync(dev)
            walls.append(time.perf_counter() - t0)
        warm = statistics.median(walls[2:])
        runs["mesh-less" if shape is None else f"{shape}"] = {
            "warm_step_s": warm, "tok_s": b * s / warm,
            "peak_bytes": _peak(dev), "losses": losses}
        del model, opt
    c = cs.MESH_TRAIN
    alone, init, final = cs._train_steps(dev, None, c)
    for shape in shapes:
        metrics, init_m, final_m = cs._train_steps(
            dev, make_host_mesh(*shape, device=dev.type), c)
        for a, w in zip(metrics, alone):
            for k in ("loss", "grad_norm"):
                _expect(abs(a[k] - w[k]) <= cs.TRAIN_RTOL * abs(w[k]),
                        f"train {shape}: {k} {a[k]} vs {w[k]}")
        worst = 0.0
        for name, w in final.items():
            _expect(torch.equal(init_m[name], init[name]),
                    f"train {shape}: the sharded init of {name}")
            rel = float((final_m[name] - w).norm()
                        / (w - init[name]).norm().clamp_min(1e-30))
            _expect(rel <= cs.TRAIN_PARAM_REL, f"train {shape} {name}: {rel}")
            worst = max(worst, rel)
        runs[f"{shape}"]["reduced_f32"] = {
            "losses": [m["loss"] for m in metrics],
            "mesh_less_losses": [m["loss"] for m in alone],
            "worst_param_rel": worst}
    out["train"] = runs


def _compressed(dev, args, out):
    """compressed_pmean (rate 4) of stablelm-3b's gradient, one call a
    parameter, beside the f32 all-reduce of the same leaves."""
    import torch
    import torch.distributed as dist
    from repro_torch.comm import compressed_pmean
    from repro_torch.launch.mesh import make_trial_mesh
    from repro_torch.models.transformer import Transformer

    cfg = _cfg(TRAIN, args)
    shapes = [tuple(p.shape) for p in Transformer(
        cfg, device="meta").parameters()]
    gen = torch.Generator(device=dev)
    gen.manual_seed(dist.get_rank())
    grads = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    group = make_trial_mesh(args.ranks, device=dev.type).get_group("data")
    n = sum(g.numel() for g in grads)
    p = args.ranks

    def f32():
        for g in grads:
            dist.all_reduce(g.clone(), group=group)

    def comp():
        for g in grads:
            compressed_pmean(g, group, 4)

    ms_f32, ms_comp = _event_ms(f32, dev), _event_ms(comp, dev)
    err = []
    for g in grads[:4]:
        ref = g.clone()
        dist.all_reduce(ref, group=group)
        ref /= p
        c = compressed_pmean(g, group, 4)
        err.append(float((c - ref).square().mean().sqrt()
                         / ref.square().mean().sqrt()))
    out["compressed"] = {
        "elements": n, "leaves": len(grads), "rate": 4,
        "f32_allreduce_ms": ms_f32, "compressed_pmean_ms": ms_comp,
        # ring all-reduce: 2 (p-1)/p of the f32 bytes a rank; the codes'
        # all-to-all and all-gather: (p-1)/p of the int8 bytes each
        "f32_wire_bytes": int(2 * (p - 1) / p * 4 * n),
        "compressed_wire_bytes": int(2 * (p - 1) / p * n),
        "rel_rmse_first_leaves": err}


def _rank(rank, args, store, work):
    import torch
    from repro_torch.launch.mesh import init_rank

    dev = init_rank(rank, args.ranks, store, device=(
        f"cuda:{rank}" if args.device == "cuda" else "cpu"))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    out = {"rank": rank, "device": str(dev)}
    for part in args.parts.split(","):
        t0 = time.perf_counter()
        {"scout": _scout, "granite": _granite, "train": _train,
         "compressed": _compressed}[part](dev, args, out)
        out[f"{part}_s"] = time.perf_counter() - t0
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--reduced", action="store_true",
                   help="the reduced configs (a CPU rehearsal)")
    p.add_argument("--scout-layers", type=int, default=0,
                   help="cut llama4-scout's decoder (default: whole)")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=2048)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--train-batch", type=int, default=4)
    p.add_argument("--train-seq", type=int, default=2048)
    p.add_argument("--parts", default="scout,granite,train,compressed")
    p.add_argument("--out", default="",
                   help="also write the ranks' JSON lines to this file")
    args = p.parse_args()
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"lm_mesh_timing: needs {args.ranks} cards, found "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    work = os.path.join(ROOT, "build", "lm_mesh_timing")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    mp.spawn(_rank, args=(args, os.path.join(work, "store"), work),
             nprocs=args.ranks)
    lines = []
    for r in range(args.ranks):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            lines.append(json.dumps(pickle.load(f)))
            print(lines[-1], flush=True)
    shutil.rmtree(work)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    print(f"lm_mesh_timing: {args.ranks} ranks, every check passed, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
