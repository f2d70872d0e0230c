"""Dry run: one rank's step of every (arch x shape x production mesh),
counted on meta tensors (the port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each program from ShapeDtypeStructs over
512 placeholder host devices and reads XLA's memory and cost analyses.
Here one process joins a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives complete
at once and move nothing), so ``make_production_mesh`` builds its mesh
unchanged. It builds rank ``--rank``'s model on the meta device over
that mesh (its local leaves only; nothing is allocated, no full leaf is
drawn) and runs the program's step under ``op_analysis``'s counts.
For each combination it writes one JSON record with ``repro``'s keys:

* ``memory``: ``argument_bytes`` (the rank's parameters, AdamW moments,
  batch rows and cache: exact), ``output_bytes`` (what the step
  returns), ``temp_bytes`` (the most the step's other tensors held at
  once), and ``peak_bytes``, ``entry_bytes`` (the global batch the
  port's entry points take on every rank, beyond its rows),
  ``hbm_bytes`` and ``fits`` (the peak against the card's memory);
* ``cost``: ``flops_per_device`` (aten FLOPs plus the attention
  kernels' by formula), ``bytes_per_device`` (``hlo_analysis``'s byte
  proxy) and their parts;
* ``collectives``: {total_bytes, by_op, count}.

``repro``'s programs scan the layers (and a train step its microbatches)
and ``hlo_analysis`` weights each loop body by its trip count. Here the
step runs over one and two superblocks (a train step: two and three) and
one and two microbatches, and ``op_analysis.extrapolate`` weights the
differences by the trip counts (exact: the superblocks and the
microbatches repeat the same ops); the record says so
(``meta.counted``).

The card's memory is ``--hbm-bytes``, else the visible card's; with
neither the tool raises. Records go to ``build/dryrun_torch/``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
      --shape train_4k --hbm-bytes 85899345920
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --hbm-bytes 85899345920

An architecture the meshes cannot hold (``not_planned``: the dropless MoE
of granite-4.0-h-small) is named as not planned, with the reason.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.models.arch import get_arch, list_archs

from . import op_analysis as A
from . import steps as S
from .mesh import _mesh, make_production_mesh
from .shapes import SHAPES

ARTIFACT_DIR = os.path.join("build", "dryrun_torch")


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """The default process group as a fake group of ``world`` ranks, this
    process rank ``rank``, for the block's length. Raises when a group
    is already initialized (a dry run needs a process of its own)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own process: a process "
                           "group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def hbm_capacity(hbm_bytes: float | None) -> float:
    """The card's memory: ``hbm_bytes``, else the visible card's; raises
    with neither."""
    if hbm_bytes:
        return float(hbm_bytes)
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory)
    raise ValueError("the dry run needs the card's memory: pass --hbm-bytes "
                     "(no card is visible)")


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _storage_bytes(tensors) -> int:
    return sum({t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in tensors if isinstance(t, torch.Tensor)}.values())


def _leaves(out) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]


def superblocks(cfg, k: int):
    """``cfg`` cut to ``k`` superblocks (its pattern, and an encoder's,
    ``k`` times), every width kept."""
    fields = {"n_layers": k * len(cfg.pattern)}
    if cfg.is_encoder_decoder:
        fields["encoder_layers"] = k * len(cfg.encoder_pattern)
    return dataclasses.replace(cfg, **fields)


def _count(plan, cfg, shape, mesh, *, device, batch: dict, trips: int):
    """One step of ``cfg`` on ``device`` over ``mesh`` by ``plan``, counted:
    (Count, bytes the step returned)."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW, linear_warmup_cosine

    model = Transformer(cfg, device=device, dtype=plan.param_dtype,
                        mesh=mesh, **plan.layout)
    args = list(model.parameters()) + list(batch.values())
    b = shape.global_batch
    if plan.kind == "train":
        model.requires_grad_(True)
        opt = AdamW(model.parameters(), mu_dtype=plan.moments_dtype)
        args += [t for st in opt.state.values() for t in st.values()]
        step = S.make_train_step(cfg, shape, linear_warmup_cosine(
            3e-4, 100, 10_000), microbatches=trips)
        part = {k: v[:b // plan.microbatches * trips]
                for k, v in batch.items()}
        with A.counting(args) as count:
            out = step(model, opt, part)
    elif plan.kind == "prefill":
        with A.counting(args) as count:
            out = S.make_prefill_step(cfg, shape)(model, batch)
    else:
        cache = model.init_cache(b, shape.seq_len, window=plan.window,
                                 memory_len=S.encoder_frames(cfg, shape))
        args += [t for c in cache for t in c.values()]
        with A.counting(args) as count:
            out = S.make_serve_step(cfg, shape)(
                model, cache, batch["token"], shape.seq_len - 1)
    held = {t.untyped_storage()._cdata for t in args}
    return count, _storage_bytes([t for t in _leaves(out)
                                  if t.untyped_storage()._cdata not in held])


def _run(plan: S.ProgramPlan, cfg, shape, mesh, *, device="meta") -> dict:
    """The record parts of ``plan``'s step on this rank: the arguments of
    the whole model, exact; the counts extrapolated by
    ``op_analysis.extrapolate`` from one and two superblocks (a train
    step, whose peak at one superblock falls before the optimizer: two
    and three) and one and two microbatches."""
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW

    model = Transformer(cfg, device=device, dtype=plan.param_dtype,
                        mesh=mesh, **plan.layout)
    batch = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
             for k, v in plan.batch.items()}
    b = shape.global_batch
    local = {k: v[model.batch_shard(b).rows] for k, v in batch.items()}
    arg_bytes = _bytes(model.parameters()) + _bytes(local.values())
    if plan.kind == "train":
        opt = AdamW(model.parameters(), mu_dtype=plan.moments_dtype)
        arg_bytes += _bytes(t for st in opt.state.values()
                            for t in st.values())
        del opt
    elif plan.kind == "decode":
        arg_bytes += _bytes(t for c in model.init_cache(
            b, shape.seq_len, window=plan.window,
            memory_len=S.encoder_frames(cfg, shape)) for t in c.values())
    del model
    depth = cfg.n_rep
    trips = plan.microbatches if plan.kind == "train" else 1
    base = 2 if plan.kind == "train" and depth > 2 else 1
    counts, outs = {}, {}
    for k in ((base, base + 1) if depth > 1 else (1,)):
        for t in ((1, 2) if trips > 1 else (1,)):
            counts[k, t], outs[k, t] = _count(
                plan, superblocks(cfg, k), shape, mesh, device=device,
                batch=batch, trips=t)
    count = A.extrapolate(counts, depth, trips, base)
    out_bytes = outs[base, 1] + (depth - base) * (
        outs.get((base + 1, 1), 0) - outs[base, 1])
    entry = _bytes(batch.values()) - _bytes(local.values())
    meta = dict(plan.meta, layout=plan.layout,
                param_dtype=str(plan.param_dtype).replace("torch.", ""),
                counted=(f"the step over {base} and {base + 1} of the "
                         f"{cfg.n_rep} superblocks" if depth > 1 else
                         "the step") + (
                    f", over 1 and 2 of its {trips} microbatches" if
                    trips > 1 else "") + ", extrapolated by trip count")
    if plan.kind == "train":
        meta["step_on_host"] = ("the AdamW step count is a host int "
                                "(repro: an int32 leaf, replicated)")
    return {
        "meta": meta,
        "memory": {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
                   "temp_bytes": max(count.peak_bytes - out_bytes, 0),
                   "peak_bytes": arg_bytes + entry + count.peak_bytes,
                   "entry_bytes": entry},
        "cost": {"flops_per_device": count.flops,
                 "bytes_per_device": count.hbm_bytes,
                 "dot_flops": count.dot_flops,
                 "kernel_flops": count.kernel_flops,
                 "kernels": {k: {"calls": v[0], "flops": v[1], "bytes": v[2]}
                             for k, v in count.kernels.items()}},
        "collectives": count.collectives(),
        "largest": count.largest_tensors(),
    }


def dry_run(cfg, shape, mesh, *, param_dtype=torch.bfloat16,
            fsdp: bool = True, microbatches: int = 0,
            budget: float | None = None) -> dict:
    """One rank's step of ``cfg`` at ``shape`` on ``mesh`` (a mesh of the
    current process group; this process its rank), counted on the meta
    device: the record's meta, memory, cost and collectives."""
    plan = S.plan_program(cfg, shape, mesh, param_dtype=param_dtype,
                          fsdp=fsdp, microbatches=microbatches,
                          budget=budget)
    return _run(plan, cfg, shape, mesh)


def not_planned(cfg) -> str | None:
    """Why the dry run cannot plan ``cfg`` on a production mesh, or None."""
    if cfg.moe_dropless:
        return ("its dropless MoE runs on one device; the production "
                "meshes need an expert-parallel path it does not have")
    return None


def run_one(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
            hbm_bytes: float, fsdp: bool = True, tag: str = "",
            microbatches: int = 0, rank: int = 0,
            buffers: bool = False) -> dict:
    """The dry run of ``arch`` at ``shape_name`` on rank ``rank`` of the
    256-rank ``pod16x16`` or (``multi_pod``) the 512-rank ``pod2x16x16``
    mesh; writes and returns its record. The inference budget is
    ``steps.BUDGET_SHARE`` of ``hbm_bytes``."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    name = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    world = 512 if multi_pod else 256
    t0 = time.time()
    with fake_group(world, rank):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        parts = dry_run(cfg, shape, mesh, fsdp=fsdp,
                        microbatches=microbatches,
                        budget=S.BUDGET_SHARE * hbm_bytes)
    mem = parts["memory"]
    mem["hbm_bytes"] = hbm_bytes
    mem["fits"] = mem["peak_bytes"] <= hbm_bytes
    if buffers:
        for nbytes, desc in parts["largest"]:
            print(f"  buf {nbytes / 2**20:10.1f} MiB  {desc[:120]}")
    rec = {"name": name, "arch": arch, "shape": shape_name,
           "mesh": mesh_name, "kind": shape.kind, "n_devices": world,
           "rank": rank, "dry_s": round(time.time() - t0, 2), **parts}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump(rec, f, indent=1, default=str)
    return rec


@contextlib.contextmanager
def on_mesh(shape: tuple, names: tuple, rank: int = 0):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over a fake group
    of its ranks, this process rank ``rank``, for the block's length (a
    small mesh's dry run, as the tests run it)."""
    with fake_group(math.prod(shape), rank):
        yield _mesh("cpu", shape, names)


def fmt_row(r: dict) -> str:
    mem = r["memory"]
    return (
        f"{r['arch']:<26} {r['shape']:<12} {r['mesh']:<11} "
        f"{r['cost']['flops_per_device'] / 1e12:>9.3f}TF "
        f"{r['cost']['bytes_per_device'] / 2**30:>8.2f}GiB "
        f"{r['collectives']['total_bytes'] / 2**20:>10.1f}MiB-coll "
        f"{mem['argument_bytes'] / 2**30:>7.2f}GiB-arg "
        f"{mem['peak_bytes'] / 2**30:>7.2f}GiB-peak "
        f"{'fits' if mem['fits'] else 'DOES NOT FIT'} "
        f"t={r['dry_s']:>5.1f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--buffers", action="store_true",
                    help="print the step's largest tensors")
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step is counted")
    ap.add_argument("--hbm-bytes", type=float, default=None,
                    help="the card's memory (default: the visible card's)")
    args = ap.parse_args(argv)
    hbm = hbm_capacity(args.hbm_bytes)
    torch.set_num_threads(1)

    # explicit --arch/--shape always narrow the sweep; --all covers the rest
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures, over = [], []
    for arch in archs:
        why = not_planned(get_arch(arch))
        if why:
            print(f"NOT PLANNED {arch}: {why}", flush=True)
            continue
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_one(arch, shape, mp, args.out, hbm_bytes=hbm,
                                  fsdp=not args.no_fsdp, tag=args.tag,
                                  microbatches=args.microbatches,
                                  rank=args.rank, buffers=args.buffers)
                    print("OK  " + fmt_row(rec), flush=True)
                    if not rec["memory"]["fits"]:
                        over.append(rec["name"])
                except Exception as e:  # noqa: BLE001 — report, keep sweeping
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"FAIL {arch} {shape} multi_pod={mp}: {e}",
                          flush=True)
                    traceback.print_exc()
    if over:
        print(f"\n{len(over)} do not fit {hbm / 2**30:.1f} GiB: "
              + ", ".join(over))
    if failures:
        print(f"\n{len(failures)} FAILURES")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall combinations dry-run")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
