"""Training driver: AdamW on the synthetic token stream, with checkpoints
and resume.

The port of ``repro.launch.train``: the same flags, log lines and
schedule (linear warm-up, then cosine decay), through
``steps.make_train_step``. Every attention layer runs the
``flash_prefill`` kernel, twice a step (the forward and its recompute
under the blocks' checkpoints), and its PyTorch gradient. Weights are
random draws from ``--seed`` on the device (the same distributions as
``repro``'s ``init_params``, not the same numbers). A checkpoint holds
the parameters and the optimizer's state and step; ``--ckpt-dir`` resumes
from its latest one, and the resumed run equals the straight run bit for
bit (the stream's batch i is a function of (seed, i)). A vision model's
prompts begin with P patch embeddings and an encoder-decoder model reads
encoder frames: both stubs' embeddings of step i come from
``prng.fold_in`` of (seed, i), as in ``repro``, and the text stream is
shortened by P.

  python -m repro_torch.launch.train --arch stablelm-3b --reduced \\
      --device cpu --steps 20 --batch 2 --seq 64
  python -m repro_torch.launch.train --arch stablelm-3b --param-dtype bf16 \\
      --steps 6 --warmup 2 --batch 4 --seq 2048 --log-every 1

With ``--data-par D --model-par M`` the run is sharded over a (D, M)
mesh (``repro``'s ``make_host_mesh`` and its size check; one rank a card
under ``torchrun``, or gloo ranks on the CPU): the weights and the
optimizer's moments FSDP'd over ``data`` and tensor-parallel over
``model`` (``repro`` trains with ``fsdp=True``), each data rank on its
rows of the global batch. A checkpoint holds the full leaves (rank 0
writes them), so a run resumes on any mesh; rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.core import prng
from repro_torch.data import TokenStream, token_batches
from repro_torch.models.arch import get_arch
from repro_torch.models.transformer import Transformer
from repro_torch.optim import AdamW, linear_warmup_cosine

from .mesh import _under_launcher, make_host_mesh
from .shapes import InputShape
from .steps import make_train_step, stub_rows


#: token batches drawn ahead in worker threads: a (4, 2048) batch at
#: vocab 50304 takes ~10 s of numpy, several device steps
PREFETCH = 4


@dataclasses.dataclass
class TrainResult:
    model: Transformer
    optimizer: torch.optim.Optimizer
    start: int                  # the step the run began at (resume)
    losses: list                # per step run, host floats
    grad_norms: list
    lrs: list
    step_s: list                # wall s of each step, synchronised
    data_s: list                # wall s waiting for each batch
    final_loss: float           # mean of the last 10 losses
    entropy_bound: float        # the stream's unigram entropy (nats)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def step_embeds(cfg, seed: int, step: int, batch: int, seq: int,
                device) -> dict:
    """The modality stubs' inputs of step ``step``, as ``repro``'s trainer
    draws them (a function of (seed, step), so a resumed run sees the same
    ones): for each of ``steps.stub_rows`` (a vision model's
    'modal_embeds', an encoder-decoder model's 'enc_embeds'), (batch,
    rows, D) of 0.02 * ``prng.normal`` (within 2^-21 of
    ``jax.random.normal``) under ``fold_in(key(seed), step)`` (the
    encoder's frames: ``key(seed + 1)``)."""
    out = {}
    for name, rows in stub_rows(cfg, seq).items():
        k = prng.fold_in(prng.key(seed + (name == "enc_embeds"),
                                  device=device), step)
        out[name] = 0.02 * prng.normal(k, (batch, rows, cfg.d_model))
    return out


def state_tree(model: Transformer, optimizer) -> dict:
    """What a checkpoint holds: {"params": {name: tensor}, "opt":
    optimizer.state_tree}."""
    named = list(model.named_parameters())
    return {"params": dict(named), "opt": optimizer.state_tree(named)}


def state_shardings(model: Transformer, optimizer) -> dict | None:
    """The placements of :func:`state_tree`'s leaves on the model's mesh
    (None without one): the moments lie as their parameters."""
    if model.shard is None:
        return None
    place = model.placements()
    return {"params": place,
            "opt": {"step": None,
                    "moments": {m: place for m in optimizer.moment_names}}}


@torch.no_grad()
def restore(model: Transformer, optimizer, directory: str, step: int
            ) -> None:
    """Load checkpoint ``step`` of ``directory`` into ``model`` and
    ``optimizer`` in place (through host memory, so the device never
    holds two copies; on a mesh each full leaf in turn is placed on the
    device and cut to the rank's slice)."""
    named = list(model.named_parameters())
    tree = load_checkpoint(directory, step, state_tree(model, optimizer),
                           to_numpy=True,
                           shardings=state_shardings(model, optimizer))
    for name, p in named:
        p.copy_(torch.as_tensor(tree["params"][name]))
    optimizer.load_state_tree(named, tree["opt"])


def _say(*parts) -> None:
    """Print on rank 0 (or without a process group)."""
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*parts, flush=True)


def train(arch: str, *, reduced: bool = False, steps: int = 100,
          batch: int = 8, seq: int = 256, lr: float = 3e-4,
          warmup: int = 20, seed: int = 0, param_dtype: str = "f32",
          device=None, ckpt_dir: str = "", ckpt_every: int = 100,
          log_every: int = 10, on_step: Callable | None = None,
          data_par: int = 1, model_par: int = 1, mesh=None
          ) -> TrainResult:
    """Train ``arch`` for ``steps`` steps (see the module docstring).
    ``on_step(step, model, optimizer, metrics)`` runs after each step and
    its checkpoint. ``mesh`` (or ``data_par`` x ``model_par`` > 1, or a
    launcher's group: ``make_host_mesh``) shards the run."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    dtype = torch.float32 if param_dtype == "f32" else torch.bfloat16
    dev = resolve_device(device)
    if mesh is None and (data_par * model_par > 1 or _under_launcher()):
        mesh = make_host_mesh(data_par, model_par, device=dev)
    if dev.type == "cuda" and mesh is not None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = Transformer(cfg, device=dev, dtype=dtype, generator=gen,
                        mesh=mesh, fsdp=mesh is not None)
    model.requires_grad_(True)
    shape = InputShape("cli", "train", seq, batch)
    optimizer = AdamW(model.parameters())
    schedule = linear_warmup_cosine(lr, warmup, steps)
    step_fn = make_train_step(cfg, shape, schedule)
    n_params = model.param_count()
    where = "" if mesh is None else f" mesh={tuple(mesh.shape)}"
    _say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
         f"(active {model.active_param_count()/1e6:.1f}M) device={dev} "
         f"dtype={dtype}{where}")

    start = 0
    if ckpt_dir:
        last = latest_step(ckpt_dir)
        if last is not None:
            restore(model, optimizer, ckpt_dir, last)
            start = last
            _say(f"resumed from step {start}")

    stream = TokenStream(vocab=cfg.vocab,
                         seq_len=seq - (cfg.modality_tokens or 0),
                         global_batch=batch, seed=seed)
    res = TrainResult(model, optimizer, start, [], [], [], [], [], 0.0,
                      0.0)
    batches = token_batches(stream, start, device=dev, prefetch=PREFETCH,
                            stop=steps)
    t_log = time.time()
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            emb = step_embeds(cfg, seed, step, batch, seq, dev)
            b = {**next(batches), **emb}
            t1 = time.perf_counter()
            metrics = step_fn(model, optimizer, b)
            res.losses.append(float(metrics["loss"]))
            res.grad_norms.append(float(metrics["grad_norm"]))
            _sync(dev)
            res.step_s.append(time.perf_counter() - t1)
            res.data_s.append(t1 - t0)
            res.lrs.append(float(metrics["lr"]))
            if (step + 1) % log_every == 0:
                dt = time.time() - t_log
                _say(f"step {step+1:5d} loss {res.losses[-1]:.4f} "
                     f"gnorm {res.grad_norms[-1]:.3f} "
                     f"lr {res.lrs[-1]:.2e} "
                     f"({dt/log_every:.2f}s/step)")
                t_log = time.time()
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step + 1,
                                state_tree(model, optimizer),
                                shardings=state_shardings(model, optimizer))
            if on_step is not None:
                on_step(step, model, optimizer, metrics)
    finally:
        batches.close()

    res.entropy_bound = stream.unigram_entropy_bound()
    res.final_loss = float(np.mean(res.losses[-10:])) if res.losses \
        else float("nan")
    _say(f"final loss {res.final_loss:.4f} "
         f"(unigram entropy bound {res.entropy_bound:.3f} nats)")
    return res


def main(argv=None, *, on_step: Callable | None = None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--param-dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train(args.arch, reduced=args.reduced, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 warmup=args.warmup, seed=args.seed,
                 param_dtype=args.param_dtype, device=args.device,
                 ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 log_every=args.log_every, on_step=on_step,
                 data_par=args.data_par, model_par=args.model_par)


if __name__ == "__main__":
    main()
