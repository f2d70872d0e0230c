"""LM serving: batched prefill, then greedy decode with a cache.

The port of ``repro.launch.serve`` for decoder-only LMs: dense
(granite-8b, ...), MoE (qwen2-moe-a2.7b), SSM (mamba2-370m) and hybrid
(jamba-1.5-large-398b) stacks. It prefills a batch of prompts, then
decodes greedily, reporting tokens/s. Every attention layer of the
prefill runs the ``flash_prefill`` kernel and every one of each decode
step the ``decode_attention`` kernel (their plain versions on the CPU);
MoE and Mamba2 layers run in PyTorch. Weights are random draws from
``--seed``, as in ``repro``.

  python -m repro_torch.launch.serve --arch granite-8b --batch 8 \\
      --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --batch 8 \\
      --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \\
      --reduced --device cpu --batch 2 --prompt-len 16 --gen 8
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.models.arch import get_arch
from repro_torch.models.transformer import Transformer


@dataclasses.dataclass
class ServeResult:
    ids: torch.Tensor       # (B, gen) greedy ids, on the model's device
    prefill_s: float        # wall seconds of the prefill
    decode_s: float         # wall seconds of the gen - 1 decode steps
    logits_finite: bool     # every real-vocab logit of every step finite


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: Transformer, prompts: torch.Tensor, *, gen: int,
          window: int = 0) -> ServeResult:
    """Prefill ``prompts`` (B, S) and decode ``gen`` tokens greedily (the
    first from the prefill's logits). Positions are host ints, so the loop
    reads nothing back from the device until it ends. Raises if a sampled
    id is a vocab-padding id."""
    cfg, dev = model.cfg, model.device
    b, s = prompts.shape
    vocab = cfg.vocab
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, window=window, max_len=s + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    finite = torch.isfinite(logits[..., :vocab]).all()
    tok = logits[:, -1, :].argmax(-1, keepdim=True)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, tok, s + i, window=window)
        finite &= torch.isfinite(logits[..., :vocab]).all()
        tok = logits[:, -1, :].argmax(-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    ids = torch.cat(out, dim=1)
    if int(ids.max()) >= vocab:
        raise RuntimeError("sampled a vocab-padding id")
    return ServeResult(ids, prefill_s, decode_s, bool(finite))


def build(arch: str, *, reduced: bool = False, seed: int = 0, device=None,
          dtype: torch.dtype | None = None) -> Transformer:
    """The model ``--arch`` names, weights drawn on ``device`` from a
    generator seeded with ``seed``; dtype defaults to bf16 on the card and
    f32 on the CPU."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, device=dev, dtype=dtype, generator=gen)


def random_prompts(model: Transformer, batch: int, length: int,
                   seed: int = 1) -> torch.Tensor:
    """(batch, length) prompt ids uniform over the real vocab, drawn on the
    model's device."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return torch.randint(0, model.cfg.vocab, (batch, length), generator=gen,
                         device=model.device)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="default: bfloat16 on cuda, float32 on cpu")
    ap.add_argument("--data-par", type=int, default=None,
                    help="not accepted: the port has no mesh yet")
    ap.add_argument("--model-par", type=int, default=None,
                    help="not accepted: the port has no mesh yet")
    args = ap.parse_args(argv)
    if args.data_par is not None or args.model_par is not None:
        ap.error("--data-par/--model-par need a device mesh, which the "
                 "port does not have yet")

    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    model = build(args.arch, reduced=args.reduced, seed=args.seed,
                  device=args.device, dtype=dtype)
    cfg = model.cfg
    prompts = random_prompts(model, args.batch, args.prompt_len)
    res = serve(model, prompts, gen=args.gen, window=args.window)
    b, s, gen = args.batch, args.prompt_len, args.gen
    print(f"arch={cfg.name} batch={b} prompt={s} gen={gen} "
          f"device={model.device} dtype={model.dtype}")
    print(f"prefill: {res.prefill_s:.3f}s ({b * s / res.prefill_s:.0f} tok/s)")
    print(f"decode : {res.decode_s:.3f}s "
          f"({b * (gen - 1) / max(res.decode_s, 1e-9):.0f} tok/s)")
    print("sample ids:", res.ids[0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
