"""LM serving: batched prefill, then greedy decode with a cache.

The port of ``repro.launch.serve`` for all ten architectures: dense
(granite-8b, ...), MoE (qwen2-moe-a2.7b), SSM (mamba2-370m), hybrid
(jamba-1.5-large-398b), vision-prefixed (llava-next-mistral-7b,
llama4-scout-17b-a16e) and encoder-decoder (seamless-m4t-large-v2)
stacks. It prefills a batch of prompts, then decodes greedily, reporting
tokens/s. Every attention layer of the prefill (encoder, decoder and
cross-attention) runs the ``flash_prefill`` kernel and every decoder and
cross-attention layer of each decode step the ``decode_attention``
kernel (their plain versions on the CPU); MoE and Mamba2 layers run in
PyTorch. Weights are random draws from ``--seed``, as in ``repro``; the
modality stubs' embeddings (a vision model's prefix, an audio model's
encoder frames) are random draws too.

  python -m repro_torch.launch.serve --arch granite-8b --batch 8 \\
      --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --batch 8 \\
      --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \\
      --reduced --device cpu --batch 2 --prompt-len 16 --gen 8
  python -m repro_torch.launch.serve --arch seamless-m4t-large-v2 \\
      --batch 8 --prompt-len 2048 --gen 32
  python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \\
      --layers 8 --batch 8 --prompt-len 2048 --gen 32

With ``--data-par D --model-par M`` the model is sharded over a (D, M)
mesh (``repro``'s ``make_host_mesh``; D * M must not exceed the world
size): one rank a card under ``torchrun`` (NCCL), or gloo ranks on the
CPU. Every rank draws the same prompts, runs its shard of the batch and
its slices of the weights (the layout ``steps.inference_layout``
chooses), and rank 0 prints:

  torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
      --arch llama4-scout-17b-a16e --model-par 4 --batch 8 \\
      --prompt-len 2048 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.models.arch import get_arch
from repro_torch.models.transformer import Transformer

from .mesh import _under_launcher, make_host_mesh
from .steps import inference_layout, modal_tokens, stub_rows


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
          window: int = 0, modal_embeds: torch.Tensor | None = None,
          enc_embeds: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``prompts`` (B, S) after the P rows of ``modal_embeds``
    (B, P, D), over the encoder's ``enc_embeds`` (B, Sm, D) for an
    encoder-decoder model, and decode ``gen`` tokens greedily (the first
    from the prefill's logits) at positions P + S onwards. Positions are
    host ints, so the loop reads nothing back from the device until it
    ends. Raises if a sampled id is a vocab-padding id.

    On a mesh every rank passes the whole batch and the model runs its
    rows of it (``Transformer.batch_shard``): each step's ids are
    gathered over the batch's shards for the next, and ``ids`` comes back
    whole on every rank."""
    cfg, dev = model.cfg, model.device
    sh, batch = model.shard, model.batch_shard(prompts.shape[0])
    axes = () if batch is None else batch.axes

    def whole(tok):
        return sh.batch_cat(tok, axes) if axes else tok

    # positions the prefill fills: the modal prefix, then the prompt
    s = prompts.shape[1] + (0 if modal_embeds is None
                            else modal_embeds.shape[1])
    vocab = cfg.vocab
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, modal_embeds=modal_embeds,
                                  enc_embeds=enc_embeds, window=window,
                                  max_len=s + gen)
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    finite = torch.isfinite(logits[..., :vocab]).all()
    tok = whole(logits[:, -1, :].argmax(-1, keepdim=True))
    out = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.decode_step(cache, tok, s + i, window=window)
        finite &= torch.isfinite(logits[..., :vocab]).all()
        tok = whole(logits[:, -1, :].argmax(-1, keepdim=True))
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    ids = torch.cat(out, dim=1)
    if axes:
        finite = sh.batch_sum(finite.to(torch.int64), axes) == batch.size
    if int(ids.max()) >= vocab:
        raise RuntimeError("sampled a vocab-padding id")
    return ServeResult(ids, prefill_s, decode_s, bool(finite))


def build(arch: str, *, reduced: bool = False, seed: int = 0, device=None,
          dtype: torch.dtype | None = None, layers: int = 0, mesh=None,
          fsdp: bool = False, ep2d: bool = False) -> Transformer:
    """The model ``--arch`` names, weights drawn on ``device`` from a
    generator seeded with ``seed``; dtype defaults to bf16 on the card and
    f32 on the CPU. ``layers`` cuts the decoder's depth (a multiple of the
    pattern's length) and keeps every width, for a model one card cannot
    hold whole. ``mesh`` (with ``fsdp`` / ``ep2d``) shards it: every rank
    draws the same full leaves and keeps its slices."""
    cfg = get_arch(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Transformer(cfg, device=dev, dtype=dtype, generator=gen,
                       mesh=mesh, fsdp=fsdp, ep2d=ep2d)


def random_prompts(model: Transformer, batch: int, length: int,
                   seed: int = 1) -> torch.Tensor:
    """(batch, length) prompt ids uniform over the real vocab, drawn on the
    model's device."""
    gen = torch.Generator(device=model.device)
    gen.manual_seed(seed)
    return torch.randint(0, model.cfg.vocab, (batch, length), generator=gen,
                         device=model.device)


def random_embeds(model: Transformer, batch: int, length: int,
                  seed: int = 2) -> dict:
    """The modality stubs' inputs for ``batch`` prompts of ``length``
    tokens (``steps.stub_rows``: a vision model's ``modal_embeds``, an
    encoder-decoder model's ``enc_embeds``), each (batch, rows, D) of
    0.02 * N(0, 1) in f32, drawn on the model's device from a generator
    seeded with ``seed`` (the encoder's frames: ``seed + 1``)."""
    cfg, dev = model.cfg, model.device
    out = {}
    for name, rows in stub_rows(cfg, length).items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + (name == "enc_embeds"))
        out[name] = torch.randn((batch, rows, cfg.d_model), generator=gen,
                                device=dev).mul_(0.02)
    return out


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the decoder to this many layers (full width)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                    help="default: bfloat16 on cuda, float32 on cpu")
    ap.add_argument("--data-par", type=int, default=None,
                    help="shard the batch (and FSDP) over D ranks")
    ap.add_argument("--model-par", type=int, default=None,
                    help="tensor/expert-parallel over M ranks")
    args = ap.parse_args(argv)

    dtype = None if args.dtype is None else getattr(torch, args.dtype)
    mesh, layout = None, {}
    if args.data_par or args.model_par or _under_launcher():
        mesh = make_host_mesh(args.data_par or 1, args.model_par or 1,
                              device=args.device)
        cfg = get_arch(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
        if args.layers:
            cfg = dataclasses.replace(cfg, n_layers=args.layers)
        wdt = dtype or (torch.bfloat16 if mesh.device_type == "cuda"
                        else torch.float32)
        layout = inference_layout(cfg, mesh, dtype=wdt)
    model = build(args.arch, reduced=args.reduced, seed=args.seed,
                  device=args.device, dtype=dtype, layers=args.layers,
                  mesh=mesh, **layout)
    cfg = model.cfg
    prompts = random_prompts(model, args.batch, args.prompt_len)
    embeds = random_embeds(model, args.batch, args.prompt_len)
    res = serve(model, prompts, gen=args.gen, window=args.window, **embeds)
    if dist.is_initialized() and dist.get_rank() != 0:
        return res
    b, s, gen = args.batch, args.prompt_len, args.gen
    where = "" if mesh is None else \
        f" mesh=({args.data_par or 1}, {args.model_par or 1}) " + \
        " ".join(f"{k}={v}" for k, v in layout.items())
    print(f"arch={cfg.name} batch={b} prompt={s} gen={gen} "
          f"modal={modal_tokens(cfg)} device={model.device} "
          f"dtype={model.dtype}{where}")
    print(f"prefill: {res.prefill_s:.3f}s ({b * s / res.prefill_s:.0f} tok/s)")
    print(f"decode : {res.decode_s:.3f}s "
          f"({b * (gen - 1) / max(res.decode_s, 1e-9):.0f} tok/s)")
    print("sample ids:", res.ids[0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
