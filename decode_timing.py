"""Host and device time of granite-8b's decode path on one CUDA card, for
one or more copies of the port's package, run in turns.

  python3 decode_timing.py --src build/ab/parent/src --src src --turns 2

Each turn runs every ``--src`` in order (every other turn in reverse, so
two sources run A, B, B, A), each in a fresh process that imports
``repro_torch`` from that directory. The process builds granite-8b at
full width in bf16 (weights from seed 0) and measures, at the serving
shape (batch 8, 2048-token prompts, 32 tokens):

- ``wrapper_us``: the ``decode_attention`` wrapper's host time per call
  (B = 8, 32/8 heads of 128, 2064 valid of 2080 entries), 20 batches of
  100 calls, each batch timed on the host clock up to its last call's
  return and then synchronised;
- ``device_ms``: that call's device time (``torch.profiler``, 100 calls);
- ``decode_s``, ``decode_tok_s``: three ``serve`` runs, as
  ``chip_smoke.py`` phase 7 runs one;
- ``step_ms``: the wall time of each of 31 decode steps after a prefill,
  synchronised after each step;
- ``loop``: 31 unsynchronised steps after a prefill, as ``serve`` runs
  them, with the host's time to issue them (``issue_ms`` a step), the
  wall time to their end (``wall_ms`` a step) and the host time spent in
  the model's ``decode_attention`` calls (``attn_us`` a call); for a
  package whose wrapper takes ``splits=``, again with one split forced
  (``loop_splits1``), the first version's grid.

Prints the card's name and power limit, then one JSON line a process.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

BATCH, PROMPT, GEN = 8, 2048, 32


def _spread(xs: list) -> dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def measure(src: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import decode_attention
    from repro_torch.launch.serve import build, random_prompts, serve

    def sync():
        torch.cuda.synchronize()

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q = rnd(BATCH, 32, 128)
    k, v = (rnd(BATCH, PROMPT + GEN, 8, 128).transpose(1, 2)
            for _ in range(2))
    pos = PROMPT + GEN - 16

    def call():
        return decode_attention(q, k, v, pos)

    for _ in range(10):
        call()
    sync()
    wrapper_us = []
    for _ in range(20):
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        wrapper_us.append((time.perf_counter() - t0) / 100 * 1e6)
        sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            call()
        sync()
    device_us = sum(getattr(e, "self_device_time_total", 0) or 0
                    for e in prof.key_averages()
                    if "CUDA" in str(getattr(e, "device_type", "")))
    del q, k, v

    model = build("granite-8b", seed=0, device="cuda", dtype=torch.bfloat16)
    prompts = random_prompts(model, BATCH, PROMPT)
    serve(model, prompts[:, :64], gen=2)   # warm-up: cuBLAS, first launches
    decode_s = [serve(model, prompts, gen=GEN).decode_s for _ in range(3)]

    logits, cache = model.prefill(prompts, max_len=PROMPT + GEN)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    sync()
    step_ms = []
    for i in range(GEN - 1):
        t0 = time.perf_counter()
        logits, cache = model.decode_step(cache, tok, PROMPT + i)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    out = {"src": src, "wrapper_us": _spread(wrapper_us),
           "device_ms": device_us / 100 / 1e3,
           "decode_s": decode_s,
           "decode_tok_s": [BATCH * (GEN - 1) / s for s in decode_s],
           "step_ms": _spread(step_ms),
           "loop": _loop(model, prompts, None)}
    if "splits" in inspect.signature(decode_attention).parameters:
        out["loop_splits1"] = _loop(model, prompts, 1)
    return out


def _loop(model, prompts, splits) -> dict:
    """31 unsynchronised decode steps after a prefill, the host time of
    the model's decode_attention calls counted on the side."""
    import torch
    from repro_torch.models import layers

    inner, spent, calls = layers.decode_attention, [0.0], [0]

    def counted(*args, **kwargs):
        if splits is not None:
            kwargs["splits"] = splits
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        spent[0] += time.perf_counter() - t0
        calls[0] += 1
        return out

    layers.decode_attention = counted
    try:
        logits, cache = model.prefill(prompts, max_len=PROMPT + GEN)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        spent[0], calls[0] = 0.0, 0
        t0 = time.perf_counter()
        for i in range(GEN - 1):
            logits, cache = model.decode_step(cache, tok, PROMPT + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        issue = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        layers.decode_attention = inner
    return {"issue_ms": issue / (GEN - 1) * 1e3,
            "wall_ms": wall / (GEN - 1) * 1e3,
            "attn_us": spent[0] / calls[0] * 1e6, "attn_calls": calls[0]}


def run_in_turns(measure, script: str, doc: str) -> int:
    """The command line of a timing script: with ``--child``, print
    measure(src) as JSON; else print the card's name and power limit and
    run ``script --child`` once per ``--src`` a turn, in a fresh process
    that imports ``repro_torch`` from that directory (every other turn in
    reverse order)."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a directory that holds repro_torch (repeatable)")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(measure(args.src[0])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print(f"{os.path.basename(script)}: CUDA is not available",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    for turn in range(args.turns):
        for src in args.src if turn % 2 == 0 else args.src[::-1]:
            env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
            subprocess.run([sys.executable, os.path.abspath(script),
                            "--child", "--src", src], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(run_in_turns(measure, __file__, __doc__))
