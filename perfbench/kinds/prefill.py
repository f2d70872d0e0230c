"""Traffic kind ``prefill``: batched prompts prefilled back to back.

The configuration's ``arch`` names the port's architecture; its sizes
and precision are the file's. Set-up builds the port's ``Transformer``
at those sizes with its weights left for a loader, loads the benchmark's
own weights (``lm_gen``, drawn from the seed on the card) into it, draws
the traffic's prompt batches and prefills each once: those are the warm
calls and the set-up answers. A call is ``Transformer.prefill(prompts,
max_len=prompt_len + decode_room)``, the call ``launch.serve.serve``
makes, so every attention layer runs ``flash_prefill``; the batches
cycle. Lengths are fixed: ``prefill`` takes one (B, S) batch with no
per-row lengths, so a spread of lengths would measure padding.

What a call produces and the check reads: the last position's logits of
each row, and from the cache it returns every layer's post-RoPE keys and
values at every ``check_every``-th position and the last. Each call's
answer is compared with the set-up's on its batch as it comes (a flag
left on the device); only the newest answer on the seed's batch is kept,
so what the window holds does not grow with its calls. The check holds
the rows of it that ``lm_gen.check_rows`` draws from the seed, one from
each part of the batch, to the plain reference (``reference_lm``): a
prompt's answer depends on its own row alone.

``FAULTS`` are this kind's planted faults (``perfbench/faults.py``):

* ``halve`` — a prefill of the first half of the prompts, its answers
  given to the other half too.
* ``alter`` — the first logit of every row's last position raised by 1.
* ``stale`` — a step that returns its state unchanged: the middle
  layer's cache left as it was made, zero.
* ``drop_attn`` — the middle layer's attention output dropped.
* ``skip_rope`` — RoPE skipped on q and k in the middle layer.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import lm_gen, reference_lm, roofline

#: the configuration's keys that size the port's ``ArchConfig``
SIZES = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
         "vocab", "rope_theta", "norm_eps")
#: ``lm_gen``'s leaf of a layer -> the port's parameter under ``layers.<i>``
LEAVES = {"attn_norm": "mixer_norm.scale", "wq": "mixer.wq",
          "wk": "mixer.wk", "wv": "mixer.wv", "wo": "mixer.wo",
          "mlp_norm": "ff_norm.scale", "w_gate": "ff.wgate",
          "w_up": "ff.wi", "w_down": "ff.w_down"}
ANSWER = ("logits", "k", "v")


class Program:
    """The system under test: the port's ``Transformer.prefill``."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.models.arch import get_arch
        from repro_torch.models.transformer import Transformer

        arch = dataclasses.replace(get_arch(cfg["arch"]),
                                   **{k: cfg[k] for k in SIZES})
        dtype = getattr(torch, cfg["precision"]["weights"])
        self.vocab = cfg["vocab"]
        self.model = Transformer(arch, device=device, dtype=dtype)
        p = dict(self.model.named_parameters())
        p["embed"].zero_()[:self.vocab].copy_(
            lm_gen.embedding(cfg, seed, device, dtype))
        for i in range(cfg["n_layers"]):
            for name, t in lm_gen.layer(cfg, seed, i, device, dtype).items():
                p[f"layers.{i}.{LEAVES[name]}"].copy_(t)
        hd = lm_gen.head(cfg, seed, device, dtype)
        p["final_norm.scale"].copy_(hd["final_norm"])
        p["unembed"].zero_()[:, :self.vocab].copy_(hd["unembed"])

    def run(self, tokens, max_len: int, positions) -> dict:
        logits, cache = self.model.prefill(tokens, max_len=max_len)
        return {"logits": logits[:, -1, :self.vocab],
                "k": torch.stack([c["k"][:, positions] for c in cache]),
                "v": torch.stack([c["v"][:, positions] for c in cache])}

    def release(self) -> None:
        del self.model


class Control:
    """The reference in the program's place, one precision below the
    configuration's bf16: every matmul's operands in float8_e4m3fn."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed = cfg, seed

    def run(self, tokens, max_len: int, positions) -> dict:
        return reference_lm.prefill(self.cfg, self.seed, tokens, positions,
                                    reference_lm.FP8)

    def release(self) -> None:
        pass


SYSTEMS = {"program": Program, "control": Control}


def rel_gap(got: torch.Tensor, want: torch.Tensor, dims) -> torch.Tensor:
    """max |got - want| / rms(want) over ``dims``."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return (got - want).abs().amax(dims) / want.square().mean(dims).sqrt()


class Workload:
    unit = "token"
    #: traced: whole calls timed, staged calls (none here), profiled calls
    trace_reps = (3, 1, 3)

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 system: str = "program"):
        self.cfg, self.traffic = config, traffic
        self.seed, self.device, self.system = int(seed), device, system
        self.b, self.s = int(traffic["batch"]), int(traffic["prompt_len"])
        self.max_len = self.s + int(traffic["decode_room"])
        every = int(traffic["check_every"])
        pos = sorted(set(range(0, self.s, every)) | {self.s - 1})
        self.positions = torch.tensor(pos, device=device)
        self.ref = self.seed % int(traffic["prompts"])
        self.rows = lm_gen.check_rows(traffic, self.seed)
        self.sys, self.last = None, None
        self.prompts, self.first = [], []
        self.setup_phases = {}

    def setup(self) -> None:
        """Draw the prompts, build and load the system, and prefill each
        batch once; ``setup_phases`` keeps each step's seconds."""
        def lap(name):
            nonlocal t
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize(self.device)
            now = time.perf_counter()
            self.setup_phases[name] = now - t
            t = now

        t = time.perf_counter()
        self.prompts = lm_gen.prompts(self.cfg, self.traffic, self.seed,
                                      self.device)
        lap("prompts")
        self.sys = SYSTEMS[self.system](self.cfg, self.seed, self.device)
        lap("build_and_load")
        for k, p in enumerate(self.prompts):
            self.first.append(self._run(p))
            lap(f"call_{k}")
        self.last = self.first[self.ref]

    def _run(self, tokens) -> dict:
        return self.sys.run(tokens, self.max_len, self.positions)

    def call(self, i: int):
        """(batch, a 0-d device flag: the answer differs from the set-up's
        on this batch)."""
        k = i % len(self.prompts)
        out = self._run(self.prompts[k])
        if k == self.ref:
            self.last = out
        differs = torch.stack([(out[n] != self.first[k][n]).any()
                               for n in ANSWER]).any()
        return k, differs

    def units(self, answer) -> int:
        return self.b * self.s

    def staged(self, spans) -> None:
        """No staged chain: the per-layer metrics read the device trace
        of whole calls."""
        return None

    def counts(self) -> dict:
        """(operations, bytes) of one prefill: the causal attention's, the
        GEMMs' (every layer's projections and MLP over every token, the
        LM head over each row's last position) and the whole's."""
        c, b, s = self.cfg, self.b, self.s
        hq, hkv, dh = c["n_heads"], c["n_kv_heads"], c["head_dim"]
        layers = c["n_layers"]
        attn = (layers * roofline.causal_attention_ops(b, s, hq, dh),
                layers * roofline.attention_bytes(b, s, hq, hkv, dh))
        gemms = roofline.dense_prefill_gemms(b, s, c["d_model"], hq, hkv, dh,
                                             c["d_ff"], c["vocab"], layers)
        gemm = (sum(n * roofline.gemm_ops(*mkn) for mkn, n in gemms),
                sum(n * roofline.gemm_bytes(*mkn) for mkn, n in gemms))
        return {"attention": attn, "gemm": gemm,
                "whole": (attn[0] + gemm[0], 0)}

    def check(self, answers, staged) -> tuple[dict, list]:
        """(the numbers compared, and for each answer its own numbers):
        ``logit_gap`` (the widest |logit - reference| over the checked
        rows' last positions, over the reference's RMS at that row) and
        ``kv_gap`` (the widest |k - reference| or |v - reference| of the
        checked rows at the checked positions, over the reference's RMS
        of that layer's keys or values) of the newest answer on the
        seed's batch; ``answers_differ``: answers unlike the set-up's on
        their batch, every row."""
        per = [{"answers_differ": float(flag)} for _, flag in answers]
        rows = torch.tensor(self.rows, device=self.device)
        got = {"logits": self.last["logits"][rows],
               "k": self.last["k"][:, rows], "v": self.last["v"][:, rows]}
        self.sys.release()
        self.first, self.last = [], None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        want = reference_lm.prefill(self.cfg, self.seed,
                                    self.prompts[self.ref][rows],
                                    self.positions)
        kv = max(float(rel_gap(got[n], want[n], (1, 2, 3, 4)).max())
                 for n in ("k", "v"))
        numbers = {"logit_gap": float(rel_gap(got["logits"], want["logits"],
                                              -1).max()),
                   "kv_gap": kv,
                   "answers_differ": sum(a["answers_differ"] for a in per)}
        return numbers, per


def _middle_mixer(wrap):
    """``Transformer.prefill`` with its middle layer's mixer's forward
    wrapped by ``wrap`` for the call."""
    from repro_torch.models.transformer import Transformer

    prefill = Transformer.prefill

    def faulty(self, tokens, **kw):
        mixer = self.layers[len(self.layers) // 2].mixer
        mixer.forward = wrap(mixer.forward)
        try:
            return prefill(self, tokens, **kw)
        finally:
            del mixer.forward

    return [(Transformer, "prefill", faulty)]


def _halve():
    from repro_torch.models.transformer import Transformer

    prefill = Transformer.prefill

    def half_prefill(self, tokens, **kw):
        out, cache = prefill(self, tokens[:tokens.shape[0] // 2], **kw)
        return torch.cat([out, out]), [
            {k: torch.cat([t, t]) for k, t in c.items()} for c in cache]

    return [(Transformer, "prefill", half_prefill)]


def _alter():
    from repro_torch.models.transformer import Transformer

    logits = Transformer.logits

    def raised(self, hidden):
        out = logits(self, hidden).clone()
        out[..., 0] += 1.0
        return out

    return [(Transformer, "logits", raised)]


def _stale():
    from repro_torch.models.transformer import Transformer

    prefill = Transformer.prefill

    def unwritten(self, tokens, **kw):
        out, cache = prefill(self, tokens, **kw)
        for t in cache[len(cache) // 2].values():
            t.zero_()
        return out, cache

    return [(Transformer, "prefill", unwritten)]


def _drop_attn():
    def dropped(fwd):
        def run(*a, **kw):
            out, kv = fwd(*a, **kw)
            return torch.zeros_like(out), kv
        return run

    return _middle_mixer(dropped)


def _skip_rope():
    from repro_torch.models import layers

    def unrotated(fwd):
        def run(*a, **kw):
            rope = layers.rope
            layers.rope = lambda x, positions, theta: x
            try:
                return fwd(*a, **kw)
            finally:
                layers.rope = rope
        return run

    return _middle_mixer(unrotated)


FAULTS = {"halve": _halve, "alter": _alter, "stale": _stale,
          "drop_attn": _drop_attn, "skip_rope": _skip_rope}
