"""Traffic kind ``hybrid_prefill``: batched prompts prefilled back to back
through a Granite 4.0-H (``granitemoehybrid``) stack: Mamba2 mixers beside
NoPE attention, a dropless MoE in every layer.

The configuration keeps the source's keys (``hybrid_gen.sizes``) and names
the port's architecture (``arch``); set-up builds the port's
``Transformer`` at those sizes, its weights left for a loader, loads the
benchmark's own weights (``hybrid_gen``, drawn from the seed on the card)
into it, draws the traffic's prompt batches and prefills each once: those
are the warm calls and the set-up answers. A call is
``Transformer.prefill(prompts, max_len=prompt_len + decode_room)``, the
call ``launch.serve.serve`` makes; the batches cycle.

What a call produces and the check reads: the last position's logits of
each row, the attention layers' keys and values at every
``check_every``-th position and the last, and at the first
``check_start``, and each Mamba2 layer's final SSM state and conv tail,
all from the cache the call returns. Each call's
answer is compared with the set-up's on its batch as it comes (a flag
left on the device); only the newest answer on the seed's batch is kept.
The check holds the rows of it that ``lm_gen.check_rows`` draws from the
seed (one from each part of the batch) to the plain reference
(``reference_hybrid``): a prompt's answer depends on its own row alone.

``FAULTS`` are this kind's planted faults (``perfbench/faults.py``):

* ``capacity`` — every MoE layer on the capacity path at its factor
  (1.25 over the padded experts), which drops assignments;
* ``rope`` — RoPE applied in the first attention layer, a NoPE layer;
* ``residual`` — the middle layer's residual multiplier left out;
* ``scale`` — every attention layer's softmax scale 1/sqrt(Dh), not the
  configuration's ``attention_multiplier``;
* ``stale_state`` — the middle Mamba2 layer's final state left zero.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from .. import hybrid_gen, lm_gen, reference_hybrid, roofline_hybrid
from .prefill import rel_gap

ANSWER = ("logits", "k", "v", "ssm", "conv")


def rms_gap(got: torch.Tensor, want: torch.Tensor, dims) -> torch.Tensor:
    """rms(got - want) / rms(want) over ``dims``."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return ((got - want).square().mean(dims) / want.square().mean(dims)
            ).sqrt()


def _load(dst: torch.Tensor, t: torch.Tensor) -> None:
    """``t`` into the leading block of ``dst``, the rest zero (padding
    experts, the router's padding columns, the vocabulary's padding
    rows)."""
    dst.zero_()[tuple(slice(0, n) for n in t.shape)].copy_(t)


class Program:
    """The system under test: the port's ``Transformer.prefill``."""

    def __init__(self, cfg: dict, seed: int, device):
        from repro_torch.models.arch import get_arch
        from repro_torch.models.transformer import Transformer

        z = hybrid_gen.sizes(cfg)
        arch = dataclasses.replace(get_arch(cfg["arch"]),
                                   **hybrid_gen.arch_fields(cfg))
        kinds = [{"attn": "attention"}.get(s.mixer, s.mixer)
                 for s in arch.pattern] * arch.n_rep
        if kinds != z["types"] or arch.ssm_heads != z["nh"]:
            raise ValueError(f"{cfg['arch']}'s layers {kinds} and "
                             f"{arch.ssm_heads} SSM heads are not the "
                             f"configuration's {z['types']} and {z['nh']}")
        dtype = getattr(torch, cfg["precision"]["weights"])
        self.vocab = z["vocab"]
        self.model = Transformer(arch, device=device, dtype=dtype)
        p = dict(self.model.named_parameters())
        _load(p["embed"], hybrid_gen.embedding(cfg, seed, device, dtype))
        for i in range(z["layers"]):
            for name, t in hybrid_gen.layer(cfg, seed, i, device,
                                            dtype).items():
                _load(p[f"layers.{i}.{hybrid_gen.LEAVES[name]}"], t)
        _load(p["final_norm.scale"],
              hybrid_gen.final_norm(cfg, seed, device, dtype))

    def run(self, tokens, max_len: int, positions) -> dict:
        logits, cache = self.model.prefill(tokens, max_len=max_len)
        attn = [c for c in cache if "k" in c]
        ssm = [c for c in cache if "ssm" in c]
        return {"logits": logits[:, -1, :self.vocab],
                "k": torch.stack([c["k"][:, positions] for c in attn]),
                "v": torch.stack([c["v"][:, positions] for c in attn]),
                "ssm": torch.stack([c["ssm"] for c in ssm]),
                "conv": torch.stack([c["conv"] for c in ssm])}

    def release(self) -> None:
        del self.model


class Control:
    """The reference in the program's place, one precision below the
    configuration's bf16: every matmul's operands in float8_e4m3fn."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed = cfg, seed

    def run(self, tokens, max_len: int, positions) -> dict:
        return reference_hybrid.prefill(self.cfg, self.seed, tokens,
                                        positions, reference_hybrid.FP8)

    def release(self) -> None:
        pass


SYSTEMS = {"program": Program, "control": Control}


class Workload:
    unit = "token"
    #: traced: whole calls timed, staged calls (none here), profiled calls
    #: (one: a call launches ~17,000 kernels, and the profiler's events of
    #: one take ~29 s to gather on an H100 machine's host)
    trace_reps = (3, 1, 1)

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 system: str = "program"):
        self.cfg, self.traffic = config, traffic
        self.seed, self.device, self.system = int(seed), device, system
        self.b, self.s = int(traffic["batch"]), int(traffic["prompt_len"])
        self.max_len = self.s + int(traffic["decode_room"])
        every, first = int(traffic["check_every"]), int(traffic["check_start"])
        late = set(range(0, self.s, every)) | {self.s - 1}
        pos = sorted(late | set(range(min(first, self.s))))
        self.positions = torch.tensor(pos, device=device)
        #: indices into ``positions`` of the late ones and of the first
        self.late = [i for i, p in enumerate(pos) if p in late]
        self.start = [i for i, p in enumerate(pos) if p < first]
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
        self.prompts = hybrid_gen.prompts(self.cfg, self.traffic, self.seed,
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
        """No staged chain: the per-layer metrics read the program's spans
        and the device trace of whole calls."""
        return None

    def counts(self) -> dict:
        """(operations, bytes) of one prefill by ``roofline_hybrid``: the
        GEMMs', the causal attention's, the SSD's, the routed experts' and
        the whole's."""
        return roofline_hybrid.prefill_counts(
            hybrid_gen.sizes(self.cfg), self.b, self.s)

    def check(self, answers, staged) -> tuple[dict, list]:
        """(the numbers compared, and for each answer its own numbers), of
        the newest answer on the seed's batch, at the checked row:
        ``logit_gap`` (the widest |logit - reference| at the last position
        over the reference's RMS there); ``kv_gap`` (the largest RMS of k
        - reference or of v - reference at every ``check_every``-th
        position and the last, over the reference's RMS of that layer's
        keys or values there); ``kv_start_gap`` (the same at the first
        ``check_start`` positions, where a query sees few keys: far into a
        long prompt, attention with random weights averages thousands of
        near-equal scores, so what it computes there, its scale included,
        barely moves the cache); ``state_gap`` (the same of each Mamba2
        layer's final state and conv tail). The cache's gaps are RMS over
        RMS because their widest entries are a few routing decisions of
        the top-10 that bf16 and f32 break differently, and a state's
        entries are heavy-tailed;
        ``answers_differ``: answers unlike the set-up's on their batch,
        every row, bit for bit. Beside them, not compared: each layer's
        gaps (``*_by_layer``), for calibration."""
        per = [{"answers_differ": float(flag)} for _, flag in answers]
        rows = torch.tensor(self.rows, device=self.device)
        got = {"logits": self.last["logits"][rows],
               **{n: self.last[n][:, rows] for n in ANSWER[1:]}}
        self.sys.release()
        self.first, self.last = [], None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        want = reference_hybrid.prefill(self.cfg, self.seed,
                                        self.prompts[self.ref][rows],
                                        self.positions)

        def by_layer(gap, names, at=slice(None)):
            return torch.stack([gap(got[n][:, :, at], want[n][:, :, at],
                                    tuple(range(1, got[n].dim())))
                                for n in names]).amax(0).tolist()

        kv = by_layer(rms_gap, ("k", "v"), self.late)
        start = by_layer(rms_gap, ("k", "v"), self.start)
        state = by_layer(rms_gap, ("ssm", "conv"))
        numbers = {"logit_gap": float(rel_gap(got["logits"], want["logits"],
                                              -1).max()),
                   "kv_gap": max(kv), "kv_start_gap": max(start),
                   "state_gap": max(state),
                   "answers_differ": sum(a["answers_differ"] for a in per),
                   "kv_gap_by_layer": kv, "kv_start_gap_by_layer": start,
                   "state_gap_by_layer": state}
        return numbers, per


def _during_prefill(change):
    """``Transformer.prefill`` with ``change(model)`` in force for the
    call: ``change`` alters the model and returns a function that undoes
    it."""
    from repro_torch.models.transformer import Transformer

    prefill = Transformer.prefill

    def faulty(self, tokens, **kw):
        undo = change(self)
        try:
            return prefill(self, tokens, **kw)
        finally:
            undo()

    return [(Transformer, "prefill", faulty)]


def _setting(mods, attr: str, value):
    """A ``change`` that sets ``attr`` of every module ``mods(model)``
    gives to ``value``."""
    def change(model):
        saved = [(m, getattr(m, attr)) for m in mods(model)]
        for m, _ in saved:
            setattr(m, attr, value)
        return lambda: [setattr(m, attr, v) for m, v in saved]
    return change


def _blocks(model, mixer: str):
    return [b for b in model.layers if b.spec.mixer == mixer]


def _capacity():
    return _during_prefill(_setting(
        lambda m: [b.ff for b in m.layers if b.spec.ff == "moe"],
        "dropless", False))


def _rope():
    return _during_prefill(_setting(
        lambda m: [_blocks(m, "attn")[0].mixer], "rope", True))


def _residual():
    return _during_prefill(_setting(
        lambda m: [m.layers[len(m.layers) // 2]], "residual", 1.0))


def _scale():
    # a scale of None is the kernels' default, 1/sqrt(Dh)
    return _during_prefill(_setting(
        lambda m: [b.mixer for b in _blocks(m, "attn")], "scale", None))


def _stale_state():
    from repro_torch.models.transformer import Transformer

    prefill = Transformer.prefill

    def unwritten(self, tokens, **kw):
        out, cache = prefill(self, tokens, **kw)
        ssm = [c for c in cache if "ssm" in c]
        ssm[len(ssm) // 2]["ssm"].zero_()
        return out, cache

    return [(Transformer, "prefill", unwritten)]


FAULTS = {"capacity": _capacity, "rope": _rope, "residual": _residual,
          "scale": _scale, "stale_state": _stale_state}
