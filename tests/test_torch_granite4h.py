"""granite-4.0-h-small, the port's own architecture (Mamba2 mixers beside
NoPE attention, a dropless MoE in every layer, the muP multipliers),
against the benchmark's plain reference (``perfbench/reference_hybrid.py``)
on seeded random weights, on the CPU in f32 at a small size: the
``reduced()`` widths, one whole period of 10 layers (9 Mamba2, 1
attention), 4 experts top-2 and a shared expert.

Both sides run in f32, so every gap is f32 rounding: ~2e-6 of the
logits' RMS and ~3e-5 of a state's RMS over the 10 layers (a state sums
hundreds of decayed terms; the reference's SSM runs in f64), where the
port in bf16 reads ~5e-2. ``F32_TOL`` (1e-4) leaves 3x over the widest.
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, hybrid_gen, reference_hybrid  # noqa: E402
from perfbench.kinds import hybrid_prefill  # noqa: E402
from repro_torch import trace  # noqa: E402
from repro_torch.kernels import decode_attention, flash_prefill  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.arch import get_arch  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

ARCH = "granite-4.0-h-small"
CELL = "granite-4.0-h-small-prefill-32k"
F32_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _small() -> dict:
    """The cell's configuration at ``reduced()``'s widths, one period,
    served in f32."""
    bench = harness.benchmark()
    cfg = harness.config(bench, harness.cell(bench, CELL))
    a = get_arch(ARCH).reduced()
    return {**cfg, "num_hidden_layers": 10, "hidden_size": a.d_model,
            "num_attention_heads": a.n_heads,
            "num_key_value_heads": a.n_kv_heads,
            "intermediate_size": a.d_ff,
            "shared_intermediate_size": a.moe_shared_ff,
            "num_local_experts": a.moe_experts,
            "num_experts_per_tok": a.moe_top_k,
            "mamba_d_state": a.ssm_state, "mamba_d_head": a.ssm_head_dim,
            "mamba_n_heads": a.ssm_heads, "vocab_size": a.vocab,
            "precision": {"weights": "float32"}}


def _tokens(cfg, s: int, b: int = 2, seed: int = 1) -> torch.Tensor:
    return torch.randint(0, cfg["vocab_size"], (b, s),
                         generator=torch.Generator().manual_seed(seed))


def test_the_small_configuration_is_one_period_of_the_model():
    cfg = _small()
    z = hybrid_gen.sizes(cfg)
    assert z["types"] == ["mamba"] * 5 + ["attention"] + ["mamba"] * 4
    assert (z["experts"], z["top_k"], z["dh"]) == (4, 2, 64)
    prog = hybrid_prefill.Program(cfg, 3, "cpu")
    a = prog.model.cfg
    assert (a.positional, a.moe_dropless, a.tie_embeddings) == \
        ("nope", True, True)
    assert (a.attention_multiplier, a.embedding_multiplier,
            a.residual_multiplier, a.logits_scaling) == \
        (0.0078125, 12.0, 0.22, 16.0)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 977])
def test_prefill_logits_and_caches_equal_the_reference(seed):
    cfg = _small()
    tokens = _tokens(cfg, 64)
    pos = torch.tensor([0, 17, 40, 63])
    got = hybrid_prefill.Program(cfg, seed, "cpu").run(tokens, 80, pos)
    want = reference_hybrid.prefill(cfg, seed, tokens, pos)
    assert got["k"].shape == want["k"].shape == (1, 2, 4, 4, 64)
    assert got["ssm"].shape == want["ssm"].shape == (9, 2, 16, 32, 32)
    assert got["conv"].shape == want["conv"].shape == (9, 2, 3, 576)
    rel = hybrid_prefill.rel_gap
    assert float(rel(got["logits"], want["logits"], -1).max()) < F32_TOL
    for n in ("k", "v"):
        assert float(rel(got[n], want[n], (1, 2, 3, 4)).max()) < F32_TOL, n
    for n, dims in (("ssm", (1, 2, 3, 4)), ("conv", (1, 2, 3))):
        assert float(hybrid_prefill.rms_gap(got[n], want[n], dims).max()) \
            < F32_TOL, n


def test_decode_through_the_cache_equals_the_full_forward():
    """A prefill of 48 tokens and 8 decode steps fed the sequence's next
    tokens give, at positions 47..55, the reference's logits over the
    whole 56."""
    cfg = _small()
    seq = _tokens(cfg, 56, seed=4)
    prog = hybrid_prefill.Program(cfg, 9, "cpu")
    logits, cache = prog.model.prefill(seq[:, :48], max_len=56)
    got = [logits[:, -1]]
    for i in range(8):
        logits, cache = prog.model.decode_step(cache, seq[:, 48 + i:49 + i],
                                               48 + i)
        got.append(logits[:, -1])
    got = torch.stack(got, 1)[..., :cfg["vocab_size"]]
    want = reference_hybrid.prefill(cfg, 9, seq, torch.tensor([0]),
                                    logit_positions=range(47, 56))["logits"]
    assert got.shape == want.shape == (2, 9, cfg["vocab_size"])
    assert float(hybrid_prefill.rel_gap(got, want, -1).max()) < F32_TOL


def _moe(skew: float = 0.0, factor: float = 1.25):
    """A reduced MoE layer (4 of 16 padded experts, top-2, a shared
    expert) in f32, its router skewed toward expert 0: ``skew`` times a
    token's feature mean added to that expert's logit (the inputs of
    :func:`_inputs` have a feature mean near 1)."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(),
                              moe_capacity_factor=factor)
    moe = layers.MoE(cfg, device="cpu", dtype=torch.float32,
                     generator=torch.Generator().manual_seed(5))
    moe.router[:, 0] += skew / cfg.d_model
    return moe


def _inputs(moe, seed: int) -> torch.Tensor:
    return 1.0 + torch.randn(2, 48, moe.cfg.d_model,
                             generator=torch.Generator().manual_seed(seed))


def _capacity(moe, x):
    moe.dropless = False
    try:
        return moe(x)[0]
    finally:
        moe.dropless = True


def _plain_moe(moe, x):
    """Every assignment computed, one expert at a time."""
    xf = x.reshape(-1, x.shape[-1])
    gate, ids, _ = moe.route(xf)
    out = torch.zeros_like(xf)
    for e in range(moe.cfg.moe_experts):
        t, j = torch.nonzero(ids == e, as_tuple=True)
        h = torch.nn.functional.silu(xf[t] @ moe.exp_wgate[e]) \
            * (xf[t] @ moe.exp_wi[e])
        out.index_add_(0, t, (h @ moe.exp_w_down[e]) * gate[t, j, None])
    return out.view_as(x) + moe.shared(x)


def test_dropless_moe_equals_the_capacity_path_where_nothing_drops():
    moe = _moe(factor=8.0)
    x = _inputs(moe, 6)
    assert int(moe.dropped(x)) == 0
    torch.testing.assert_close(moe(x)[0], _capacity(moe, x), rtol=1e-5,
                               atol=1e-6)


def test_dropless_moe_drops_nothing_under_a_skewed_router():
    """One expert takes most tokens: the capacity path at 1.25 drops
    assignments, the dropless one computes every one (the plain loop
    over the experts' own tokens)."""
    moe = _moe(skew=4.0)
    x = _inputs(moe, 7)
    _, ids, _ = moe.route(x.reshape(96, -1))
    assert int((ids == 0).any(-1).sum()) > 0.9 * 96
    assert int(moe.dropped(x)) > 0
    got = moe(x)[0]
    torch.testing.assert_close(got, _plain_moe(moe, x), rtol=1e-5, atol=1e-6)
    assert float((got - _capacity(moe, x)).abs().max()) > 1e-2


def test_spans_and_counters_of_a_prefill():
    cfg = _small()
    prog = hybrid_prefill.Program(cfg, 3, "cpu")
    tokens = _tokens(cfg, 64)
    with trace.recording() as recs:
        prog.model.prefill(tokens, max_len=64)
    names = [r.name for r in recs]
    assert {n: names.count(n) for n in set(names)} == {
        "repro_torch.prefill": 1, "repro_torch.mamba": 9,
        "repro_torch.ssd": 9, "repro_torch.moe": 10,
        "repro_torch.experts": 10}
    root = recs[-1]
    assert root.name == "repro_torch.prefill" and root.id == root.root
    # T k rows a layer; one chunk of 64 a Mamba2 layer (S < 256)
    assert root.counts["moe_rows"] == 10 * 2 * 64 * 2
    assert root.counts["ssd_chunks"] == 9
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.name == "repro_torch.ssd":
            assert by_id[r.parent].name == "repro_torch.mamba"
        if r.name == "repro_torch.experts":
            assert by_id[r.parent].name == "repro_torch.moe"


def test_spans_are_off_outside_a_recording():
    cfg = _small()
    prog = hybrid_prefill.Program(cfg, 3, "cpu")
    before = len(trace.records())
    prog.model.prefill(_tokens(cfg, 16), max_len=16)
    assert len(trace.records()) == before


@pytest.mark.parametrize("fault", sorted(hybrid_prefill.FAULTS))
def test_each_planted_fault_moves_what_the_check_compares(fault,
                                                           monkeypatch):
    """Each fault of the kind, planted in the f32 port, moves a number of
    the check far past f32 rounding (``capacity`` under routing that
    drops at this size: 256 assignments over 4 of 16 padded experts)."""
    cfg = _small()
    tokens = _tokens(cfg, 64)
    pos = torch.tensor([0, 40, 63])
    want = reference_hybrid.prefill(cfg, 2, tokens, pos)
    for mod, attr, fn in hybrid_prefill.FAULTS[fault]():
        monkeypatch.setattr(mod, attr, fn)
    got = hybrid_prefill.Program(cfg, 2, "cpu").run(tokens, 64, pos)
    gaps = [float(hybrid_prefill.rel_gap(got["logits"], want["logits"],
                                         -1).max())]
    gaps += [float(hybrid_prefill.rel_gap(got[n], want[n],
                                          (1, 2, 3, 4)).max())
             for n in ("k", "v")]
    gaps += [float(hybrid_prefill.rms_gap(got[n], want[n], dims).max())
             for n, dims in (("ssm", (1, 2, 3, 4)), ("conv", (1, 2, 3)))]
    assert max(gaps) > 100 * F32_TOL, gaps


@pytest.mark.parametrize("window", [0, 5])
def test_the_attention_scale_is_a_parameter(window):
    """``scale=`` multiplies q.k; None is 1/sqrt(Dh) bit for bit, and q
    scaled by s sqrt(Dh) gives what ``scale=s`` gives (prefill, its
    gradient, decode)."""
    g = torch.Generator().manual_seed(2)
    q = torch.randn(2, 12, 4, 64, generator=g)
    k, v = (torch.randn(2, 12, 2, 64, generator=g) for _ in range(2))
    s, root = 0.0078125, math.sqrt(64)
    base = flash_prefill(q, k, v, window=window)
    assert torch.equal(flash_prefill(q, k, v, window=window, scale=None),
                       base)
    torch.testing.assert_close(flash_prefill(q, k, v, window=window,
                                             scale=s),
                               flash_prefill(q * (s * root), k, v,
                                             window=window))
    qa = q.clone().requires_grad_()
    qb = (q * (s * root)).requires_grad_()
    flash_prefill(qa, k, v, window=window, scale=s).square().sum().backward()
    flash_prefill(qb, k, v, window=window).square().sum().backward()
    torch.testing.assert_close(qa.grad, qb.grad * (s * root))
    kc, vc = k.transpose(1, 2), v.transpose(1, 2)
    torch.testing.assert_close(
        decode_attention(q[:, 0], kc, vc, 9, scale=s),
        decode_attention(q[:, 0] * (s * root), kc, vc, 9))


def test_the_dry_run_names_the_architecture_as_not_planned(capsys):
    from repro_torch.launch import dryrun

    assert dryrun.main(["--arch", ARCH, "--hbm-bytes", "85899345920"]) == 0
    out = capsys.readouterr().out
    assert f"NOT PLANNED {ARCH}" in out and "dropless" in out


def test_the_reference_ssd_is_the_recurrence():
    """``reference_hybrid.ssd_minimal_discrete`` (Listing 1, chunked)
    equals the SSM's step-by-step recurrence h_t = exp(a_t) h_{t-1} +
    x_t b_t^T, y_t = h_t c_t in f64, at chunks of 16 and 64."""
    g = torch.Generator().manual_seed(3)
    length, h, p, n = 128, 3, 4, 5
    x = torch.randn(length, h, p, generator=g, dtype=torch.float64)
    a = -torch.rand(length, h, generator=g, dtype=torch.float64)
    b, c = (torch.randn(length, n, generator=g, dtype=torch.float64)
            for _ in range(2))
    state = torch.zeros(h, p, n, dtype=torch.float64)
    want = []
    for t in range(length):
        state = state * torch.exp(a[t])[:, None, None] \
            + x[t][..., None] * b[t]
        want.append(state @ c[t])
    for chunk in (16, 64):
        y, final = reference_hybrid.ssd_minimal_discrete(x, a, b, c, chunk)
        torch.testing.assert_close(y, torch.stack(want), rtol=1e-10,
                                   atol=1e-12)
        torch.testing.assert_close(final, state, rtol=1e-10, atol=1e-12)


def test_the_reference_loads_nothing_of_the_program_or_jax():
    import json
    import subprocess

    code = ("import perfbench.reference_hybrid, perfbench.hybrid_gen, "
            "perfbench.roofline_hybrid, sys, json\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}",
                              "PATH": "/usr/bin:/bin"})
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
