"""The LM cell's yardstick on the CPU: the plain reference
(``reference_lm``) against the port's ``Transformer.prefill`` in f32, the
control's rounding, the prefill counts, and the LM readers on a
hand-built profile. CPU only:

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, lm_gen, lm_ops, reference_lm, roofline  # noqa: E402
from perfbench.kinds import prefill  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "granite-8b-prefill"
H100 = "NVIDIA H100 80GB HBM3"
#: both sides in f32 at the reduced size: the gap is f32 rounding alone,
#: ~5e-6 of the reference's RMS over two layers (bf16 reads ~5e-2)
F32_TOL = 1e-4


def _config(**over) -> dict:
    return {**harness.config(BENCH, harness.cell(BENCH, CELL)), **over}


def _reduced(dtype: str = "float32") -> dict:
    """granite-8b's ``reduced()`` sizes, served in ``dtype``."""
    from repro_torch.models.arch import get_arch

    a = get_arch("granite-8b").reduced()
    sizes = {k: getattr(a, k) for k in prefill.SIZES}
    return _config(**sizes, precision={"weights": dtype})


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 977])
def test_reference_matches_the_port_in_f32(seed):
    cfg = _reduced()
    g = torch.Generator().manual_seed(seed % 1000)
    tokens = torch.randint(0, cfg["vocab"], (2, 64), generator=g)
    pos = torch.tensor([0, 17, 63])
    got = prefill.Program(cfg, seed, "cpu").run(tokens, 80, pos)
    want = reference_lm.prefill(cfg, seed, tokens, pos)
    assert got["k"].shape == want["k"].shape == (cfg["n_layers"], 2, 3,
                                                 cfg["n_kv_heads"],
                                                 cfg["head_dim"])
    assert float(prefill.rel_gap(got["logits"], want["logits"], -1).max()) \
        < F32_TOL
    for n in ("k", "v"):
        assert float(prefill.rel_gap(got[n], want[n], (1, 2, 3, 4)).max()) \
            < F32_TOL, n


def test_reference_reads_the_weights_of_its_seed():
    """Another seed's weights, or a layer's norm scale left at one, move
    the reference by far more than the tolerance."""
    cfg = _reduced()
    tokens = torch.randint(0, cfg["vocab"], (1, 32),
                           generator=torch.Generator().manual_seed(1))
    pos = torch.tensor([0, 31])
    a = reference_lm.prefill(cfg, 5, tokens, pos)
    b = reference_lm.prefill(cfg, 6, tokens, pos)
    assert float(prefill.rel_gap(a["logits"], b["logits"], -1).max()) > 0.5
    w = lm_gen.layer(cfg, 5, 0, "cpu", torch.float32)
    assert float((w["attn_norm"] - 1).abs().max()) > 0.1
    assert lm_gen.layer(cfg, 5, 0, "cpu", torch.float32)["wq"].equal(w["wq"])


def test_check_rows_take_one_row_of_each_part_of_the_batch():
    tr = harness.traffic("prefill-40x3968")
    seen = set()
    for seed in (1, 2, 3, 2 ** 31 + 977, 2 ** 33 + 5):
        rows = lm_gen.check_rows(tr, seed)
        assert rows == lm_gen.check_rows(tr, seed)
        assert [r // 10 for r in rows] == [0, 1, 2, 3]
        seen.add(tuple(rows))
    assert len(seen) > 1
    assert lm_gen.check_rows({**tr, "batch": 2}, 7) == [0, 1]


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([1.0, 1.0625, 1.125, -448.0, 0.1])
    r = reference_lm.fp8_round(t)
    # scale 1: 1.0625 lies halfway between 1 and 1.125 (ties to even)
    assert r[:4].tolist() == [1.0, 1.0, 1.125, -448.0]
    assert float(r[4]) == 0.1015625


def test_kernel_names_fall_in_their_layers():
    assert lm_ops.layer("void flash_prefill_wgmma<128, true>(bf16 const*, "
                        "bf16 const*)") == "attention"
    for name in ("nvjet_tst_256x128_64x4_2x1_v_bz_coopB_TNT",
                 "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x256",
                 "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm>",
                 "void splitKreduce_kernel<32, 16, int, float>"):
        assert lm_ops.layer(name) == "matmul", name
    for name in ("void at::native::vectorized_elementwise_kernel<4>",
                 "Memcpy DtoD (Device -> Device)", "Memset (Device)",
                 "void at::native::reduce_kernel<512, 1>"):
        assert lm_ops.layer(name) == "elementwise", name


def _traced_ctx(device="cuda", unit="token"):
    wl = prefill.Workload(_config(), harness.traffic("prefill-40x3968"), 1,
                          "cpu")
    ctx = harness.Context(unit=unit, device=device, device_name=H100)
    ctx.counts = wl.counts()
    ctx.whole_s = [0.60, 0.55, 0.58]
    ctx.profile = {
        "busy_s": 1.6, "window_s": 1.75, "calls": 3, "device_ops": [],
        "idle_gaps": [],
        "ops": {"void flash_prefill_wgmma<128, true>(...)": 0.09,
                "nvjet_tst_256x128_64x4_2x1_v_bz_coopB_TNT": 1.2,
                "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn": 0.15,
                "void at::native::vectorized_elementwise_kernel<4>": 0.12,
                "Memset (Device)": 0.03}}
    return ctx


def _read(name, ctx):
    return harness.reader(name)(ctx)


def test_lm_readers_on_a_hand_built_profile():
    ctx = _traced_ctx()
    c = ctx.counts
    peak = roofline.BF16_PEAKS[H100][0]
    assert _read("attn_roofline.prefill", ctx) == pytest.approx(
        100 * 3 * c["attention"][0] / peak / 0.09)
    assert _read("gemm_roofline.prefill", ctx) == pytest.approx(
        100 * 3 * c["gemm"][0] / peak / 1.35)
    assert _read("other_ms.prefill", ctx) == pytest.approx(1e3 * 0.15 / 3)
    assert _read("idle_share.prefill", ctx) == pytest.approx(
        100 * (1 - 1.6 / 1.75))
    assert _read("mfu.prefill", ctx) == pytest.approx(
        100 * c["whole"][0] / peak / 0.58)
    ctx.window_s, ctx.units = 51.0, 90 * 8 * 2048
    assert _read("tokens_per_s", ctx) == pytest.approx(90 * 8 * 2048 / 51)


def test_lm_readers_read_nothing_off_the_card_or_in_other_cells():
    lm = [m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]
          if m.get("workloads") == [CELL]]
    assert len(lm) == 6
    for ctx in (_traced_ctx(device="cpu"), _traced_ctx(unit="tree")):
        for name in lm:
            assert _read(name, ctx) is None, name
    bare = _traced_ctx()
    bare.profile["ops"] = {"void at::native::elementwise_kernel": 0.1}
    assert _read("attn_roofline.prefill", bare) is None
    assert _read("gemm_roofline.prefill", bare) is None
