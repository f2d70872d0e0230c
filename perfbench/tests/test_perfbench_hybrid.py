"""The hybrid cell's yardstick on the CPU: the counts at the cell's shape,
the span readers on a recorded prefill, and a rehearsal of the whole run
at a small size (the program against the plain reference in f32, the fp8
control and each planted fault). CPU only:

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

from perfbench import harness, hybrid_gen, roofline, roofline_hybrid  # noqa: E402
from perfbench.kinds import hybrid_prefill  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "granite-4.0-h-small-prefill-32k"
H100 = "NVIDIA H100 80GB HBM3"
#: the cell at a few widths of its own: every key a size
SMALL = {"hidden_size": 64, "num_attention_heads": 2,
         "num_key_value_heads": 1, "intermediate_size": 32,
         "shared_intermediate_size": 48, "num_local_experts": 4,
         "num_experts_per_tok": 2, "mamba_d_state": 16, "mamba_d_head": 16,
         "mamba_n_heads": 8, "vocab_size": 256, "num_hidden_layers": 10}
TRAFFIC = {"batch": 2, "prompt_len": 64, "check_every": 16}


def _config(**over) -> dict:
    return {**harness.config(BENCH, harness.cell(BENCH, CELL)), **over}


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_counts_at_the_cells_shape():
    z = hybrid_gen.sizes(_config())
    assert z["types"].count("mamba") == 18 and z["layers"] == 20
    c = roofline_hybrid.prefill_counts(z, 2, 32768)
    t = 2 * 32768
    # GEMMs 8.39 GFLOP a token: the Mamba2 projections 3.68, the routed
    # experts 3.77, the shared 0.75, attention's 0.17, routers and head
    assert c["gemm"][0] / t == pytest.approx(8.390e9, rel=1e-3)
    assert c["experts"][0] == 20 * 6 * t * 10 * 4096 * 768
    assert c["attention"][0] == 2 * roofline.causal_attention_ops(
        2, 32768, 32, 128)
    # the SSD at chunk 256: 2 l N + H (2 l P + 4 N P) a token a layer
    assert c["ssd"][0] == 18 * t * (2 * 256 * 128 + 128 * (
        2 * 256 * 64 + 4 * 128 * 64))
    assert c["whole"][0] == pytest.approx(5.950e14, rel=1e-3)
    # least bytes of the SSD: x, y (H P), dt (H), B, C (N) a token in f32,
    # and each row's final state
    assert c["ssd"][1] == 18 * 4 * (t * (2 * 8192 + 128 + 256)
                                    + 2 * 128 * 64 * 128)
    floor = roofline.floor_s(c["whole"][0], 0, H100, roofline.BF16_PEAKS)
    assert floor == pytest.approx(0.6014, rel=1e-3)


def _recorded_ctx():
    """A context as a traced run on the card leaves it, with the spans
    of two small prefills recorded on the CPU (host-clock seconds)."""
    from repro_torch import trace

    cfg = _config(**SMALL, precision={"weights": "float32"})
    prog = hybrid_prefill.Program(cfg, 3, "cpu")
    tokens = torch.randint(0, 256, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    trace.clear()
    with trace.recording():
        for _ in range(2):
            prog.run(tokens, 64, torch.tensor([0]))
    wl = hybrid_prefill.Workload(cfg, {**harness.traffic(
        "hybrid-prefill-2x32768"), **TRAFFIC}, 3, "cpu")
    ctx = harness.Context(unit="token", device="cuda", device_name=H100)
    ctx.counts = wl.counts()
    ctx.whole_s = [0.5, 0.4, 0.45]
    ctx.profile = {"busy_s": 1.2, "window_s": 1.25, "calls": 2, "ops": {},
                   "device_ops": [], "idle_gaps": []}
    return ctx, trace.roots(trace.records(), "repro_torch.prefill")


def test_hybrid_readers_on_recorded_spans():
    ctx, calls = _recorded_ctx()
    assert len(calls) == 2

    def per_call(name):
        return sorted(sum(s.seconds for s in g if s.name == name)
                      for g in calls)

    def read(name):
        return harness.reader(name)(ctx)

    mamba, moe = per_call("repro_torch.mamba"), per_call("repro_torch.moe")
    assert read("mamba_ms.hybrid") == pytest.approx(
        1e3 * sum(mamba) / 2)
    assert read("moe_ms.hybrid") == pytest.approx(1e3 * sum(moe) / 2)
    c = ctx.counts
    ssd = per_call("repro_torch.ssd")
    shares = [roofline.share(*c["ssd"], s, H100,
                             roofline_hybrid.TF32_PEAKS) for s in ssd]
    assert read("ssd_roofline.hybrid") == pytest.approx(sum(shares) / 2)
    experts = per_call("repro_torch.experts")
    shares = [roofline.share(*c["experts"], s, H100, roofline.BF16_PEAKS)
              for s in experts]
    assert read("experts_roofline.hybrid") == pytest.approx(
        sum(shares) / 2)
    assert read("idle_share.hybrid") == pytest.approx(100 * (1 - 1.2 / 1.25))
    assert read("mfu.hybrid") == pytest.approx(
        100 * c["whole"][0] / roofline.BF16_PEAKS[H100][0] / 0.45)


def test_hybrid_readers_read_nothing_off_the_card_or_in_other_cells():
    names = [m["name"] for m in BENCH["per_layer"]
             if m.get("workloads") == [CELL]]
    assert len(names) == 6
    ctx, _ = _recorded_ctx()
    for dev, unit in (("cpu", "token"), ("cuda", "tree")):
        ctx.device, ctx.unit = dev, unit
        for name in names:
            assert harness.reader(name)(ctx) is None, name


def _run(system="program", seed=2 ** 31 + 977, dtype="float32"):
    return harness.run_cell(
        CELL, seed, 0.05, False, device="cpu", system=system,
        overrides={"config": {**SMALL, "precision": {"weights": dtype}},
                   "traffic": TRAFFIC},
        lim={"logit_gap": 1e-4, "kv_gap": 1e-4, "kv_start_gap": 1e-4,
             "state_gap": 1e-4, "answers_differ": 0})


def test_a_small_run_is_correct_and_its_control_is_not():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 * 2 * 64
    assert not _run("control")["correct"]


@pytest.mark.parametrize("fault", sorted(hybrid_prefill.FAULTS))
def test_each_fault_fails_a_small_run(fault, monkeypatch):
    from perfbench import faults

    for mod, attr, fn in faults.patches(fault, CELL):
        monkeypatch.setattr(mod, attr, fn)
    out = _run(seed=7)
    assert not out["correct"], (fault, out["checks"])
