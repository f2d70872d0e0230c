"""Each cell rehearsed end to end on the CPU at a tiny size, with the
committed limits: the program reads correct, traced too; the control (the
reference one precision below what the configuration states) and the
program broken underneath read not correct. On a card, each cell runs as
the benchmark runs it."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import faults, harness  # noqa: E402

TINY = {"production-sign": {"config": {"d": 48, "n": 4096}},
        "production-r4": {"config": {"d": 48, "n": 4096}},
        "fig3-d1024-sweep": {"config": {"d": 16, "ns": [64, 256],
                                        "reps": 4}},
        "granite-8b-prefill": {"config": {"n_layers": 4, "d_model": 256,
                                          "n_heads": 4, "n_kv_heads": 2,
                                          "head_dim": 64, "d_ff": 512,
                                          "vocab": 1024},
                               "traffic": {"batch": 2, "prompt_len": 256,
                                           "check_every": 64}}}
CELLS = list(TINY)
SEED = 2 ** 31 + 977


def rehearse(cell, seed=SEED, traced=False, system="program"):
    return harness.run_cell(cell, seed, 0.2, traced, device="cpu",
                            system=system, overrides=TINY[cell])


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_program_reads_correct(cell, traced):
    out = rehearse(cell, traced=traced)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-4:] == ["checks", "_numbers", "_check_s", "_calls_s"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_not_correct(cell):
    out = rehearse(cell, system="control")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["halve", "alter"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_reads_not_correct(cell, fault, monkeypatch):
    for mod, attr, fn in faults.patches(fault, cell):
        monkeypatch.setattr(mod, attr, fn)
    out = rehearse(cell)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("fault", ["stale", "drop_attn", "skip_rope"])
def test_a_broken_prefill_reads_not_correct(fault, monkeypatch):
    """The LM cell's own faults: its middle layer's cache left unwritten,
    its attention output dropped, its RoPE skipped."""
    for mod, attr, fn in faults.patches(fault, "granite-8b-prefill"):
        monkeypatch.setattr(mod, attr, fn)
    out = rehearse("granite-8b-prefill")
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", ["production-sign", "production-r4"])
def test_lower_precision_in_the_timed_entry_alone_reads_not_correct(
        cell, monkeypatch):
    """The stages the check runs stay sound; only ``strategy_weights``,
    the call the window's ``learn_structure`` makes, rounds to bf16."""
    from repro_torch.core import estimators

    entry = estimators.strategy_weights

    def bf16(x, strategy, **kw):
        return entry(x, strategy, **kw).bfloat16().float()

    monkeypatch.setattr(estimators, "strategy_weights", bf16)
    out = rehearse(cell)
    assert not out["correct"], out["checks"]
    assert out["checks"]["weights_gap"]["value"] > \
        out["checks"]["weights_gap"]["limit"]


def test_an_answer_of_a_plan_the_call_does_not_stage_reads_not_correct(
        monkeypatch):
    """Every plan of the pool is held to the reference, not only the one
    the staged call runs: an answer altered in another plan, in set-up
    and window alike, fails ``metric_gap``."""
    from perfbench import gen
    from perfbench.kinds import sweep

    cfg = TINY["fig3-d1024-sweep"]["config"]
    pool = harness.traffic("fig3-pool")["pool"]
    other = gen.plan_seeds(SEED, pool, cfg["reps"])[(SEED + 1) % pool]
    run = sweep.Program.run

    def altered(self, plan):
        res = run(self, plan)
        if plan.seed0 == other:
            res["sign"] = (res["sign"][0], [v + 1.0 for v in res["sign"][1]])
        return res

    monkeypatch.setattr(sweep.Program, "run", altered)
    out = rehearse("fig3-d1024-sweep")
    assert out["checks"]["answers_differ"]["value"] == 0
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for traced in (0, 1):
        p = subprocess.run(
            [sys.executable, "perfbench/run.py", "--workload", cell,
             "--seed", str(SEED), "--seconds", "2", "--trace", str(traced)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-4000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
        assert list(out)[-1] == "checks"
