"""The port's Gram autotune cache (``core/gram.py``) against ``repro``'s.

The port of ``tests/test_tiling.py``'s autotune cases: a sweep on first
use, no sweep on a warm cache (in memory, or reloaded from the JSON file),
one entry per power-of-two bucket, and the disabling variable. The torch
backend's candidates are ``repro``'s ``xla`` candidates; the kernel
backend's vary ``d_tile``. A candidate that fails raises. ``run_trials``
with an autotuning engine tunes before its sweeps and returns the untuned
sweep's results.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import gram as j_gram
from repro_torch import interop
from repro_torch.core import Strategy, TrialPlan, run_trials
from repro_torch.core import gram as gram_mod
from repro_torch.core.gram import (GramConfig, GramEngine, candidate_configs,
                                   clear_autotune_cache)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = tmp_path / "gram_autotune.json"
    monkeypatch.setenv(gram_mod.AUTOTUNE_CACHE_ENV, str(path))
    monkeypatch.delenv(gram_mod.AUTOTUNE_ENV, raising=False)
    clear_autotune_cache()
    yield path
    clear_autotune_cache()


def _signs(n, d, seed=0):
    return np.random.default_rng(seed).choice(
        np.array([-1, 1], np.int8), size=(n, d))


def test_autotune_cache_roundtrip(cache):
    eng = GramEngine(backend="torch", autotune=True, device="cpu")
    c0 = gram_mod.autotune_sweep_count()
    win = eng.tune("int8", 64, 48)
    assert gram_mod.autotune_sweep_count() == c0 + 1
    assert cache.exists()
    entries = json.loads(cache.read_text())["entries"]
    assert list(entries) == ["cpu:torch:int8:n64:d64"]
    assert GramConfig(**entries["cpu:torch:int8:n64:d64"]) == win
    # in-memory hit: no new sweep
    assert eng.tune("int8", 64, 48) == win
    assert gram_mod.autotune_sweep_count() == c0 + 1
    # drop memory, keep the file: reload, still no new sweep
    clear_autotune_cache()
    assert eng.tune("int8", 64, 48) == win
    assert gram_mod.autotune_sweep_count() == c0 + 1
    # same pow2 bucket -> same entry, different bucket -> new sweep
    assert eng.tune("int8", 63, 47) == win
    assert gram_mod.autotune_sweep_count() == c0 + 1
    eng.tune("packed", 300, 200)
    assert gram_mod.autotune_sweep_count() == c0 + 2
    log = gram_mod.autotune_sweep_log()[-1]
    assert log["key"] == "cpu:torch:packed:n512:d256"
    assert [c for c, _ in log["times"]] == candidate_configs(
        "packed", 512, 256, "torch")
    # merge on write: another process's entry in the file survives
    data = json.loads(cache.read_text())
    data["entries"]["cpu:torch:code:n8:d8"] = {"d_tile": None,
                                               "n_chunk": None}
    cache.write_text(json.dumps(data))
    clear_autotune_cache()
    eng.tune("int8", 2048, 48)
    assert "cpu:torch:code:n8:d8" in json.loads(cache.read_text())["entries"]


def test_autotune_disabled_env(monkeypatch):
    monkeypatch.setenv(gram_mod.AUTOTUNE_ENV, "0")
    clear_autotune_cache()
    eng = GramEngine(backend="torch", autotune=True, d_tile=32, device="cpu")
    c0 = gram_mod.autotune_sweep_count()
    cfg = eng.tune("int8", 64, 48)
    assert gram_mod.autotune_sweep_count() == c0  # hatch closed: no sweep
    assert cfg.d_tile == 32  # engine's own config passes through


def test_foreign_cache_file_is_ignored(cache):
    """``repro``'s file (other GramConfig fields) is not the port's: it is
    dropped whole and the port sweeps."""
    cache.write_text(json.dumps({"version": 1, "entries": {
        "cpu:torch:int8:n64:d64": dataclasses.asdict(j_gram.GramConfig())}}))
    c0 = gram_mod.autotune_sweep_count()
    GramEngine(backend="torch", autotune=True, device="cpu").tune(
        "int8", 64, 48)
    assert gram_mod.autotune_sweep_count() == c0 + 1


@pytest.mark.parametrize("path", ["f32", "int8", "code", "packed"])
@pytest.mark.parametrize("n,d", [(64, 48), (512, 300), (8192, 1000),
                                 (8192, 4096)])
def test_torch_candidates_are_repros_xla_candidates(path, n, d):
    def knobs(cs):
        return [(c.d_tile, c.n_chunk) for c in cs]

    assert knobs(candidate_configs(path, n, d, "torch")) == knobs(
        j_gram.candidate_configs(path, n, d, "xla"))
    budget = 96 << 20
    assert knobs(candidate_configs(path, n, d, "torch", budget=budget)) == \
        knobs(j_gram.candidate_configs(path, n, d, "xla", budget=budget))


def test_kernel_candidates_vary_d_tile():
    assert candidate_configs("int8", 4096, 4096, "kernel") == [
        GramConfig(), *(GramConfig(d_tile=t) for t in (128, 256, 512, 1024))]
    assert candidate_configs("packed", 64, 300, "kernel") == [
        GramConfig(), GramConfig(d_tile=128), GramConfig(d_tile=256)]
    # f32 values contract in torch.matmul on the kernel backend
    assert candidate_configs("f32", 4096, 4096, "kernel") == [GramConfig()]


def test_tuned_engine_uses_the_winner(cache, monkeypatch):
    """The winner's streaming knobs drive the call: a tiled winner gives
    the monolithic Gram's bits on the integer paths."""
    monkeypatch.setattr(gram_mod, "_time_config",
                        lambda eng, cfg, *a: 0.0 if cfg.d_tile else 1.0)
    eng = GramEngine(backend="torch", autotune=True, device="cpu")
    u = torch.from_numpy(_signs(200, 160))
    seen = []
    real = GramEngine._value_block
    monkeypatch.setattr(GramEngine, "_value_block",
                        lambda self, a, b, be: seen.append(a.shape[-1])
                        or real(self, a, b, be))
    got = eng.gram(u)
    assert set(seen) == {128, 32}       # (160, 160) in 128-tiles
    assert gram_mod.tuned_config("int8", 200, 160, eng) == \
        GramConfig(d_tile=128)
    assert torch.equal(got, GramEngine(backend="torch",
                                       device="cpu").gram(u))


def test_a_failing_candidate_raises(cache, monkeypatch):
    def boom(eng, cfg, *a):
        if cfg.d_tile == 128:
            raise RuntimeError("flash: candidate failed to launch")
        return 1.0

    monkeypatch.setattr(gram_mod, "_time_config", boom)
    c0 = gram_mod.autotune_sweep_count()
    with pytest.raises(RuntimeError, match="failed to launch"):
        GramEngine(backend="kernel", autotune=True, device="cpu").tune(
            "int8", 64, 300)
    assert gram_mod.autotune_sweep_count() == c0 + 1
    assert not cache.exists()           # nothing cached from a failed sweep


def test_run_trials_autotuned_equals_untuned(cache, monkeypatch):
    """run_trials tunes each (bucket, path) before its sweeps; the tuned
    (here forced: the tiled candidate wins) sweep returns the untuned
    sweep's results."""
    plan = TrialPlan(d=160, ns=(40, 100), reps=4, strategies=(
        Strategy("sign"), Strategy("persymbol", rate=2),
        Strategy("original")))
    monkeypatch.setattr(gram_mod, "_time_config",
                        lambda eng, cfg, *a: 0.0 if cfg.d_tile else 1.0)
    c0 = gram_mod.autotune_sweep_count()
    tuned = run_trials(plan, engine=GramEngine(autotune=True), device="cpu")
    assert gram_mod.autotune_sweep_count() == c0 + 6   # 2 buckets x 3 paths
    keys = json.loads(cache.read_text())["entries"]
    assert sorted(keys) == sorted(
        f"cpu:torch:{p}:n{b}:d256" for p in ("int8", "code", "f32")
        for b in (64, 128))
    plain = run_trials(plan, device="cpu")
    for field in ("error_rate", "edit_distance", "edge_f1", "precision",
                  "recall", "buckets", "host_syncs"):
        assert getattr(tuned, field) == getattr(plain, field), field
    again = run_trials(plan, engine=GramEngine(autotune=True), device="cpu")
    assert gram_mod.autotune_sweep_count() == c0 + 6   # warm: no sweep
    assert again.error_rate == plain.error_rate


def test_engine_from_fields_carries_autotune():
    e = interop.engine_from_fields(dataclasses.asdict(
        j_gram.GramEngine(backend="xla", autotune=True, d_tile=256)),
        device="cpu")
    assert e == GramEngine(backend="torch", d_tile=256, autotune=True,
                           device="cpu")
