"""BENCHMARK.json against the benchmark's contract, the files each name
resolves to, the roofline counts, and the import hygiene of the harness
and of the reference. CPU only:

    PYTHONPATH=src python -m pytest -q perfbench/tests
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from perfbench import harness, roofline  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.startswith("/")


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_texts(section):
    entries = BENCH[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), (e["name"], k)
        for k in e.get("reduced", []):
            assert NAME.match(k)
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    # a cell on four chips only where one card cannot show what it
    # measures: at most a quarter of the cells (one always may)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_resolve(w):
    cell = harness.cell(BENCH, w)
    cfg = harness.config(BENCH, cell)
    tr = harness.traffic(cell["traffic"])
    assert (ROOT / "perfbench" / "kinds" / f"{tr['kind']}.py").exists()
    lim = harness.limits(w)
    assert lim and all(isinstance(v, (int, float)) for v in lim.values())
    e2e = harness.metrics_for(BENCH, w, False)
    per = harness.metrics_for(BENCH, w, True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per
    for m in e2e + per:
        assert callable(harness.reader(m["name"]))
    for m in per:
        assert m["moves"] in names
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    for k in entry["reduced"]:
        assert k in cfg
    assert cfg["name"] == entry["name"]


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


def test_layers_are_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"`{m['layer']}`" in perf, m["layer"]


def test_gram_and_encode_counts():
    n, d = 1 << 20, 4096
    # the distinct entries d(d+1)/2, a multiply-add (2 operations) each
    assert roofline.gram_ops(n, d) == 2 * n * (d * (d + 1) // 2)
    assert roofline.gram_bytes(n, d, 1) == n * d + 4 * d * d
    assert roofline.encode_bytes(n, d) == 5 * n * d
    h100 = "NVIDIA H100 80GB HBM3"
    floor = roofline.floor_s(roofline.gram_ops(n, d), 0, h100)
    assert floor == pytest.approx(8.9e-3, rel=0.01)
    enc = roofline.floor_s(0, roofline.encode_bytes(n, d), h100)
    assert enc == pytest.approx(6.41e-3, rel=0.01)
    # a stage that ran at its floor reads 100%, never more
    assert roofline.share(0, roofline.encode_bytes(n, d), enc, h100) \
        == pytest.approx(100.0)
    assert roofline.share(1, 1, 1.0, "cpu") is None


def test_lm_prefill_counts():
    # one layer's causal attention at B 8, S 2048, 32 heads of 128:
    # q.k and p.v (2 Dh operations each) over S(S+1)/2 pairs a head
    assert roofline.causal_attention_ops(8, 2048, 32, 128) == \
        4 * 8 * 32 * 128 * (2048 * 2049 // 2)
    assert roofline.causal_attention_ops(8, 2048, 32, 128) == \
        pytest.approx(2.750e11, rel=1e-3)
    from perfbench.kinds import prefill

    cfg = harness.config(BENCH, harness.cell(BENCH, "granite-8b-prefill"))
    wl = prefill.Workload(cfg, harness.traffic("prefill-40x3968"), 7, "cpu")
    c = wl.counts()
    # q, k, v, o and the SwiGLU's three products a layer over all 158,720
    # tokens; the LM head over each row's last position
    b, s = 40, 3968
    per_layer = 4096 * (4096 + 2 * 1024) + 4096 * 4096 + 3 * 4096 * 14336
    assert c["gemm"][0] == 2 * b * s * 36 * per_layer + 2 * b * 4096 * 49152
    assert c["attention"][0] == 36 * roofline.causal_attention_ops(
        b, s, 32, 128)
    assert c["whole"][0] == c["gemm"][0] + c["attention"][0]
    assert c["whole"][0] == pytest.approx(2.678e15, rel=1e-3)
    assert wl.units(None) == b * s
    assert wl.positions.tolist() == list(range(0, s, 128)) + [s - 1]
    # at the bf16 peak a prefill cannot take less than ~2.71 s
    floor = roofline.floor_s(c["whole"][0], 0, "NVIDIA H100 80GB HBM3",
                             roofline.BF16_PEAKS)
    assert floor == pytest.approx(2.7069, rel=1e-3)


def test_sweep_and_tree_mfu_counts():
    from perfbench.kinds import sweep, tree

    cfg = harness.config(BENCH, harness.cell(BENCH, "fig3-d1024-sweep"))
    tr = harness.traffic("fig3-pool")
    wl = sweep.Workload(cfg, tr, 7, "cpu")
    ops = wl.counts()["whole"][0]
    assert ops == 6 * 120 * sum(n * 1024 * 1025 for n in (2048, 8192))
    assert wl.units(None) == 1440
    tcfg = harness.config(BENCH, harness.cell(BENCH, "production-sign"))
    tw = tree.Workload(tcfg, harness.traffic("sign"), 7, "cpu")
    c = tw.counts()
    assert c["whole"][0] == c["gram"][0] == roofline.gram_ops(1 << 20, 4096)


def test_readers_read_nothing_from_an_empty_context():
    ctx = harness.Context(unit="tree", device="cpu", device_name="cpu")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert harness.reader(m["name"])(ctx) is None, m["name"]


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program_or_jax():
    tops = _loaded("import perfbench.reference, perfbench.gen, "
                   "perfbench.threefry, perfbench.roofline")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_a_run_loads_no_jax_nor_the_jax_package():
    tops = _loaded(
        "from perfbench import harness\n"
        "harness.run_cell('production-sign', 5, 0.05, False, device='cpu',"
        " overrides={'config': {'d': 16, 'n': 512}})\n"
        "harness.run_cell('fig3-d1024-sweep', 5, 0.05, False, device='cpu',"
        " overrides={'config': {'d': 8, 'ns': [32], 'reps': 2}})\n"
        "harness.run_cell('granite-8b-prefill', 5, 0.05, False,"
        " device='cpu', overrides={'config': {'n_layers': 1, 'd_model': 64,"
        " 'n_heads': 2, 'n_kv_heads': 1, 'head_dim': 32, 'd_ff': 128,"
        " 'vocab': 256}, 'traffic': {'batch': 1, 'prompt_len': 16}})")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert harness.forbidden_modules(["repro_torch.core", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core", "jax"]) == [
        "jax", "repro.core"]
