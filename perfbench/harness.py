"""Run one cell of ``BENCHMARK.json``: set-up, the measured window (or,
traced, the spans and the device trace), then the check against the plain
reference.

Everything that belongs to one configuration, traffic mix or metric is
found by its name: ``BENCHMARK.json`` names the configuration's file;
``traffic/<name>.json`` holds a mix's parameters and names its ``kind``,
the module ``kinds/<kind>.py`` that drives it; ``metrics/<name>.py``
reads one metric from the run's context; ``limits/<cell>.json`` holds the
limit of each number the cell's check compares.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import statistics
import time
from pathlib import Path

import torch

from . import trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may load (whole names: the port's
#: ``repro_torch`` begins with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, w: dict) -> dict:
    for c in bench["configs"]:
        if c["name"] == w["config"]:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {w['config']!r}")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(name: str) -> dict:
    return load_json(HERE / "limits" / f"{name}.json")


def metrics_for(bench: dict, name: str, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: those that list it, or list no cells."""
    section = bench["per_layer" if traced else "end_to_end"]
    return [m for m in section if name in m.get("workloads", [name])]


def reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name is forbidden."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""

    unit: str
    device: str
    device_name: str
    setup_s: float = 0.0
    window_s: float = 0.0
    units: int = 0
    peak_work_bytes: int | None = None
    spans: trace.Spans | None = None
    whole_s: list = dataclasses.field(default_factory=list)
    counts: dict = dataclasses.field(default_factory=dict)
    profile: dict | None = None

    @property
    def on_card(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def stage_s(self, name: str) -> float | None:
        return self.spans.median(name) if self.spans is not None else None

    def whole_median_s(self) -> float | None:
        return statistics.median(self.whole_s) if self.whole_s else None


def _peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return torch.cuda.max_memory_allocated(device)


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device="cuda", system: str = "program", t0: float | None = None,
             overrides: dict | None = None, lim: dict | None = None,
             bench: dict | None = None) -> dict:
    """One run of cell ``name``: the result line's object. ``system`` is
    ``program`` (the port) or ``control`` (the reference one precision
    below, for setting limits); ``overrides`` ({"config": {...},
    "traffic": {...}}) and ``lim`` shrink a rehearsal on the CPU."""
    entry = time.perf_counter()
    t0 = entry if t0 is None else t0
    overrides = overrides or {}
    bench = bench or benchmark()
    w = cell(bench, name)
    cfg = {**config(bench, w), **overrides.get("config", {})}
    tr = {**traffic(w["traffic"]), **overrides.get("traffic", {})}
    kind = importlib.import_module(f"perfbench.kinds.{tr['kind']}")
    wl = kind.Workload(cfg, tr, seed, device, system)
    on_card = torch.device(device).type == "cuda"
    dev_name = torch.cuda.get_device_name(device) if on_card else "cpu"
    phases = {"start_and_imports": entry - t0,
              "device_init": time.perf_counter() - entry}
    wl.setup()
    trace.sync(device)
    ctx = Context(unit=wl.unit, device=str(device), device_name=dev_name,
                  setup_s=time.perf_counter() - t0, counts=wl.counts())
    peak = _peak(device)
    answers, i = [], 0

    def call():
        nonlocal i
        answers.append(wl.call(i))
        i += 1

    if not traced:
        held = torch.cuda.memory_allocated(device) if on_card else 0
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        w0 = last = time.perf_counter()
        while True:
            call()
            trace.sync(device)
            now = time.perf_counter()
            ctx.whole_s.append(now - last)
            last = now
            if now - w0 >= seconds:
                break
        ctx.window_s = now - w0
        ctx.units = sum(wl.units(a) for a in answers)
        if on_card:
            ctx.peak_work_bytes = _peak(device) - held
        peak = max(peak, _peak(device))
        staged = wl.staged(trace.Spans(device))
    else:
        n_whole, n_staged, n_prof = getattr(wl, "trace_reps", (3, 3, 3))
        for _ in range(n_whole):
            a = time.perf_counter()
            call()
            trace.sync(device)
            ctx.whole_s.append(time.perf_counter() - a)
        ctx.spans = trace.Spans(device)
        for _ in range(n_staged):
            ctx.spans.repetition()
            staged = wl.staged(ctx.spans)
        ctx.spans.repetition()
        if on_card:
            ctx.profile = trace.profile(
                lambda: [call() for _ in range(n_prof)])
            ctx.profile["calls"] = n_prof
        ctx.units = sum(wl.units(a) for a in answers)
        peak = max(peak, _peak(device))

    metrics = {}
    for m in metrics_for(bench, name, traced):
        v = reader(m["name"])(ctx)
        if v is None:
            if not traced and on_card:
                raise RuntimeError(f"end-to-end metric {m['name']} read "
                                   f"nothing in {name}")
            continue
        metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    if on_card:
        torch.cuda.empty_cache()
    c0 = time.perf_counter()
    numbers, per = wl.check(answers, staged)
    check_s = time.perf_counter() - c0
    lim = limits(name) if lim is None else lim
    checks = {k: {"value": numbers.get(k), "limit": v}
              for k, v in lim.items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    failed = sum(wl.units(a) for a, p in zip(answers, per)
                 if any(v > lim.get(k, float("inf")) for k, v in p.items()))
    dev = {"platform": "gpu" if on_card else "cpu", "kind": dev_name,
           "count": int(w.get("chips", 1)), "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": ctx.units,
           "failed": int(failed), "metrics": metrics, "device": dev}
    if ctx.profile is not None:
        dev["busy_s"] = ctx.profile["busy_s"]
        dev["window_s"] = ctx.profile["window_s"]
        out["breakdown"] = {"device_ops": ctx.profile["device_ops"],
                            "idle_gaps": ctx.profile["idle_gaps"]}
    out["_setup_phases"] = {**phases, **getattr(wl, "setup_phases", {})}
    out["checks"] = checks
    out["_numbers"] = numbers
    out["_check_s"] = check_s
    out["_calls_s"] = ctx.whole_s
    return out
