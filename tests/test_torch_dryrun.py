"""The dry run (``launch.steps.plan_program``, ``launch.op_analysis``,
``launch.dryrun``) held to ``repro``'s ``build_program`` and
``hlo_analysis``.

Each side runs in subprocesses started together: ``repro`` with
``XLA_FLAGS=--xla_force_host_platform_device_count=N`` (its production
meshes over 512 forced devices, its reduced programs lowered and
compiled over 8), the port in a process of its own that joins a fake
process group (``dryrun.fake_group``) and counts rank 0's step on meta
tensors. ``repro`` and JAX are imported inside the subprocess scripts
only.

What is held, and how:

* Per-device parameter and AdamW-moment bytes on both production meshes,
  every arch at every shape: equal to ``NamedSharding.shard_shape`` over
  ``build_program``'s arguments leaf by leaf, except the leaves whose
  layout the port takes on purpose (``models/sharding.py``): K/V heads
  kept whole where the model axis does not divide them, Mamba2's
  head-aligned columns, and a module replicated over ``model`` when the
  axis does not divide its heads; the plan's batch axes, window,
  microbatches, FSDP and ep2d choices equal ``repro``'s.
* Reduced programs (f32, batch 8 x 64 tokens) on (2, 2) ``("data",
  "model")`` and (2, 2, 2) ``("pod", "data", "model")``: argument bytes
  equal ``memory_analysis().argument_size_in_bytes`` once the leaves
  whose dtype differs are named (int64 tokens and labels where ``repro``
  has int32; the decode position and the AdamW step, host ints here,
  int32 leaves there). Inference FLOPs: a decode equals ``analyze``'s; a
  dense prefill is within ``PREFILL_FLOPS_RTOL`` below it (``repro``'s
  blockwise attention computes every (query, key) block, the kernel the
  causal half); a MoE program on the pod mesh is recorded with its
  ratio (``repro`` gathers the experts' d_ff over (pod, data) where they
  are stored over data alone, so each runs twice as wide). Train
  FLOPs: the ratio is held to a band and explained in
  ``test_train_flops_ratio``.
* Collective bytes only where both sides do the same collectives: a dense
  prefill over a model-only (1, 4) mesh, whose row-parallel all-reduces
  are counted by hand.

The extrapolation over superblocks and microbatches is held to the whole
count, and the CLI to its records.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TESTS = os.path.dirname(os.path.abspath(__file__))

ARCHS = ("granite-34b", "granite-8b", "jamba-1.5-large-398b",
         "llama4-scout-17b-a16e", "llava-next-mistral-7b", "mamba2-370m",
         "mistral-nemo-12b", "qwen2-moe-a2.7b", "seamless-m4t-large-v2",
         "stablelm-3b")
SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
PROD_CASES = [(a, s, m) for a in ARCHS for s in SHAPE_NAMES
              for m in (False, True)]
#: leaves whose layout the port takes on purpose (``models/sharding.py``)
OWN_LAYOUT = {"wq", "wk", "wv", "wo", "in_proj", "conv_w", "conv_b",
              "norm_scale"}

B, S = 8, 64
REDUCED_MESHES = {"2x2": ((2, 2), ("data", "model")),
                  "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
                  "1x4": ((1, 4), ("data", "model"))}
REDUCED_CASES = [(a, k, m) for a in ("granite-8b", "qwen2-moe-a2.7b")
                 for k in ("prefill", "decode", "train")
                 for m in ("2x2", "2x2x2")] + [("granite-8b", "prefill",
                                                "1x4")]
#: a dense prefill's FLOPs below ``analyze``'s: ``repro``'s blockwise
#: attention computes all S^2 (query, key) pairs, the kernel S(S + 1)/2
PREFILL_FLOPS_RTOL = 0.05
#: the train step's FLOPs over ``analyze``'s (see test_train_flops_ratio)
TRAIN_RATIO = {("granite-8b", "2x2"): (1.0, 1.05),
               ("granite-8b", "2x2x2"): (1.0, 1.05),
               ("qwen2-moe-a2.7b", "2x2"): (1.0, 1.05),
               ("qwen2-moe-a2.7b", "2x2x2"): (0.55, 0.65)}


# -- the two sides, each in its own processes ----------------------------------

_REPRO_PROD = """
import pickle, sys
import numpy as np, jax
import repro
from repro.launch import steps as S
from repro.launch.mesh import make_production_mesh
from repro.launch.shapes import SHAPES
from repro.models.arch import get_arch
from repro.models import sharding as sh

out = {}
for arch, shape, multi in pickle.load(open(sys.argv[1], "rb")):
    mesh = make_production_mesh(multi_pod=multi)
    prog = S.build_program(get_arch(arch), SHAPES[shape], mesh)
    flat = jax.tree_util.tree_leaves_with_path(prog.args[0])
    shard = jax.tree.leaves(prog.in_shardings[0])
    leaves = {tuple(str(getattr(p, "key", p)) for p in path):
              (tuple(l.shape), tuple(s.shard_shape(l.shape)),
               l.dtype.itemsize) for (path, l), s in zip(flat, shard)}
    moments = 0
    if SHAPES[shape].kind == "train":
        st, ssh = prog.args[1], prog.in_shardings[1]
        moments = {tuple(str(getattr(p, "key", p)) for p in path):
                   int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
                   for (path, l), s in zip(
                       jax.tree_util.tree_leaves_with_path(st.moments),
                       jax.tree.leaves(ssh.moments))}
    embed = dict(zip([tuple(str(getattr(p, "key", p)) for p in path)
                      for path, _ in flat], shard))[("embed",)]
    cache = 0
    if SHAPES[shape].kind == "decode":
        cache = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                    for l in jax.tree.leaves(prog.args[1]))
    out[arch, shape, multi] = dict(
        leaves=leaves, moments=moments, ep2d=sh.get_ep2d(),
        fsdp="data" in str(embed.spec), meta=prog.meta, cache=cache)
pickle.dump(out, open(sys.argv[2], "wb"))
"""

_REPRO_REDUCED = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
import repro
from repro.launch import steps as S, hlo_analysis as H
from repro.launch.shapes import InputShape
from repro.models.arch import get_arch

out = {}
for arch, kind, (shape, axes), (b, s) in pickle.load(open(sys.argv[1], "rb")):
    n = int(np.prod(shape))
    mesh = jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    prog = S.build_program(get_arch(arch).reduced(),
                           InputShape(f"{kind}_{s}", kind, s, b), mesh,
                           param_dtype=jnp.float32)
    comp = S.lower_program(prog, mesh).compile()
    an = H.analyze(comp.as_text())
    out[arch, kind, shape] = dict(
        arg=comp.memory_analysis().argument_size_in_bytes,
        flops=an["dot_flops"], coll=an["collectives"], meta=prog.meta)
pickle.dump(out, open(sys.argv[2], "wb"))
"""

_PORT = """
import sys
sys.path.insert(0, {tests!r})
import test_torch_dryrun as t
t._port_main(sys.argv[1], sys.argv[2])
"""


def _python(code, args, devices=0):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             *map(str, args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _port_main(inputs, out_path):
    """The port's side, in a process of its own: the production meshes'
    plans and rank 0's parameters (on meta), and the reduced programs'
    dry runs."""
    import math

    import torch

    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, InputShape
    from repro_torch.models import sharding
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer

    torch.set_num_threads(1)
    with open(inputs, "rb") as f:
        prod, reduced = pickle.load(f)
    out = {}
    for multi in (False, True):
        with dryrun.fake_group(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device="cpu")
            for arch, shape, m in prod:
                if m != multi:
                    continue
                cfg = get_arch(arch)
                plan = steps.plan_program(cfg, SHAPES[shape], mesh,
                                          budget=steps.REPRO_BUDGET)
                model = Transformer(cfg, device="meta", mesh=mesh,
                                    dtype=plan.param_dtype, **plan.layout)
                lays, params = model.param_layouts(), {}
                for name, p in model.named_parameters():
                    lay = lays[name]
                    rule = sharding._drop_indivisible(
                        mesh, model.shard.spec(name.rsplit(".", 1)[-1],
                                               p.dim()),
                        lay.shape if lay else tuple(p.shape))
                    own = lay is not None and (lay.custom or (
                        "model" in rule and lay.mdim is None))
                    params[name] = (tuple(p.shape), p.element_size(), own)
                cache = sum(math.prod(shp) * torch.empty(
                    (), dtype=dt).element_size()
                    for _, _, shp, dt, _ in plan.cache)
                out["prod", arch, shape, multi] = dict(
                    params=params, layout=plan.layout, meta=plan.meta,
                    cache=cache)
    for arch, kind, (shape, axes), (b, s) in reduced:
        with dryrun.on_mesh(shape, axes) as mesh:
            out["reduced", arch, kind, shape] = dryrun.dry_run(
                get_arch(arch).reduced(), InputShape(f"{kind}_{s}", kind, s,
                                                     b), mesh,
                param_dtype=torch.float32, budget=steps.REPRO_BUDGET)
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


def _communicate(proc, what):
    _, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, f"{what}:\n{err[-4000:]}"


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(port, repro production, repro reduced), the three subprocesses
    run at once."""
    tmp = tmp_path_factory.mktemp("dryrun")
    reduced = [(a, k, REDUCED_MESHES[m], (B, S)) for a, k, m in
               REDUCED_CASES]
    with open(tmp / "port_in.pkl", "wb") as f:
        pickle.dump((PROD_CASES, reduced), f)
    with open(tmp / "prod_in.pkl", "wb") as f:
        pickle.dump(PROD_CASES, f)
    with open(tmp / "red_in.pkl", "wb") as f:
        pickle.dump(reduced, f)
    procs = [
        ("port", _python(_PORT.format(tests=TESTS),
                         [tmp / "port_in.pkl", tmp / "port.pkl"])),
        ("repro production", _python(_REPRO_PROD, [
            tmp / "prod_in.pkl", tmp / "prod.pkl"], devices=512)),
        ("repro reduced", _python(_REPRO_REDUCED, [
            tmp / "red_in.pkl", tmp / "red.pkl"], devices=8))]
    for what, proc in procs:
        _communicate(proc, what)
    return tuple(pickle.load(open(tmp / f"{n}.pkl", "rb"))
                 for n in ("port", "prod", "red"))


# -- the production meshes -------------------------------------------------------

def _repro_path(cfg):
    """{port parameter name: (``repro``'s leaf path, stacked)}."""
    from repro_torch import interop

    out = {"embed": (("embed",), False),
           "final_norm.scale": (("final_norm", "scale"), False)}
    if not cfg.tie_embeddings:
        out["unembed"] = (("unembed",), False)
    if cfg.is_encoder_decoder:
        out["enc_norm.scale"] = (("enc_norm", "scale"), False)
    for key_j, mods, pattern, n_rep in interop._stacks(cfg):
        for i, (key, _) in enumerate(interop._layer_index(cfg, pattern,
                                                          n_rep)):
            for name, path in interop._layer_leaves(
                    cfg, pattern[int(key[1:])]):
                out[f"{mods}.{i}.{name}"] = ((key_j, key, *path), True)
    return out


@pytest.mark.parametrize("arch,shape,multi", PROD_CASES,
                         ids=lambda v: {True: "pod2x16x16",
                                        False: "pod16x16"}.get(v, v))
def test_production_bytes_per_device_are_repros(sides, arch, shape, multi):
    """Rank 0's parameter (and, training, AdamW-moment) bytes leaf by leaf
    equal ``repro``'s per-device shards, but for the port's own layouts;
    the plan's batch axes, window, microbatches, FSDP and ep2d are
    ``repro``'s, and a decode plan's cache leaves hold ``repro``'s cache
    bytes."""
    from repro_torch.models.arch import get_arch

    port, prod, _ = sides
    mine, want = port["prod", arch, shape, multi], prod[arch, shape, multi]
    meta = dict(want["meta"])
    assert mine["meta"] == meta
    assert mine["layout"]["ep2d"] == want["ep2d"]
    assert mine["layout"]["fsdp"] == (want["fsdp"] and not want["ep2d"])
    assert mine["cache"] == want["cache"]
    paths = _repro_path(get_arch(arch))
    assert set(paths) == set(mine["params"])
    n_rep_of = {}
    for key, (full, local, item) in want["leaves"].items():
        n_rep_of[key] = full[0] if key[0] in ("blocks", "enc_blocks") else 1
    own = set()
    for name, (local, item, is_own) in mine["params"].items():
        path, stacked = paths[name]
        full, rlocal, ritem = want["leaves"][path]
        assert item == ritem, name
        if stacked:     # the stack axis is never sharded
            assert rlocal[0] == full[0]
            rlocal = rlocal[1:]
        got = item
        for d in local:
            got *= d
        exp = ritem
        for d in rlocal:
            exp *= d
        if is_own:
            own.add(name.rsplit(".", 1)[-1])
            continue
        assert got == exp, (name, local, rlocal)
        if shape == "train_4k":
            moments = want["moments"]
            mu = moments[("mu", *path)] // (n_rep_of[path])
            nu = moments[("nu", *path)] // (n_rep_of[path])
            assert mu == nu == 4 * got // item, name
    assert own <= OWN_LAYOUT, own


# -- the reduced programs --------------------------------------------------------

def _reduced(sides, arch, kind, mesh):
    port, _, red = sides
    shape = REDUCED_MESHES[mesh][0]
    return port["reduced", arch, kind, shape], red[arch, kind, shape]


def _int_leaf_bytes(kind, mesh):
    """The bytes by which the port's argument leaves differ from
    ``repro``'s: int64 tokens (and labels) where ``repro`` has int32, 4
    extra bytes an element of the rank's rows; the decode position and
    the AdamW step, 4-byte int32 leaves of ``repro``, host ints here."""
    shape, axes = REDUCED_MESHES[mesh]
    shards = 1
    for n, a in zip(shape, axes):
        if a in ("pod", "data"):
            shards *= n
    rows = B // shards
    if kind == "decode":
        return 4 * rows - 4
    per = 2 if kind == "train" else 1
    return 4 * rows * S * per - (4 if kind == "train" else 0)


@pytest.mark.parametrize("arch,kind,mesh", REDUCED_CASES)
def test_reduced_argument_bytes_are_repros(sides, arch, kind, mesh):
    mine, want = _reduced(sides, arch, kind, mesh)
    assert mine["memory"]["argument_bytes"] == \
        want["arg"] + _int_leaf_bytes(kind, mesh)
    assert mine["meta"]["batch_axes"] == want["meta"]["batch_axes"]
    assert mine["meta"].get("microbatches") == \
        want["meta"].get("microbatches")


@pytest.mark.parametrize("arch,kind,mesh", [
    c for c in REDUCED_CASES if c[1] != "train"])
def test_reduced_inference_flops_are_repros(sides, arch, kind, mesh):
    """Decode: equal. Prefill: the port's count is within
    PREFILL_FLOPS_RTOL below ``analyze``'s (the kernel computes the causal
    pairs, ``repro``'s blockwise attention every pair). A MoE program on
    the pod mesh is recorded only: ``repro`` all-gathers the experts' d_ff
    over (pod, data) where they are stored over data alone
    (``repro/models/layers.py:510-517``), so its expert dots read f 1024
    for d_ff 512 and count twice the port's; on (2, 2) the two agree."""
    mine, want = _reduced(sides, arch, kind, mesh)
    got, ref = mine["cost"]["flops_per_device"], want["flops"]
    print(f"{arch} {kind} {mesh}: port {got:.6e} repro {ref:.6e} "
          f"ratio {got / ref:.4f}")
    if "moe" in arch and mesh == "2x2x2":
        assert got < ref
        return
    if kind == "decode":
        assert got == ref
    else:
        assert ref * (1 - PREFILL_FLOPS_RTOL) <= got <= ref


@pytest.mark.parametrize("arch,mesh", [
    (a, m) for a, k, m in REDUCED_CASES if k == "train"])
def test_train_flops_ratio(sides, arch, mesh):
    """The train step's FLOPs over ``analyze``'s. Both rematerialise each
    block's forward once in the backward (``jax.checkpoint`` on the scan
    body; ``torch.utils.checkpoint`` on each block), so the matmuls count
    three forwards' worth on both sides. What differs: the attention
    (``repro``'s blockwise forward and its recompute take every (query,
    key) pair, the port's kernel the causal half, while the port's
    backward, ``flash_prefill_backward`` in PyTorch, takes every pair of
    its chunks and recomputes the scores once more), and the loss
    (``repro``'s remat of the logits): the port counts 1.0-1.05 of
    ``repro`` (granite 1.033, qwen2-moe on (2, 2) 1.016). On the pod
    mesh qwen2-moe reads 0.55-0.65 (0.608): ``repro``'s expert FFN runs
    twice as wide a rank there, as in the inference test."""
    mine, want = _reduced(sides, arch, "train", mesh)
    ratio = mine["cost"]["flops_per_device"] / want["flops"]
    print(f"{arch} train {mesh}: port {mine['cost']['flops_per_device']:.6e}"
          f" repro {want['flops']:.6e} ratio {ratio:.4f}")
    lo, hi = TRAIN_RATIO[arch, mesh]
    assert lo <= ratio <= hi


def test_model_axis_prefill_collectives_are_counted_by_hand(sides):
    """A dense prefill over (1, 4): each layer's two row-parallel products
    (``wo``, ``w_down``) and the vocab-parallel embedding are all-reduced,
    (2 L + 1) all-reduces of the (B, S, d) f32 activations, and the last
    position's logits all-gathered over ``model``. ``repro``'s
    all-reduces are those and some norm-sized ones, within 2% of the
    count; its all-gathers return other tensors (its logits stay sharded
    over ``model``) and are recorded only."""
    from repro_torch.models.arch import get_arch

    mine, want = _reduced(sides, "granite-8b", "prefill", "1x4")
    cfg = get_arch("granite-8b").reduced()
    act = B * S * cfg.d_model * 4
    by_op = mine["collectives"]["by_op"]
    assert by_op["all-reduce"] == (2 * cfg.n_layers + 1) * act
    assert mine["collectives"]["count"]["all-reduce"] == \
        2 * cfg.n_layers + 1
    assert by_op["all-gather"] == B * cfg.padded_vocab * 4
    ref = want["coll"]["by_op"]["all-reduce"]
    assert by_op["all-reduce"] <= ref <= 1.02 * by_op["all-reduce"]
    print(f"(1, 4) prefill collectives: port {mine['collectives']}, repro "
          f"{want['coll']}")


# -- the port alone --------------------------------------------------------------

_EXTRAPOLATION = """
import dataclasses, pickle, sys, torch
from repro_torch.launch import dryrun, op_analysis as A, steps
from repro_torch.launch.shapes import InputShape
from repro_torch.models.arch import get_arch
torch.set_num_threads(1)
out = {}
for arch, kind in (("granite-8b", "train"), ("jamba-1.5-large-398b",
                                             "prefill")):
    cfg = get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=4 * len(cfg.pattern))
    shape = InputShape("x", kind, 64, 8)
    with dryrun.on_mesh((2, 2), ("data", "model")) as mesh:
        plan = steps.plan_program(cfg, shape, mesh,
                                  param_dtype=torch.float32,
                                  microbatches=4 if kind == "train" else 0)
        batch = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                 for k, v in plan.batch.items()}
        trips = (1, 2, 4) if kind == "train" else (1,)
        base = 2 if kind == "train" else 1
        counts = {(k, t): dryrun._count(
            plan, dryrun.superblocks(cfg, k), shape, mesh, device="meta",
            batch=batch, trips=t)[0]
            for k in (base, base + 1, 4) for t in trips}
    whole = counts[4, trips[-1]]
    ext = A.extrapolate({(k, t): c for (k, t), c in counts.items()
                         if k < 4 and t <= 2}, 4, trips[-1], base)
    out[arch] = [(c.dot_flops, c.kernel_flops, c.hbm_bytes, c.peak_bytes,
                  c.collectives()) for c in (whole, ext)]
pickle.dump(out, open(sys.argv[1], "wb"))
"""


def test_extrapolation_is_the_whole_count(tmp_path):
    """Counts over 1 and 2 superblocks (a train step: 2 and 3) and 1 and 2
    microbatches, extrapolated by ``op_analysis.extrapolate``, equal the
    count over 4 of each: FLOPs, bytes, collectives and the peak (reduced
    granite's train step of 4 microbatches, reduced jamba's prefill, on a
    (2, 2) fake mesh)."""
    proc = _python(_EXTRAPOLATION, [tmp_path / "ext.pkl"])
    _communicate(proc, "extrapolation")
    for arch, (whole, ext) in pickle.load(
            open(tmp_path / "ext.pkl", "rb")).items():
        assert whole[:4] == pytest.approx(ext[:4], rel=1e-12), arch
        assert whole[4]["by_op"] == pytest.approx(ext[4]["by_op"]), arch


def test_kernels_take_no_meta_tensor_outside_a_count():
    """A meta tensor reaching an attention wrapper outside the dry run
    raises; inside a count it takes the stand-in, which allocates the
    kernel's output and reports the kernel's formula."""
    import torch

    from repro_torch.kernels import decode_attention, flash_prefill, meta
    from repro_torch.kernels.flash_prefill import (flash_prefill_cost,
                                                   visible_pairs)

    q = torch.empty(2, 16, 4, 64, device="meta")
    kv = torch.empty(2, 16, 2, 64, device="meta")
    with pytest.raises(RuntimeError, match="outside the dry run"):
        flash_prefill(q, kv, kv)
    with pytest.raises(RuntimeError, match="outside the dry run"):
        decode_attention(q[:, 0], kv.transpose(1, 2), kv.transpose(1, 2), 9)
    calls = []
    with meta.observing(lambda *a: calls.append(a)):
        out = flash_prefill(q, kv, kv, window=5)
        assert out.shape == q.shape and out.device.type == "meta"
        decode_attention(q[:, 0], kv.transpose(1, 2), kv.transpose(1, 2),
                         9, window=4)
    assert [c[0] for c in calls] == ["flash_prefill", "decode_attention"]
    assert calls[0][1:] == flash_prefill_cost(q, kv, kv, True, 5)
    assert calls[1][1] == 4 * 2 * 4 * 64 * 4   # 4 valid entries of 9
    for sq, skv, causal, window in ((16, 16, True, 0), (16, 16, True, 5),
                                    (16, 24, False, 0), (7, 7, True, 3)):
        i = torch.arange(sq)[:, None]
        j = torch.arange(skv)[None, :]
        mask = torch.ones(sq, skv, dtype=torch.bool)
        if causal:
            mask &= j <= i
        if window:
            mask &= j > i - window
        assert visible_pairs(sq, skv, causal, window) == int(mask.sum())


_CLI = """
import sys
from repro_torch.launch import dryrun
sys.exit(dryrun.main(sys.argv[1:]))
"""


def test_dryrun_cli_writes_repros_record(tmp_path):
    """``python -m repro_torch.launch.dryrun``: one record a combination
    with ``repro``'s keys; a combination over the card's memory is
    reported as not fitting, not as a failure; without ``--hbm-bytes`` on
    a host without a card it raises."""
    out = tmp_path / "recs"
    proc = _python(_CLI, ["--arch", "granite-8b", "--shape", "decode_32k",
                          "--mesh", "both", "--hbm-bytes", str(4 * 2**30),
                          "--out", out])
    stdout, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    names = sorted(os.listdir(out))
    assert names == ["granite-8b__decode_32k__pod16x16.json",
                     "granite-8b__decode_32k__pod2x16x16.json"]
    recs = [json.load(open(out / n)) for n in names]
    for r in recs:
        assert {"name", "arch", "shape", "mesh", "kind", "n_devices",
                "meta", "memory", "cost", "collectives"} <= set(r)
        assert {"argument_bytes", "output_bytes", "temp_bytes"} <= \
            set(r["memory"])
        assert {"flops_per_device", "bytes_per_device"} <= set(r["cost"])
        assert set(r["collectives"]) == {"total_bytes", "by_op", "count"}
    assert [r["n_devices"] for r in recs] == [256, 512]
    # 5.50 GiB on pod16x16 and 3.25 GiB on pod2x16x16 against 4 GiB
    assert [r["memory"]["fits"] for r in recs] == [False, True]
    assert "DOES NOT FIT" in stdout and "1 do not fit" in stdout
    proc = _python(_CLI, ["--arch", "granite-8b", "--shape", "decode_32k",
                          "--out", out])
    _, err = proc.communicate(timeout=600)
    assert proc.returncode != 0 and "--hbm-bytes" in err


def test_plan_is_a_dataclass_of_repros_decisions():
    """``plan_program`` needs no process group beyond its mesh's and builds
    nothing: its batch leaves are meta tensors of ``repro``'s shapes."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models.arch import get_arch

    cfg = get_arch("seamless-m4t-large-v2")
    specs = steps.batch_specs(cfg, SHAPES["train_4k"])
    assert {k: (tuple(v.shape), v.dtype) for k, v in specs.items()} == {
        "tokens": ((256, 4096), torch.int64),
        "labels": ((256, 4096), torch.int64),
        "mask": ((256, 4096), torch.float32),
        "enc_embeds": ((256, 1024, cfg.d_model), torch.float32)}
    assert all(v.device.type == "meta" for v in specs.values())
    assert {f.name for f in dataclasses.fields(steps.ProgramPlan)} >= {
        "batch_axes", "window", "microbatches", "layout", "cache"}
