"""The LM on a mesh: the port's sharded serving (``Transformer(mesh=)``:
tensor, expert and FSDP sharding, the 2-D experts of ep2d) on 4 gloo
ranks over (1, 4), (2, 2) and (4, 1), held to ``repro``.

One ``torch.multiprocessing.spawn`` of 4 ranks (a ``FileStore``, one
torch thread a rank) runs every case: ``repro``'s weights cross over as
numpy (``interop.lm_params_from_numpy(mesh=)``, each rank keeping its
slices), the prompts and the modality stubs' embeddings come from numpy
seeds, and each rank serves its shard of the batch: a prefill and 8
greedy decode steps, the logits all-gathered over ``model`` and the
shards over ``data``. Every rank must return the same results.

The references:

* where the sharded math is ``repro``'s global math (tensor parallel,
  FSDP, Mamba2 over its heads, expert parallel at one data shard, ep2d
  without drops), ``repro`` without a mesh;
* expert parallelism over several data shards computes its capacity per
  shard, by design: ``repro`` on a forced 4-device JAX mesh in one
  subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=4``).

Logits within 1e-4 (jamba 1e-3, its Mamba2 scan noise), equal greedy
ids, and equal dropped assignments over the whole run. The drops of
``repro`` are counted inside its ``_dispatch_ffn`` (a debug callback of
each expert shard's overflow). ``repro`` and JAX are imported inside the
tests only: the spawned ranks import this module.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MESHES = ((1, 4), (2, 2), (4, 1))
B, S, STEPS = 4, 16, 8
#: case -> (arch, replaced fields, meshes, Transformer layout)
CASES = {
    "granite": ("granite-8b", {}, MESHES, {}),
    "granite-fsdp": ("granite-8b", {}, ((2, 2),), {"fsdp": True}),
    # n_kv_heads % M != 0: each rank keeps the K/V head its Q head reads
    "granite-kv2": ("granite-8b", {"n_kv_heads": 2}, ((1, 4),), {}),
    "qwen2-moe": ("qwen2-moe-a2.7b", {}, MESHES, {}),
    "qwen2-moe-ep2d": ("qwen2-moe-a2.7b", {"moe_capacity_factor": 64.0},
                       ((2, 2),), {"ep2d": True}),
    "jamba": ("jamba-1.5-large-398b", {}, MESHES, {}),
    "llama4-scout": ("llama4-scout-17b-a16e", {}, MESHES, {}),
}
ATOL = {"jamba": 1e-3}


def _on_jax_mesh(case: str, mesh) -> bool:
    """Whether ``repro``'s reference for (case, mesh) runs on a JAX mesh:
    expert parallelism with capacity per data shard, D > 1, drops on."""
    arch, repl, _, layout = CASES[case]
    return mesh[0] > 1 and "moe" in _family(arch) and not layout


def _family(arch: str) -> str:
    return {"qwen2-moe-a2.7b": "moe", "jamba-1.5-large-398b": "hybrid-moe",
            "llama4-scout-17b-a16e": "vlm-moe"}.get(arch, "dense")


# -- the port on 4 ranks -------------------------------------------------------

def _greedy(model, tokens, emb, steps):
    """(logits of the prefill and each step (steps + 1, B, V), ids (B,
    steps + 1), dropped assignments over the run), the batch whole on
    every rank."""
    sh = model.shard
    axes = model.batch_shard(tokens.shape[0]).axes
    toks = torch.from_numpy(tokens).long()
    kw = {k: torch.from_numpy(v) for k, v in emb.items()}
    dropped = []
    hooks = [blk.ff.register_forward_hook(
        lambda m, args, kwargs, out: dropped.append(int(m.dropped(
            args[0], kwargs.get("decode", False), kwargs["batch"]))),
        with_kwargs=True)
        for blk in model.layers if blk.spec.ff == "moe"]
    s = toks.shape[1] + (kw["modal_embeds"].shape[1]
                         if "modal_embeds" in kw else 0)
    logits, cache = model.prefill(toks, max_len=s + steps, **kw)
    out, ids = [logits[:, -1]], []
    for i in range(steps + 1):
        tok = sh.batch_cat(logits[:, -1].argmax(-1, keepdim=True), axes)
        ids.append(tok)
        if i < steps:
            logits, cache = model.decode_step(cache, tok, s + i)
            out.append(logits[:, -1])
    for h in hooks:
        h.remove()
    lg, ids = sh.batch_cat(torch.stack(out), axes, 1), torch.cat(ids, 1)
    return lg.numpy(), ids.numpy(), sum(dropped)


def _rank_main(rank, world, store, inputs, out_dir):
    from repro_torch import interop
    from repro_torch.launch.mesh import init_rank, make_host_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    res = {}
    with torch.no_grad():
        for case, (fields, params, tokens, emb) in data.items():
            cfg = interop.arch_from_fields(fields)
            for mesh_shape in CASES[case][2]:
                mesh = make_host_mesh(*mesh_shape, device="cpu")
                model = interop.lm_params_from_numpy(
                    cfg, params, device="cpu", mesh=mesh,
                    **CASES[case][3])
                res[case, mesh_shape] = _greedy(model, tokens, emb, STEPS)
                # the bytes the rank's parameters own and the bytes their
                # storages hold (a slice kept as a view of its full leaf
                # would hold the whole leaf)
                held = list(model.parameters())
                res[case, mesh_shape, "local"] = (
                    sum(p.numel() * p.element_size() for p in held),
                    sum({p.untyped_storage().data_ptr():
                         p.untyped_storage().nbytes()
                         for p in held}.values()))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


# -- repro ----------------------------------------------------------------------

_DROPS_PATCH = """
import jax, jax.numpy as jnp
from repro.models import layers as _L
_drops = []
_orig = _L._dispatch_ffn
def _counted(xf, gate, exp_ids, wgate, wi, wdown, cap):
    e_loc = wgate.shape[0]
    flat = exp_ids.reshape(-1)
    mine = (flat >= 0) & (flat < e_loc)
    counts = jnp.bincount(jnp.where(mine, flat, e_loc), length=e_loc + 1)
    over = jnp.maximum(counts[:e_loc] - cap, 0).sum()
    jax.debug.callback(lambda v: _drops.append(int(v)), over)
    return _orig(xf, gate, exp_ids, wgate, wi, wdown, cap)
_L._dispatch_ffn = _counted
"""

_GREEDY = """
import numpy as np
import jax, jax.numpy as jnp
from repro.models import transformer as T


def greedy(cfg, params, tokens, emb, steps):
    s = tokens.shape[1] + (emb["modal_embeds"].shape[1]
                           if "modal_embeds" in emb else 0)
    _drops.clear()
    prefill = jax.jit(lambda p, t, e: T.prefill(cfg, p, t,
                                                max_len=s + steps, **e))
    step = jax.jit(lambda p, c, t, pos: T.decode_step(cfg, p, c, t, pos))
    logits, cache, _ = prefill(params, jnp.asarray(tokens),
                               {k: jnp.asarray(v) for k, v in emb.items()})
    lg, ids = [np.asarray(logits)[:, -1]], []
    for i in range(steps + 1):
        tok = np.argmax(lg[-1], axis=-1)[:, None]
        ids.append(tok)
        if i < steps:
            logits, cache = step(params, cache, jnp.asarray(tok, jnp.int32),
                                 jnp.asarray(s + i, jnp.int32))
            lg.append(np.asarray(logits)[:, -1])
    jax.effects_barrier()
    return np.stack(lg), np.concatenate(ids, 1), sum(_drops)
"""

_MESH_SCRIPT = """
import pickle, sys
import repro
from repro.models import sharding
""" + _DROPS_PATCH + _GREEDY + """
cases = pickle.load(open(sys.argv[1], "rb"))
out = {}
for key, (cfg, params, tokens, emb, steps) in cases.items():
    mesh = jax.make_mesh(key[1], ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    sharding.set_mesh(mesh)
    with mesh:
        out[key] = greedy(cfg, params, tokens, emb, steps)
sharding.set_mesh(None)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


def _repro_inputs():
    """{case: (repro cfg, params as numpy, prompts, stub embeddings)}."""
    import jax

    from repro.models import transformer as T
    from repro.models.arch import get_arch

    sys.path.insert(0, os.path.dirname(__file__))
    import _lm_parity as lp

    out, drawn = {}, {}
    for case, (arch, repl, _, _) in CASES.items():
        jcfg = dataclasses.replace(get_arch(arch).reduced(), **repl)
        if jcfg not in drawn:
            drawn[jcfg] = jax.tree.map(np.asarray, T.init_params(
                jcfg, jax.random.key(0)))
        params = drawn[jcfg]
        tokens = lp.prompts(jcfg, B, S, seed=3)
        out[case] = (jcfg, params, tokens, lp.embeds(jcfg, B, S, seed=5))
    return out


def _repro_no_mesh(jcfg, params, tokens, emb):
    """``repro``'s greedy run without a mesh (its jnp attention route):
    (logits (steps + 1, B, V), ids, dropped assignments)."""
    from repro.models import layers as j_layers

    ns: dict = {}
    exec(_DROPS_PATCH + _GREEDY, ns)
    try:
        return ns["greedy"](jcfg, params, tokens, emb, STEPS)
    finally:
        j_layers._dispatch_ffn = ns["_orig"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{(case, mesh): (port run, reference run)} after checking that every
    rank returned the same results. The JAX-mesh subprocess, the spawned
    ranks and ``repro``'s mesh-less runs go on at once."""
    tmp = tmp_path_factory.mktemp("lm_mesh")
    inputs = _repro_inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({case: (dataclasses.asdict(jcfg), params, tokens, emb)
                     for case, (jcfg, params, tokens, emb)
                     in inputs.items()}, f)
    on_mesh = {(case, m): (jcfg, params, tokens, emb, STEPS)
               for case, (jcfg, params, tokens, emb) in inputs.items()
               for m in CASES[case][2] if _on_jax_mesh(case, m)}
    with open(tmp / "mesh_in.pkl", "wb") as f:
        pickle.dump(on_mesh, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = _MESH_SCRIPT
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script),
         str(tmp / "mesh_in.pkl"), str(tmp / "mesh_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = mp.start_processes(
        _rank_main, args=(4, str(tmp / "store"), str(tmp / "inputs.pkl"),
                          str(tmp)), nprocs=4, join=False, start_method="spawn")
    refs = {}
    for case, (jcfg, params, tokens, emb) in inputs.items():
        if any(not _on_jax_mesh(case, m) for m in CASES[case][2]):
            refs[case] = _repro_no_mesh(jcfg, params, tokens, emb)
    while not ctx.join():
        pass
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "mesh_out.pkl", "rb") as f:
        mesh_refs = pickle.load(f)
    res = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    for other in res[1:]:
        for key, val in res[0].items():
            if key[-1] != "local":      # ranks hold different shares
                np.testing.assert_array_equal(other[key][1], val[1])
                np.testing.assert_array_equal(other[key][0], val[0])
                assert other[key][2] == val[2], key
    got = {}
    for case, (_, _, meshes, _) in CASES.items():
        for m in meshes:
            want = mesh_refs[case, m] if _on_jax_mesh(case, m) \
                else refs[case]
            got[case, m] = (res[0][case, m], want,
                            res[0][case, m, "local"])
    return got


@pytest.mark.parametrize("case,mesh", [
    (case, m) for case, (_, _, meshes, _) in CASES.items() for m in meshes],
    ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_sharded_greedy_matches_repro(runs, case, mesh):
    (logits, ids, drops), (w_logits, w_ids, w_drops), (own, stored) = \
        runs[case, mesh]
    assert stored == own     # no rank keeps a full leaf behind a slice
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(logits, w_logits, rtol=0,
                               atol=ATOL.get(case, 1e-4))
    assert drops == w_drops
    if case in ("qwen2-moe", "llama4-scout") and mesh == (2, 2):
        assert drops > 0            # the capacity drops for real


def test_model_axis_holds_a_share_of_the_weights(runs):
    """Over (1, 4) a rank holds about a quarter of llama4-scout's bytes in
    its parameters' storages (the norms and the router are whole on
    every rank)."""
    (_, _, _), _, (_, stored) = runs["llama4-scout", (1, 4)]
    (_, _, _), _, (_, stored_d) = runs["llama4-scout", (4, 1)]
    assert stored < 0.3 * stored_d


# -- the rules and the layout choices -------------------------------------------

LEAVES = ("embed", "unembed", "wq", "wk", "wv", "wo", "wgate", "wi", "w_down",
          "router", "exp_wgate", "exp_wi", "exp_w_down", "in_proj",
          "out_proj", "conv_w", "conv_b", "a_log", "dt_bias", "ssm_d",
          "scale", "norm_scale", "pos_embed", "other")


#: the leaves where ``repro``'s first match is not the rule that names
#: them (the ``embed`` rule matches ``unembed`` and ``pos_embed``, the MLP's
#: the experts): the port lays them out by the named rule
NAMED_RULE = {"unembed": "unembed$", "pos_embed": "pos_embed$",
              "exp_wgate": r"exp_w(i|gate)$", "exp_wi": r"exp_w(i|gate)$",
              "exp_w_down": "exp_w_down$"}


def _first_match_rule(name):
    """``repro``'s lookup over the port's copy of the table: the first
    rule in table order that matches."""
    import re

    from repro_torch.models import sharding as t_sh

    return next((spec for pat, spec in t_sh._RULES if re.search(pat, name)),
                None)


@pytest.mark.parametrize("fsdp", [False, True])
def test_spec_rules_are_repros(fsdp, monkeypatch):
    """The port's copy of the rules table under ``repro``'s first-match
    lookup gives ``repro``'s specs (``spec_for``, ``param_specs``, the 2-D
    experts) for every leaf name, plain and scan-stacked; the port's own
    lookup (the most specific rule) differs only where the first match is
    not the rule that names the leaf (``unembed``, the experts)."""
    import re

    from repro.models import sharding as j_sh
    from repro_torch.models import sharding as t_sh

    shapes = {n: (16, 8, 4) if n.startswith("exp_") else (8, 4)
              for n in LEAVES}
    jparams = {n: np.zeros(s) for n, s in shapes.items()}
    own = {(n, ndim): t_sh.spec_for(f"blocks.l0.ff.{n}", ndim, fsdp=fsdp)
           for n in LEAVES for ndim in (1, 2, 3, 4)}
    own_params = {ed: t_sh.param_specs(shapes, fsdp=fsdp, expert_data=ed)
                  for ed in (False, True)}
    for name in NAMED_RULE:
        rule = dict(t_sh._RULES)[NAMED_RULE[name]]
        assert t_sh._rule(name) == rule and re.search(NAMED_RULE[name], name)
    monkeypatch.setattr(t_sh, "_rule", _first_match_rule)
    for name in LEAVES:
        for ndim in (1, 2, 3, 4):
            want = tuple(j_sh.spec_for(f"blocks/l0/ff/{name}", ndim,
                                       fsdp=fsdp))
            assert t_sh.spec_for(f"blocks.l0.ff.{name}", ndim,
                                 fsdp=fsdp) == want, (name, ndim)
            if name not in NAMED_RULE:
                assert own[name, ndim] == want, (name, ndim)
    for ed in (False, True):
        want = j_sh.param_specs(jparams, fsdp=fsdp, expert_data=ed)
        got = t_sh.param_specs(shapes, fsdp=fsdp, expert_data=ed)
        assert {n: tuple(s) for n, s in want.items()} == got
        assert {n: s for n, s in own_params[ed].items()
                if n not in NAMED_RULE or (ed and n in t_sh._EP2D_RULES)} \
            == {n: s for n, s in got.items()
                if n not in NAMED_RULE or (ed and n in t_sh._EP2D_RULES)}


def test_layout_choice_is_repros_rule():
    """``inference_layout`` at ``repro``'s 12e9 budget on a one-rank mesh:
    model-TP alone while the weights fit, FSDP beyond, ep2d for a MoE
    model; ``param_bytes`` are ``repro``'s params' bytes in
    bf16; ``auto_microbatches`` and ``batch_axes_for`` are ``repro``'s."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as jsteps
    from repro.launch.shapes import SHAPES
    from repro.models.arch import get_arch as j_get_arch
    from repro_torch import interop
    from repro_torch.launch import shapes as t_shapes
    from repro_torch.launch import steps as tsteps
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(1, 1, device="cpu")
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    want = {"stablelm-3b": {"fsdp": False, "ep2d": False},
            "granite-8b": {"fsdp": True, "ep2d": False},
            "llama4-scout-17b-a16e": {"fsdp": False, "ep2d": True}}
    for arch, layout in want.items():
        jcfg = j_get_arch(arch)
        cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
        jbytes = sum(int(np.prod(l.shape)) * l.dtype.itemsize
                     for l in jax.tree.leaves(
                         jsteps.params_specs_tree(jcfg, jnp.bfloat16)))
        assert tsteps.param_bytes(cfg, torch.bfloat16) == jbytes
        assert tsteps.inference_layout(cfg, mesh, dtype=torch.bfloat16,
                                       budget=12e9) == layout
        for name in ("train_4k", "prefill_32k"):
            s = SHAPES[name]
            assert tsteps.auto_microbatches(
                cfg, t_shapes.InputShape(s.name, s.kind, s.seq_len,
                                         s.global_batch), mesh) == \
                jsteps.auto_microbatches(jcfg, s, jmesh)
    for b in (1, 2, 8):
        assert tsteps.batch_axes_for(mesh, b) == \
            jsteps.batch_axes_for(jmesh, b)


class _Coords:
    """A (data, model) mesh's coordinates, without a process group."""

    mesh_dim_names = ("data", "model")

    def __init__(self, shape, rank):
        self.shape_, self.rank = shape, rank

    def size(self, i):
        return self.shape_[i]

    def get_local_rank(self, name):
        return {"data": self.rank // self.shape_[1],
                "model": self.rank % self.shape_[1]}[name]


def test_local_slice_tiles_as_jax_shards():
    """``local_slice``: each dim in equal contiguous blocks over its axes,
    several axes outermost first (``jax.sharding``'s tiling), each block a
    copy of its own; an axis that does not divide its dim is dropped.
    ``batch_axes`` and
    ``fsdp_axis`` are ``repro``'s."""
    from repro_torch.models import sharding as t_sh

    full = torch.arange(8 * 6).view(8, 6)
    for rank in range(4):
        mesh = _Coords((2, 2), rank)
        d, m = rank // 2, rank % 2
        assert torch.equal(t_sh.local_slice(full, ("data", "model"), mesh),
                           full[4 * d:4 * d + 4, 3 * m:3 * m + 3])
        assert torch.equal(t_sh.local_slice(full, (("data", "model"), None),
                                            mesh),
                           full[2 * rank:2 * rank + 2])
        # 6 columns over a 4-way (data, model): dropped, replicated
        assert torch.equal(t_sh.local_slice(full, (None, ("data", "model")),
                                            mesh), full)
        # a block is a copy: it keeps no view of the full leaf's storage
        block = t_sh.local_slice(full, ("model", None), mesh)
        assert block.untyped_storage().nbytes() == \
            block.numel() * block.element_size()
    mesh = _Coords((2, 2), 0)
    assert t_sh.batch_axes(mesh) == ("data",) and t_sh.fsdp_axis(mesh) == \
        "data"
    assert t_sh.batch_axes(None) is None and t_sh.fsdp_axis(None) is None


def test_cache_specs_are_the_ports_layout():
    """``cache_pspec`` over a model axis of 4: K/V heads over ``model``
    when it divides them, else each rank's kept heads ("model*"); the
    conv channels head-aligned ("model*"), the SSM heads over
    ``model``."""
    from repro_torch.launch.steps import cache_pspec
    from repro_torch.models import sharding as t_sh
    from repro_torch.models.arch import get_arch

    assert cache_pspec is t_sh.cache_pspec
    mesh = _Coords((1, 4), 0)
    granite = get_arch("granite-8b").reduced()
    jamba = get_arch("jamba-1.5-large-398b").reduced()
    kv = (2, 16, granite.n_kv_heads, granite.hd)
    assert cache_pspec("k", kv, granite, mesh, ("data",)) == \
        (("data",), None, "model", None)
    kv2 = dataclasses.replace(granite, n_kv_heads=2)
    assert cache_pspec("v", (2, 16, 2, kv2.hd), kv2, mesh, None) == \
        (None, None, "model*", None)
    assert cache_pspec("conv", (2, 3, 1), jamba, mesh, None)[2] == "model*"
    assert cache_pspec("ssm", (2, jamba.ssm_heads, 32, 32), jamba, mesh,
                       None) == (None, "model", None, None)
    one = _Coords((1, 1), 0)
    assert cache_pspec("k", kv, granite, one, None) == (None,) * 4
