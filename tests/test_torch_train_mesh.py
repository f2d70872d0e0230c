"""LM training on a mesh: the port's sharded train step, trainer,
checkpoints and CLIs on 4 gloo ranks, held to ``repro``.

One ``torch.multiprocessing.spawn`` of 4 ranks (a ``FileStore``, one
torch thread a rank) runs every case:

* 3 steps of ``steps.make_train_step`` on a model built with a mesh
  (FSDP over ``data``, tensor / expert parallel over ``model``, each
  data rank on its rows of ``repro``'s ``TokenStream`` batches) over
  (4, 1), (2, 2) and (1, 4), from ``repro``'s params: held to ``repro``'s
  3 steps without a mesh by ``tests/test_torch_train.py``'s tolerances
  (loss and grad norm ``rtol=2e-6``, the learning rate exactly,
  parameters ``atol=5e-6``, moments ``rtol=1e-4`` and ``1e-4`` of each
  leaf's largest). The GQA config has 2 K/V heads, so over (1, 4) two
  ranks share each K/V head and its gradient is summed over them;
  reduced qwen2-moe takes one step expert-parallel over (1, 4), held as
  ``tests/_lm_parity.py``'s ``train_step_parity`` holds the MoE's step
  (the gradients within ``rtol=1e-5`` and ``2e-5`` of each leaf's
  largest, the parameters within ``5e-6`` plus what the gradients'
  difference moves AdamW's first update by near a zero gradient);
* the trainer on (2, 2): a run preempted after its step-2 checkpoint and
  resumed equals the straight run bit for bit; the checkpoint (full
  leaves, rank 0 writes) loads onto (4, 1) and (1, 4) and gathers back
  to the saved leaves exactly;
* ``launch.train.main`` and ``launch.serve.main`` with ``--data-par 2
  --model-par 2`` (rank 0 prints; the served ids equal the mesh-less
  run's), and ``repro``'s refusal of a mesh larger than the world.

``repro`` and JAX are imported inside the tests only: the spawned ranks
import this module.
"""
import contextlib
import dataclasses
import io
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MESHES = ((4, 1), (2, 2), (1, 4))
B, S, LR = 4, 32, 1e-3
#: case -> (repro arch or None for GQA, replaced fields, meshes, steps)
CASES = {"stablelm-3b": ("stablelm-3b", {}, MESHES, 3),
         "gqa": (None, {}, ((1, 4), (2, 2)), 3),
         "qwen2-moe": ("qwen2-moe-a2.7b", {}, ((1, 4),), 1)}
#: AdamW's eps (``tests/_lm_parity.py``)
ADAM_EPS = 1e-8
SERVE = ["--arch", "granite-8b", "--reduced", "--device", "cpu", "--batch",
         "4", "--prompt-len", "16", "--gen", "5"]
TRAIN_KW = dict(reduced=True, steps=4, batch=4, seq=32, lr=LR, warmup=1,
                device="cpu", log_every=100)


class _Preempted(Exception):
    pass


def _jcfg(case):
    from repro.models.arch import ArchConfig, LayerSpec, get_arch

    arch, repl, _, _ = CASES[case]
    if arch is None:
        return ArchConfig(name="gqa-train", family="dense", n_layers=2,
                          d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                          vocab=500, head_dim=16,
                          pattern=(LayerSpec(mixer="attn", ff="mlp"),),
                          rope_theta=1e4)
    return dataclasses.replace(get_arch(arch).reduced(), **repl)


# -- the port on 4 ranks -------------------------------------------------------

def _train_steps(fields, params, mesh, n_steps):
    """``n_steps`` sharded steps: (per-step metrics, full params, full
    moments, step count, the first step's clipped gradients, full)."""
    from repro_torch import interop
    from repro_torch import optim as to
    from repro_torch.data import TokenStream
    from repro_torch.launch import shapes, steps

    cfg = interop.arch_from_fields(fields)
    model = interop.lm_params_from_numpy(cfg, params, device="cpu",
                                         mesh=mesh, fsdp=True)
    model.requires_grad_(True)
    opt = to.AdamW(model.parameters())
    step = steps.make_train_step(
        cfg, shapes.InputShape("cli", "train", S, B),
        to.linear_warmup_cosine(LR, 1 if n_steps > 1 else 0, max(n_steps, 2)))
    stream = TokenStream(vocab=cfg.vocab, seq_len=S, global_batch=B, seed=0)
    names = [n for n, _ in model.named_parameters()]
    captured, real_step = [], opt.step

    def capture(lr, grads):
        if not captured:
            captured.append(interop.lm_tree_from_named(cfg, model.full_named(
                {n: g.detach().clone() for n, g in zip(names, grads)})))
        return real_step(lr, grads)

    opt.step = capture
    metrics = []
    for i in range(n_steps):
        nb = stream.batch(i)
        batch = {k: torch.from_numpy(v).to(
            torch.int64 if v.dtype == np.int32 else torch.float32)
            for k, v in nb.items()}
        metrics.append({k: float(v) for k, v in
                        step(model, opt, batch).items()})
    named = list(model.named_parameters())
    moments = {m: interop.lm_tree_from_named(cfg, model.full_named(t))
               for m, t in opt.state_tree(named)["moments"].items()}
    return metrics, interop.lm_params_to_numpy(model), moments, \
        opt.step_count, captured[0]


def _resume_and_move(tmp):
    """The trainer on (2, 2): straight vs preempted + resumed, then the
    step-2 checkpoint loaded onto (4, 1) and (1, 4)."""
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.arch import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim import AdamW

    out = {}
    mesh = make_host_mesh(2, 2, device="cpu")
    straight = ttrain.train("stablelm-3b", mesh=mesh, **TRAIN_KW)

    def preempt(step, *_):
        if step == 1:
            raise _Preempted

    ckpt = os.path.join(tmp, "ckpt")
    with contextlib.suppress(_Preempted):
        ttrain.train("stablelm-3b", mesh=mesh, ckpt_dir=ckpt, ckpt_every=2,
                     on_step=preempt, **TRAIN_KW)
    resumed = ttrain.train("stablelm-3b", mesh=mesh, ckpt_dir=ckpt,
                           ckpt_every=2, **TRAIN_KW)
    out["resume"] = (resumed.start, resumed.losses, straight.losses[2:],
                     resumed.optimizer.step_count,
                     straight.optimizer.step_count)
    pa = list(straight.model.named_parameters())
    pb = list(resumed.model.named_parameters())
    ma = straight.optimizer.state_tree(pa)["moments"]
    mb = resumed.optimizer.state_tree(pb)["moments"]
    out["resume_equal"] = all(torch.equal(a, b) for (_, a), (_, b)
                              in zip(pa, pb)) and all(
        torch.equal(ma[m][n], mb[m][n]) for m in ma for n in ma[m])
    cfg = get_arch("stablelm-3b").reduced()
    for shape in ((4, 1), (1, 4)):
        other = make_host_mesh(*shape, device="cpu")
        model = Transformer(cfg, device="cpu", mesh=other, fsdp=True)
        opt = AdamW(model.parameters())
        ttrain.restore(model, opt, ckpt, 2)
        named = list(model.named_parameters())
        full = {"params": model.full_named(dict(named)),
                "opt": {m: model.full_named(t) for m, t in
                        opt.state_tree(named)["moments"].items()}}
        out["moved", shape] = (
            {k: v.numpy() for k, v in full["params"].items()},
            {m: {k: v.numpy() for k, v in t.items()}
             for m, t in full["opt"].items()}, opt.step_count)
    return out


def _clis():
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain

    out = {}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tserve.main(SERVE + ["--data-par", "2", "--model-par", "2"])
        tres = ttrain.main(["--arch", "stablelm-3b", "--reduced", "--device",
                            "cpu", "--steps", "2", "--batch", "4", "--seq",
                            "32", "--log-every", "1", "--data-par", "2",
                            "--model-par", "2"])
    out["serve"] = (res.ids.numpy(), res.logits_finite)
    out["train"] = tres.losses
    out["stdout"] = buf.getvalue()
    for argv in (SERVE + ["--data-par", "4", "--model-par", "2"],):
        try:
            tserve.main(argv)
        except ValueError as e:
            out["refused"] = str(e)
    try:
        ttrain.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                     "--data-par", "8"])
    except ValueError as e:
        out["train_refused"] = str(e)
    return out


def _rank_main(rank, world, store, inputs, out_dir):
    from repro_torch.launch.mesh import init_rank, make_host_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")
    with open(inputs, "rb") as f:
        data = pickle.load(f)
    res = {}
    for case, (fields, params) in data.items():
        for shape in CASES[case][2]:
            res[case, shape] = _train_steps(
                fields, params, make_host_mesh(*shape, device="cpu"),
                CASES[case][3])
    res.update(_resume_and_move(out_dir))
    res.update(_clis())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


# -- repro ----------------------------------------------------------------------

def _repro_steps(jcfg, n_steps):
    """``repro``'s ``n_steps`` steps without a mesh: (params0, per-step
    metrics, params, OptState, the first step's gradient)."""
    import jax
    import jax.numpy as jnp

    from repro import optim as jo
    from repro.data.tokens import TokenStream
    from repro.launch import steps as jsteps
    from repro.launch.shapes import InputShape
    from repro.models import transformer as T

    params0 = T.init_params(jcfg, jax.random.key(0))
    jopt = jo.adamw()
    state = jopt.init(params0)
    step = jax.jit(jsteps.make_train_step(
        jcfg, InputShape("cli", "train", S, B), jopt,
        jo.linear_warmup_cosine(LR, 1 if n_steps > 1 else 0,
                                max(n_steps, 2))))

    def batch(i):
        nb = TokenStream(vocab=jcfg.vocab, seq_len=S, global_batch=B,
                         seed=0).batch(i)
        return {k: jnp.asarray(v) for k, v in nb.items()}

    def loss(p, b):
        h, aux = T.forward(jcfg, p, b["tokens"])
        return T.lm_loss(jcfg, p, h, b["labels"], b["mask"]) \
            + jsteps.MOE_AUX_WEIGHT * aux

    grad = jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(params0,
                                                            batch(0)))
    params, metrics = params0, []
    for i in range(n_steps):
        params, state, m = step(params, state, batch(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return (jax.tree.map(np.asarray, params0), metrics,
            jax.tree.map(np.asarray, params), state, grad)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, {case: repro's run}), after checking that every
    rank returned the same metrics."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    refs = {case: _repro_steps(_jcfg(case), CASES[case][3])
            for case in CASES}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({case: (dataclasses.asdict(_jcfg(case)), refs[case][0])
                     for case in CASES}, f)
    mp.spawn(_rank_main, args=(4, str(tmp / "store"), str(tmp / "inputs.pkl"),
                               str(tmp)), nprocs=4)
    res = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    for other in res[1:]:
        for case in CASES:
            for shape in CASES[case][2]:
                assert other[case, shape][0] == res[0][case, shape][0]
        assert other["resume"] == res[0]["resume"]
        assert other["stdout"] == ""           # only rank 0 prints
    res[0]["ckpt"] = str(tmp / "ckpt")
    return res[0], refs


def _close_tree(got, want, rtol, atol_frac=0.0, atol=0.0):
    import jax

    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol + atol_frac * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))


def _close_after_one_step(got, want, tgrad, jgrad, gnorm):
    """``train_step_parity``'s bound: the step's gradients, and the
    parameters within 5e-6 plus what the clipped gradients' difference
    dg moves AdamW's first update lr * g / (|g| + eps) by."""
    import jax

    scale = min(1.0, 1.0 / gnorm)
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g, jg, tg in zip(flat, jax.tree.leaves(got),
                                    jax.tree.leaves(jgrad),
                                    jax.tree.leaves(tgrad)):
        what = jax.tree_util.keystr(path)
        tg = tg / scale
        np.testing.assert_allclose(tg, jg, rtol=1e-5,
                                   atol=2e-5 * float(np.abs(jg).max()),
                                   err_msg=f"gradient {what}")
        ga, gb = np.abs(jg) * scale, np.abs(tg) * scale
        dg = np.abs(jg - tg) * scale
        moved = LR * ADAM_EPS * dg / (np.minimum(ga, gb) + ADAM_EPS) ** 2
        err = np.abs(g - np.asarray(w))
        bound = 5e-6 + np.minimum(moved, 2 * LR)
        assert (err <= bound).all(), (what, float((err - bound).max()))


@pytest.mark.parametrize("case,shape", [
    (case, m) for case, (_, _, meshes, _) in CASES.items() for m in meshes],
    ids=lambda v: v if isinstance(v, str) else "x".join(map(str, v)))
def test_sharded_steps_match_repro(runs, case, shape):
    got, refs = runs
    metrics, params, moments, count, tgrad = got[case, shape]
    _, jms, jparams, jstate, jgrad = refs[case]
    for t, j in zip(metrics, jms):
        assert t["lr"] == j["lr"]
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-6)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=2e-6)
        np.testing.assert_allclose(t["moe_aux"], j["moe_aux"], rtol=2e-6)
    assert count == int(jstate.step) == CASES[case][3]
    if count == 1:
        _close_after_one_step(params, jparams, tgrad, jgrad,
                              jms[0]["grad_norm"])
        return
    _close_tree(params, jparams, rtol=0, atol=5e-6)
    for m in ("mu", "nu"):
        _close_tree(moments[m], jstate.moments[m], rtol=1e-4,
                    atol_frac=1e-4)


def test_resume_on_a_mesh_is_bit_identical(runs):
    got, _ = runs
    start, resumed, straight, count_r, count_s = got["resume"]
    assert start == 2 and resumed == straight and count_r == count_s == 4
    assert got["resume_equal"]


@pytest.mark.parametrize("shape", [(4, 1), (1, 4)],
                         ids=lambda v: "x".join(map(str, v)))
def test_checkpoint_moves_between_meshes(runs, shape):
    """Saved on (2, 2), loaded on another mesh: the gathered leaves are
    the saved ones, bit for bit."""
    import json

    got, _ = runs
    params, moments, count = got["moved", shape]
    z = np.load(os.path.join(got["ckpt"], "step_00000002.npz"))
    meta = json.loads(bytes(z["__meta__"]).decode())
    saved = {rec["key"]: z[f"leaf_{i}"]
             for i, rec in enumerate(meta["leaves"])}
    assert count == int(saved["opt/step"]) == 2
    for name, a in params.items():
        np.testing.assert_array_equal(a, saved[f"params/{name}"])
    for m, tree in moments.items():
        for name, a in tree.items():
            np.testing.assert_array_equal(a, saved[f"opt/moments/{m}/{name}"])


def test_clis_run_on_a_mesh(runs):
    got, _ = runs
    from repro_torch.launch import serve as tserve

    with contextlib.redirect_stdout(io.StringIO()):
        alone = tserve.main(SERVE)
    ids, finite = got["serve"]
    np.testing.assert_array_equal(ids, alone.ids.numpy())
    assert finite
    assert "mesh=(2, 2)" in got["stdout"] and "step     2 loss" in \
        got["stdout"]
    assert all(np.isfinite(got["train"]))
    assert "requested 4x2 mesh on 4 devices" in got["refused"]
    assert "requested 8x1 mesh on 4 devices" in got["train_refused"]
