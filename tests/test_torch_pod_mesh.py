"""The pod axis: the port's LM on 8 gloo ranks over ``("pod", "data",
"model")`` = (2, 2, 2), built through ``launch/mesh.py::_mesh`` (the
axes of ``make_production_mesh(multi_pod=True)``), held to ``repro``.

One ``torch.multiprocessing.spawn`` of 8 ranks (a ``FileStore``, one
torch thread a rank) runs every case; ``repro`` runs at the same time in
one subprocess on 8 forced devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``) over a JAX mesh
(the pod mesh's axes, or for the MoE (4, 2) ``("data", "model")``: the
same four batch shards). The batch is sharded over (pod, data), so every
case crosses ``batch_axes_for``'s ``("pod", "data")`` branch and
``LMShard``'s pod group:

* reduced granite-8b and qwen2-moe serving (a prefill and 8 greedy
  decode steps): ids and dropped assignments equal ``repro``'s on the
  JAX mesh (the MoE's capacity is per batch shard on both), logits
  within ``tests/test_torch_lm_mesh.py``'s 1e-4. ``repro``'s own pod
  mesh runs each expert twice over (it all-gathers the experts' d_ff
  over (pod, data) where they are stored over data alone), so the MoE's
  reference is ``repro`` over (4, 2);
* reduced qwen2-moe laid out 2-D (ep2d; capacity 64, so nothing drops
  and the sharded math is ``repro``'s global math): its decode steps run
  ``_moe_ep2d``, whose partial sums are all-reduced over model, data and
  pod; held to ``repro`` without a mesh likewise;
* one train step of reduced stablelm-3b, FSDP over ``data`` (its
  gradients reduce-scattered over data, then summed over pod), held to
  ``repro``'s step without a mesh by ``tests/_lm_parity.py``'s
  ``train_step_parity`` bounds.

``repro`` and JAX are imported inside the tests only: the spawned ranks
import this module.
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

from test_torch_lm_mesh import _DROPS_PATCH, _GREEDY, _greedy
from test_torch_train_mesh import (_close_after_one_step, _repro_steps,
                                   _train_steps)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
POD = ((2, 2, 2), ("pod", "data", "model"))
B, S, STEPS = 8, 16, 8
#: case -> (arch, replaced fields, Transformer layout, the JAX mesh of
#: ``repro``'s reference (None: without a mesh))
CASES = {"granite": ("granite-8b", {}, {}, POD),
         # repro's pod mesh gathers each expert's d_ff over (pod, data)
         # where its weights are stored over data alone, so each expert
         # runs twice over (repro/models/layers.py:510-517; ROADMAP §3):
         # its reference is (4, 2), the same four batch shards
         "qwen2-moe": ("qwen2-moe-a2.7b", {}, {},
                       ((4, 2), ("data", "model"))),
         "qwen2-moe-ep2d": ("qwen2-moe-a2.7b", {"moe_capacity_factor": 64.0},
                            {"ep2d": True}, None)}
TRAIN = "stablelm-3b"


def _rank_main(rank, world, store, inputs, out_dir):
    from repro_torch import interop
    from repro_torch.launch.mesh import _mesh, init_rank

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")
    with open(inputs, "rb") as f:
        data, train = pickle.load(f)
    mesh = _mesh("cpu", *POD)
    res = {}
    with torch.no_grad():
        for case, (fields, params, tokens) in data.items():
            model = interop.lm_params_from_numpy(
                interop.arch_from_fields(fields), params, device="cpu",
                mesh=mesh, **CASES[case][2])
            assert model.batch_shard(B).axes == ("pod", "data")
            moe = [blk.ff for blk in model.layers if blk.spec.ff == "moe"]
            res[case, "branches"] = sorted({m._branch(d) for m in moe
                                            for d in (False, True)})
            res[case] = _greedy(model, tokens, {}, STEPS)
    # the train step reads its batch from repro's TokenStream, seq 32
    res["train"] = _train_steps(*train, mesh, 1)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


_POD_SCRIPT = """
import pickle, sys
import repro
from repro.models import sharding
""" + _DROPS_PATCH + _GREEDY + """
out = {}
for case, (cfg, params, tokens, steps, (shape, axes)) in pickle.load(
        open(sys.argv[1], "rb")).items():
    mesh = jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    sharding.set_mesh(mesh)
    with mesh:
        out[case] = greedy(cfg, params, tokens, {}, steps)
sharding.set_mesh(None)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: (port run, reference run)}, the port's train step,
    ``repro``'s train step), after checking that every rank returned the
    same results. The JAX subprocess and the ranks run at once."""
    import jax

    sys.path.insert(0, os.path.dirname(__file__))
    import _lm_parity as lp
    from test_torch_lm_mesh import _repro_no_mesh
    from test_torch_train_mesh import _jcfg

    from repro.models import transformer as T
    from repro.models.arch import get_arch

    tmp = tmp_path_factory.mktemp("pod_mesh")
    inputs, drawn = {}, {}
    for case, (arch, repl, _, _) in CASES.items():
        jcfg = dataclasses.replace(get_arch(arch).reduced(), **repl)
        if arch not in drawn:
            drawn[arch] = jax.tree.map(np.asarray, T.init_params(
                jcfg, jax.random.key(0)))
        inputs[case] = (jcfg, drawn[arch], lp.prompts(jcfg, B, S, seed=3))
    jtrain = _jcfg("stablelm-3b")
    train_ref = _repro_steps(jtrain, 1)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(({case: (dataclasses.asdict(j), p, t)
                      for case, (j, p, t) in inputs.items()},
                     (dataclasses.asdict(jtrain), train_ref[0])), f)
    with open(tmp / "mesh_in.pkl", "wb") as f:
        pickle.dump({case: (j, p, t, STEPS, CASES[case][3])
                     for case, (j, p, t) in inputs.items()
                     if CASES[case][3]}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_POD_SCRIPT),
         str(tmp / "mesh_in.pkl"), str(tmp / "mesh_out.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    ctx = mp.start_processes(
        _rank_main, args=(8, str(tmp / "store"), str(tmp / "inputs.pkl"),
                          str(tmp)), nprocs=8, join=False,
        start_method="spawn")
    refs = {case: _repro_no_mesh(j, p, t, {})
            for case, (j, p, t) in inputs.items() if not CASES[case][3]}
    while not ctx.join():
        pass
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "mesh_out.pkl", "rb") as f:
        refs.update(pickle.load(f))
    res = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(8)]
    for other in res[1:]:
        for case in CASES:
            for a, b in zip(other[case], res[0][case]):
                np.testing.assert_array_equal(a, b)
        assert other["train"][0] == res[0]["train"][0]
    return ({case: (res[0][case], refs[case], res[0][case, "branches"])
             for case in CASES}, res[0]["train"], train_ref)


@pytest.mark.parametrize("case", list(CASES))
def test_pod_mesh_serving_matches_repro(runs, case):
    (logits, ids, drops), (w_logits, w_ids, w_drops), branches = \
        runs[0][case]
    np.testing.assert_array_equal(ids, w_ids)
    np.testing.assert_allclose(logits, w_logits, rtol=0, atol=1e-4)
    assert drops == w_drops
    if case == "qwen2-moe":
        assert drops > 0 and branches == ["ep"]    # capacity per shard
    if case == "qwen2-moe-ep2d":
        assert branches == ["ep", "ep2d"]          # decode: the pod reduce


def test_pod_mesh_train_step_matches_repro(runs):
    _, (metrics, params, _, count, tgrad), refs = runs
    _, jms, jparams, jstate, jgrad = refs
    (t,), (j,) = metrics, jms
    assert t["lr"] == j["lr"] and count == int(jstate.step) == 1
    for k in ("loss", "grad_norm", "moe_aux"):
        np.testing.assert_allclose(t[k], j[k], rtol=2e-6, err_msg=k)
    _close_after_one_step(params, jparams, tgrad, jgrad, j["grad_norm"])
