"""The port's wire runtime (``repro_torch.core.distributed``: ``WirePlan``,
``build_weights_fn``, ``distributed_weights``,
``distributed_learn_structure``) on 4 gloo ranks of a (2, 2) mesh
against ``repro`` on a (1, 1) JAX mesh, on the inputs of ``repro``'s own
mesh tests (``tests/test_distributed.py``: d = 16, n = 4096;
``tests/test_path.py``: the path runtime at d = 8, n = 1024).

Tolerances: sign weights at the sign tolerance (``ROADMAP.md`` §3); the
f32-valued weights (R3, R2 packed, ``original``: their Gram is summed
over the data axis in another order than XLA's) at ``rtol=1e-5,
atol=1e-6`` off the diagonal, which the MWST never reads, and at
``rtol=5e-5`` on it (the per-symbol transform near rho^2 = 1 multiplies a
Gram's rounding by 1/(1 - rho^2) ~ 30); glasso precisions at 1e-2 (the
solvers' f32 plateaus, as ``tests/test_torch_path.py``). Edges are
equal. The (2, 2) ranks are held to the port's own (1, 1) mesh bit for
bit on the integer (sign) paths, and every rank returns the same tensor.
``repro`` and JAX are imported inside the tests only: the spawned ranks
import this module.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import distributed as td
from repro_torch.core.path import PathPlan
from repro_torch.core.strategy import Strategy
from repro_torch.data.ggm import GGMDataset, ggm_batches, vertical_sharding

SIGN_TOL = dict(rtol=1e-6, atol=2.5e-7)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
F32_DIAG_RTOL = 5e-5
THETA_TOL = 1e-2

#: case -> (input, distributed_weights kwargs): loose kwargs as
#: test_distributed.py:25 and :247 pass them, Strategy fields as :289 and
#: test_path.py:393
CASES = {
    "sign-replicated": ("tree", dict(method="sign", rate=3,
                                     compute="replicated")),
    "sign-rowblock": ("tree", dict(method="sign", rate=3,
                                   compute="rowblock")),
    "R3-replicated": ("tree", dict(method="persymbol", rate=3,
                                   compute="replicated")),
    "R3-rowblock": ("tree", dict(method="persymbol", rate=3,
                                 compute="rowblock")),
    "sign-packed": ("tree", dict(method="sign", wire="packed")),
    "original": ("tree", dict(wire="float32")),
    "original-rowblock": ("tree", dict(wire="float32", compute="rowblock")),
    "packed-sign-replicated": ("tree", dict(strategy=dict(
        method="sign", rate=2, wire="packed", placement="replicated"))),
    "packed-sign-rowblock": ("tree", dict(strategy=dict(
        method="sign", rate=2, wire="packed", placement="rowblock"))),
    "packed-R2-replicated": ("tree", dict(strategy=dict(
        method="persymbol", rate=2, wire="packed", placement="replicated"))),
    "packed-R2-rowblock": ("tree", dict(strategy=dict(
        method="persymbol", rate=2, wire="packed", placement="rowblock"))),
    "sparse-replicated": ("sparse", dict(strategy=dict(
        method="sign", structure="sparse", lam=0.1))),
    "sparse-rowblock": ("sparse", dict(strategy=dict(
        method="sign", structure="sparse", lam=0.1, placement="rowblock"))),
    "path-replicated": ("sparse", dict(path=dict(
        n_lams=6, lam_min_ratio=0.05), strategy=dict(
        method="sign", structure="sparse", lam=0.1))),
    "path-rowblock": ("sparse", dict(path=dict(
        n_lams=6, lam_min_ratio=0.05), strategy=dict(
        method="sign", structure="sparse", lam=0.1, placement="rowblock"))),
}
#: cases whose statistic is an integer Gram: bit-identical across meshes
INTEGER = tuple(c for c in CASES if "sign" in c or c.startswith(
    ("sparse", "path")))


def _kwargs(spec: dict, strategy_cls, path_cls) -> dict:
    kw = dict(spec)
    if "strategy" in kw:
        kw["strategy"] = strategy_cls(**kw["strategy"])
    if "path" in kw:
        kw["path"] = path_cls(**kw["path"])
    return kw


def _port_cases(mesh, inputs: dict) -> dict:
    out = {}
    for name, (which, spec) in CASES.items():
        kw = _kwargs(spec, Strategy, PathPlan)
        x = torch.from_numpy(inputs[which].copy())
        out[name] = (td.distributed_weights(x, mesh, **kw).numpy(),
                     td.distributed_learn_structure(x, mesh, **kw))
    return out


def _blocks(mesh) -> dict:
    """This rank's blocks of a GGM batch and of two streamed batches."""
    ds = GGMDataset(d=16, seed=3)
    shard = vertical_sharding(mesh)
    stream = ggm_batches(ds, 64, mesh, start=5, device="cpu")
    return {"sample": shard(ds.sample(64, device="cpu")).numpy(),
            "stream": [next(stream).numpy() for _ in range(2)],
            "coord": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model"))}


def _rank_main(rank, world, store, out_dir):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import init_rank, make_host_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")
    inputs = dict(np.load(os.path.join(out_dir, "inputs.npz")))
    mesh = make_host_mesh(2, 2, device="cpu")
    res = {"cases": _port_cases(mesh, inputs), "blocks": _blocks(mesh)}
    pod = DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2),
                     mesh_dim_names=("pod", "data", "model"))
    res["pod"] = (vertical_sharding(pod)(torch.from_numpy(inputs["tree"]))
                  .numpy(), pod.get_local_rank("pod"),
                  pod.get_local_rank("model"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def _inputs() -> dict:
    """test_distributed.py:25's tree samples and test_path.py:393's sparse
    samples, made by ``repro``."""
    import jax

    import repro.core as core
    from repro.core import glasso

    rng = np.random.default_rng(0)
    d, n = 16, 4096
    edges = core.random_tree(d, rng)
    w = rng.uniform(0.4, 0.9, d - 1)
    tree = np.asarray(core.sampler.sample_tree_ggm(jax.random.key(0), n, d,
                                                   edges, w))
    rng = np.random.default_rng(2)
    theta = glasso.random_sparse_precision(8, density=0.25, rng=rng)
    L = np.linalg.cholesky(np.linalg.inv(theta))
    sparse = (rng.normal(size=(1024, 8)) @ L.T).astype(np.float32)
    return {"tree": tree, "sparse": sparse, "edges": np.asarray(edges)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [results of each (2, 2) rank], the port's (1, 1) results,
    repro's (1, 1) (weights, edges) by case)."""
    import jax
    import jax.numpy as jnp

    from repro.core import chow_liu, glasso
    from repro.core import distributed as jd
    from repro.core.path import PathPlan as JPath
    from repro.core.strategy import Strategy as JStrategy
    from repro_torch.launch.mesh import make_host_mesh

    inputs = _inputs()
    tmp = tmp_path_factory.mktemp("distributed")
    np.savez(tmp / "inputs.npz", **inputs)
    mp.spawn(_rank_main, args=(4, str(tmp / "store"), str(tmp)), nprocs=4)
    ranks = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    one = _port_cases(make_host_mesh(1, 1, device="cpu"), inputs)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = {}
    for name, (which, spec) in CASES.items():
        kw = _kwargs(spec, JStrategy, JPath)
        w = jd.distributed_weights(jnp.asarray(inputs[which]), jmesh, **kw)
        # repro's distributed_learn_structure on these weights (each call
        # of it compiles the weights anew)
        adj = (glasso.support(w) if which == "sparse"
               else chow_liu.boruvka_mst(w))
        ref[name] = (np.asarray(w), chow_liu.adjacency_to_edges(adj))
    return inputs, ranks, one, ref


@pytest.mark.parametrize("case", sorted(CASES))
def test_distributed_weights_match_repro(runs, case):
    _, ranks, one, ref = runs
    got, edges = ranks[0]["cases"][case]
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["cases"][case][0], got)
        assert other["cases"][case][1] == edges
    want, want_edges = ref[case]
    assert edges == want_edges == one[case][1]
    if case in INTEGER:
        np.testing.assert_array_equal(got, one[case][0])
    if CASES[case][0] == "sparse":
        np.testing.assert_allclose(got, want, atol=THETA_TOL)
    elif case.startswith(("sign", "packed-sign")):
        np.testing.assert_allclose(got, want, **SIGN_TOL)
    else:
        off = ~np.eye(got.shape[0], dtype=bool)
        np.testing.assert_allclose(got[off], want[off], **F32_TOL)
        np.testing.assert_allclose(np.diag(got), np.diag(want),
                                   rtol=F32_DIAG_RTOL)


def test_distributed_learn_structure_recovers_the_tree(runs):
    """test_distributed.py:25's claim: every tree case recovers the
    generating tree."""
    from repro_torch.core.trees import tree_edit_distance

    inputs, ranks, _, _ = runs
    truth = [tuple(e) for e in inputs["edges"]]
    for name, (which, _) in CASES.items():
        if which == "tree":
            assert tree_edit_distance(truth, ranks[0]["cases"][name][1]) == 0


def test_vertical_sharding_blocks_make_the_batch(runs):
    """The blocks of a (2, 2) mesh's ranks, placed at their (data, model)
    coordinates, are the mesh-less batch bit for bit (one draw and two
    streamed ones); a ("pod", "data", "model") mesh splits rows over pod
    and data, pod major."""
    inputs, ranks, _, _ = runs
    ds = GGMDataset(d=16, seed=3)
    stream = ggm_batches(ds, 64, start=5, device="cpu")
    whole = {"sample": ds.sample(64, device="cpu").numpy(),
             "stream": [next(stream).numpy() for _ in range(2)]}

    def place(get):
        grid = [[None, None], [None, None]]
        for r in ranks:
            i, m = r["blocks"]["coord"]
            grid[i][m] = get(r["blocks"])
        return np.block(grid)

    np.testing.assert_array_equal(place(lambda b: b["sample"]),
                                  whole["sample"])
    for k in range(2):
        np.testing.assert_array_equal(place(lambda b: b["stream"][k]),
                                      whole["stream"][k])
    grid = [[None, None], [None, None]]
    for r in ranks:
        block, pod, m = r["pod"]
        grid[pod][m] = block
    np.testing.assert_array_equal(np.block(grid), inputs["tree"])


def test_comm_report_is_repros():
    """``WirePlan.comm_report`` equals ``repro``'s field for field, on
    test_distributed.py:213's wires, rowblock, a padded bucket and the MAC
    and budget ledgers."""
    from repro.comm.channel import BudgetChannel as JBudget
    from repro.comm.channel import MACChannel as JMAC
    from repro.core.distributed import WirePlan as JWirePlan
    from repro.core.strategy import Strategy as JStrategy
    from repro_torch.comm.channel import BudgetChannel, MACChannel

    fields = [dict(method="sign"), dict(method="sign", wire="packed"),
              dict(method="persymbol", rate=4),
              dict(method="persymbol", rate=4, wire="packed"),
              dict(method="persymbol", rate=2, wire="packed"),
              dict(method="original"), dict(method="sign",
                                            placement="rowblock")]
    pairs = [(JStrategy(**f), Strategy(**f)) for f in fields]
    pairs.append((JStrategy(channel=JMAC(4)), Strategy(channel=MACChannel(4))))
    pairs.append((JStrategy("persymbol", rate=4, channel=JBudget(
        budget_bits=6 * 256 * 12, machines=4)), Strategy(
        "persymbol", rate=4, channel=BudgetChannel(
            budget_bits=6 * 256 * 12, machines=4))))
    for js, ts in pairs:
        for n, n_pad in ((256, None), (100, 128)):
            want = JWirePlan(js).comm_report(n, 12, n_pad=n_pad)
            got = td.WirePlan(ts).comm_report(n, 12, n_pad=n_pad)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (
                ts, n)


def test_wire_runtime_refusals_are_repros():
    """build_weights_fn refuses MAC/budget strategies and a path on a tree
    strategy with ``repro``'s texts; a communicating stage without a mesh
    says so."""
    import jax

    from repro.comm.channel import MACChannel as JMAC
    from repro.core import chow_liu, glasso
    from repro.core import distributed as jd
    from repro.core.path import PathPlan as JPath
    from repro.core.strategy import Strategy as JStrategy
    from repro_torch.comm.channel import MACChannel
    from repro_torch.launch.mesh import make_host_mesh

    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    mesh = make_host_mesh(1, 1, device="cpu")
    for jkw, tkw in ((dict(strategy=JStrategy(channel=JMAC(2))),
                      dict(strategy=Strategy(channel=MACChannel(2)))),
                     (dict(strategy=JStrategy(), path=JPath()),
                      dict(strategy=Strategy(), path=PathPlan()))):
        with pytest.raises(ValueError) as want:
            jd.build_weights_fn(jmesh, **jkw)
        with pytest.raises(ValueError) as got:
            td.build_weights_fn(mesh, **tkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="give the WirePlan its mesh"):
        td.WirePlan(Strategy()).wire(torch.ones((4, 2), dtype=torch.int8))
