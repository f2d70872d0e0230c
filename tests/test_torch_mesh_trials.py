"""``run_trials(mesh=...)`` of the port on 4 gloo ranks — a 1-D ``(4,)``
data mesh and a 2-D ``(2, 2)`` wire mesh — against ``repro``'s
``run_trials`` on its (1, 1) wire mesh, at d = 16: Fig. 3's strategies, a
rowblock plan, ``tests/test_channels.py``'s ``_PARITY`` plan (gather, MAC
and budget channels) pristine and faulty, a fault plan with retries and
bit flips, and a sparse plan with a fixed penalty and with an EBIC path.

Metrics, fault telemetry, buckets, comm reports (collectives only on the
wire mesh), ``mesh_devices`` and ``host_syncs == 1`` must be equal on
every rank; sparse supports follow ``tests/_sparse_parity.py``'s
threshold rule against ``repro`` and equal the port's mesh-less sweep
exactly. The refusals (reps over the data axis, d over the model axis,
the MAC row split, host Kruskal under a mesh) carry ``repro``'s texts.
``repro`` and JAX are imported inside the tests only: the spawned ranks
import this module.
"""
import dataclasses
import os
import pickle
import types

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import core as tcore

PLANS = ("fig3", "rowblock", "parity", "parity-faults", "retries", "sparse",
         "ebic")
#: mesh -> (data, model) of the 4-rank spawn
MESHES = {"data4": (4, None), "wire2x2": (2, 2)}
#: the one 8-rank spawn: repro's own gate shape, on its gate's plans
EIGHT = {"wire2x4": (2, 4)}
EIGHT_PLANS = ("fig3", "parity", "parity-faults")
REFUSALS = ("reps", "d", "mac-rowsplit", "host-kruskal")
FIELDS = ("error_rate", "edit_distance", "edge_f1", "precision", "recall",
          "faults", "buckets", "tiling", "host_syncs", "path")


def _plan(c, name: str):
    """Plan ``name`` built from package namespace ``c`` (``repro.core`` or
    ``repro_torch.core``)."""
    S = c.Strategy
    parity = (S("sign"), S("sign", channel=c.MACChannel(4)),
              S("persymbol", rate=4, channel=c.BudgetChannel(
                  budget_bits=4 * 100 * 16, machines=4)))
    sparse = c.TrialPlan(
        d=16, ns=(250, 1000), tree="sparse", density=0.18, rho_min=0.25,
        rho_max=0.45, reps=4, glasso_steps=100, strategies=(
            S("sign", structure="sparse", lam=0.06),
            S("persymbol", rate=4, structure="sparse", lam=0.06)))
    return {
        "fig3": lambda: c.TrialPlan(d=16, ns=(100, 400), reps=8,
                                    strategies=c.FIG3_STRATEGIES),
        "rowblock": lambda: c.TrialPlan(
            d=16, ns=(100,), reps=8, strategies=(
                S("sign", placement="rowblock"),
                S("persymbol", rate=1, placement="rowblock"))),
        "parity": lambda: c.TrialPlan(d=16, ns=(100, 400), reps=8,
                                      strategies=parity, seed0=5),
        "parity-faults": lambda: c.TrialPlan(
            d=16, ns=(100,), reps=8, strategies=parity, seed0=5,
            faults=c.FaultPlan(machines=4, dropout=0.25, straggle=0.3,
                               seed=11)),
        "retries": lambda: c.TrialPlan(
            d=16, ns=(128,), reps=8, seed0=7, strategies=(
                S("sign", wire="packed"), S("persymbol", rate=4),
                S("original")),
            faults=c.FaultPlan(machines=4, dropout=0.3, bitflip=0.01,
                               retries=2, seed=3)),
        "sparse": lambda: sparse,
        "ebic": lambda: dataclasses.replace(sparse, path=c.PathPlan(
            n_lams=4, lam_min_ratio=0.08)),
    }[name]()


def _refuse(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def _refusals(c, mesh_of, **kw) -> dict:
    """Each refusal's text from package ``c``'s ``run_trials`` on the
    meshes ``mesh_of(data, model)`` gives (``kw``: its device)."""
    one = (c.Strategy("sign"),)
    mac = (c.Strategy("sign", channel=c.MACChannel(2)),)
    out = {
        "reps": _refuse(lambda: c.run_trials(
            c.TrialPlan(d=16, ns=(64,), reps=6, strategies=one),
            mesh=mesh_of(4, None), **kw)),
        "d": _refuse(lambda: c.run_trials(
            c.TrialPlan(d=15, ns=(64,), reps=8, strategies=one),
            mesh=mesh_of(2, 2), **kw)),
        "host-kruskal": _refuse(lambda: c.run_trials(
            c.TrialPlan(d=16, ns=(64,), reps=8, strategies=one),
            mesh=mesh_of(4, None), mst="host_kruskal", **kw)),
    }
    if kw:  # the port's real (1, 4) mesh; repro's check is called alone
        out["mac-rowsplit"] = _refuse(lambda: c.run_trials(
            c.TrialPlan(d=16, ns=(100,), reps=8, strategies=mac,
                        n_buckets=(102,)), mesh=mesh_of(1, 4), **kw))
    return out


def _summary(res) -> dict:
    out = {f: getattr(res, f) for f in FIELDS}
    out["comm"] = {k: [dataclasses.asdict(r) for r in v]
                   for k, v in res.comm.items()}
    out["mesh_devices"] = res.mesh_devices
    return out


def _rank_main(rank, world, store, out_dir, meshes, plans):
    from repro_torch.launch.mesh import init_rank, make_trial_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")

    def mesh_of(data, model):
        return make_trial_mesh(data, model=model, device="cpu")

    res = {}
    for m, shape in meshes.items():
        mesh = mesh_of(*shape)
        for p in plans:
            res[(m, p)] = _summary(tcore.run_trials(
                _plan(tcore, p), mesh=mesh, device="cpu"))
    if world == 4:
        res["refusals"] = _refusals(tcore, mesh_of, device="cpu")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def _spawn(tmp, world: int, meshes: dict, plans: tuple) -> dict:
    """Rank 0's results of a ``world``-rank spawn, after checking that
    every rank returned the same."""
    mp.spawn(_rank_main, args=(world, str(tmp / "store"), str(tmp), meshes,
                               plans), nprocs=world)
    res = [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
           for r in range(world)]
    for other in res[1:]:
        assert other == res[0]
    return res[0]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh_trials"), 4, MESHES, PLANS)


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mesh_trials8"), 8, EIGHT,
                  EIGHT_PLANS)


@pytest.fixture(scope="module")
def reference():
    """plan -> (repro's plan, its result on a (1, 1) wire mesh, the
    port's mesh-less result). A sparse plan's port result is held to
    repro's by the threshold rule here, once."""
    import _sparse_parity
    import repro.core as jcore
    from repro.launch.mesh import make_trial_mesh

    mesh = make_trial_mesh(1, model=1)
    out = {}
    for name in PLANS:
        jplan, tplan = _plan(jcore, name), _plan(tcore, name)
        want = jcore.run_trials(jplan, mesh=mesh)
        alone = tcore.run_trials(tplan, device="cpu")
        if tplan.structure == "sparse":
            _sparse_parity.assert_sparse_sweeps_agree(jplan, tplan, want,
                                                      alone)
        out[name] = (jplan, want, alone)
    return out


def _assert_matches(got: dict, reference: dict, mesh: str, plan: str,
                    ranks: int) -> None:
    _, want, alone = reference[plan]
    assert got["mesh_devices"] == ranks and want.mesh_devices == 1
    assert got["host_syncs"] == want.host_syncs == 1
    comm = _summary(want)["comm"]
    if mesh == "data4":  # no wire runtime on a data-only mesh
        comm = {k: [dict(r, collectives=0) for r in v]
                for k, v in comm.items()}
    assert got["comm"] == comm
    # the mesh sweep is the port's mesh-less sweep exactly; a tree sweep's
    # is repro's exactly, a sparse sweep's by the threshold rule
    # (``reference``)
    for f in FIELDS:
        assert got[f] == getattr(alone, f), f
        if alone.plan.structure != "sparse":
            assert got[f] == getattr(want, f), f


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mesh_sweep_matches_repro(ranks, reference, mesh, plan):
    _assert_matches(ranks[(mesh, plan)], reference, mesh, plan, 4)


@pytest.mark.parametrize("plan", EIGHT_PLANS)
def test_eight_rank_wire_sweep_matches_repro(eight_ranks, reference, plan):
    """The (2, 4) wire mesh of ``repro``'s own 1-vs-8 gates."""
    _assert_matches(eight_ranks[("wire2x4", plan)], reference, "wire2x4",
                    plan, 8)


@pytest.mark.parametrize("case", REFUSALS)
def test_mesh_refusals_are_repros(ranks, case):
    import repro.core as jcore
    from repro.core import experiments as je

    def fake(data, model):
        """The two fields repro's run_trials reads of a mesh before its
        size checks, for meshes wider than this host's one device."""
        names = ("data",) if model is None else ("data", "model")
        shape = {"data": data} if model is None else {"data": data,
                                                      "model": model}
        return types.SimpleNamespace(shape=shape, axis_names=names)

    if case == "mac-rowsplit":
        want = _refuse(lambda: je._check_mac_rowsplit(
            (jcore.Strategy("sign", channel=jcore.MACChannel(2)),), 102, 4))
    else:
        want = _refusals(jcore, fake)[case]
    assert ranks["refusals"][case] == want != "no error"


@pytest.mark.parametrize("case", ["data", "model", "data-model", "host"])
def test_mesh_size_checks_are_repros(case):
    """The meshes' size checks carry ``repro``'s texts, with this
    process's world size (1 here) in place of the device count."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch import mesh as tmesh

    call = {"data": lambda m, **kw: m.make_trial_mesh(2, **kw),
            "model": lambda m, **kw: m.make_trial_mesh(model=2, **kw),
            "data-model": lambda m, **kw: m.make_trial_mesh(2, model=1,
                                                            **kw),
            "host": lambda m, **kw: m.make_host_mesh(1, 2, **kw)}[case]
    with pytest.raises(ValueError) as want:
        call(jmesh)
    with pytest.raises(ValueError) as got:
        call(tmesh, device="cpu")
    assert str(got.value) == str(want.value)
