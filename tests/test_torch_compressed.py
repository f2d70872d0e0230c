"""The compressed gradient collectives (``repro_torch.comm.collectives``'s
``quantize_tensor``, ``compressed_psum`` / ``compressed_pmean`` /
``compressed_pmean_1stage``, ``error_feedback_init`` /
``error_feedback_apply``) on 4 gloo ranks, the structure server's tenant
mesh, and the mesh constructors.

The collectives run in one ``torch.multiprocessing.spawn`` of 4 ranks
(a ``FileStore``, one torch thread a rank), each rank on its row of one
numpy-seeded (4, 256) gradient. They are held to ``repro``'s own
conditions (``tests/test_distributed.py``'s
``test_compressed_collectives_and_error_feedback``: the rate-6 mean
within 0.15 relative RMSE of the true mean; error feedback at rate 3
over 8 rounds within 0.15 and under 0.7 of the one-shot error), and the
codes of every rank equal ``repro``'s ``quantize_tensor`` bit for bit.

The tenant mesh runs in this process on repeated CPU devices: a table
split over 4 devices folds and solves to the bits of one without a
mesh. ``repro`` and JAX are imported inside the tests only: the spawned
ranks import this module.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.comm import (compressed_pmean, compressed_pmean_1stage,
                              compressed_psum, dequantize_tensor,
                              error_feedback_apply, error_feedback_init,
                              quantize_tensor)

WORLD, N = 4, 256


def _grads() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((WORLD, N)).astype(
        np.float32)


def _cases(r: int, group) -> dict:
    g = torch.from_numpy(_grads()[r])
    out = {}
    for rate in (3, 6):
        codes, scale = quantize_tensor(g, rate)
        out["codes", rate] = codes.numpy()
        out["scale", rate] = float(scale)
        out["dequant", rate] = dequantize_tensor(codes, scale, rate).numpy()
    out["pmean"] = compressed_pmean(g, group, 6).numpy()
    out["psum"] = compressed_psum(g.view(8, -1), group, 6).numpy()
    out["pmean_1stage"] = compressed_pmean_1stage(g, group, 3).numpy()

    res = error_feedback_init({"g": torch.zeros(N)})
    acc = torch.zeros(N)
    for _ in range(8):
        got, res = error_feedback_apply({"g": g}, res, group, 3)
        acc = acc + got["g"]
    out["ef"] = (acc / 8).numpy()
    one, res1 = error_feedback_apply({"g": g}, {"g": torch.zeros(N)}, group,
                                     3)
    out["one_shot"] = one["g"].numpy()
    out["residual"] = res1["g"].numpy()
    return out


def _rank_main(rank, world, store, out_dir):
    from repro_torch.launch.mesh import init_rank, make_trial_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")
    mesh = make_trial_mesh(world, device="cpu")
    res = _cases(mesh.get_local_rank("data"), mesh.get_group("data"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compressed")
    mp.spawn(_rank_main, args=(WORLD, str(tmp / "store"), str(tmp)),
             nprocs=WORLD)
    return [pickle.load(open(tmp / f"rank{r}.pkl", "rb"))
            for r in range(WORLD)]


@pytest.mark.parametrize("rate", [3, 6])
def test_codes_equal_repros(ranks, rate):
    import jax.numpy as jnp

    from repro.comm.collectives import dequantize_tensor as j_deq
    from repro.comm.collectives import quantize_tensor as j_quant

    for r, res in enumerate(ranks):
        codes, scale = j_quant(jnp.asarray(_grads()[r]), rate)
        np.testing.assert_array_equal(res["codes", rate], np.asarray(codes))
        np.testing.assert_allclose(res["scale", rate], float(scale),
                                   rtol=1e-6)
        np.testing.assert_allclose(res["dequant", rate],
                                   np.asarray(j_deq(codes, scale, rate)),
                                   rtol=1e-6)


def test_compressed_mean_within_repros_bound(ranks):
    want = _grads().mean(0)
    for key in ("pmean", "psum"):
        rows = np.stack([res[key].reshape(-1) / (WORLD if key == "psum"
                                                 else 1) for res in ranks])
        np.testing.assert_array_equal(rows, np.broadcast_to(rows[0],
                                                             rows.shape))
        err = np.sqrt(np.mean((rows - want) ** 2)) / np.sqrt(
            np.mean(want ** 2))
        assert err < 0.15, (key, err)


def test_one_stage_mean_is_the_mean_of_the_sent_values(ranks):
    """Each rank's distortion is its own encode error: the one-stage mean
    is the mean of what the ranks' codes decode to."""
    from repro.comm.collectives import dequantize_tensor as j_deq
    from repro.comm.collectives import quantize_tensor as j_quant

    sent = [np.asarray(j_deq(*j_quant(g, 3), 3)) for g in _grads()]
    np.testing.assert_allclose(ranks[0]["pmean_1stage"],
                               np.mean(sent, axis=0), rtol=1e-6, atol=1e-7)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["residual"], _grads()[r] - sent[r],
                                   rtol=1e-6, atol=1e-6)


def test_error_feedback_beats_one_shot(ranks):
    want = _grads().mean(0)
    rel = np.linalg.norm(ranks[0]["ef"] - want) / np.linalg.norm(want)
    rel1 = np.linalg.norm(ranks[0]["one_shot"] - want) / np.linalg.norm(
        want)
    assert rel < 0.7 * rel1, (rel, rel1)
    assert rel < 0.15, rel
    for res in ranks[1:]:
        np.testing.assert_array_equal(res["ef"], ranks[0]["ef"])


# -- the tenant mesh -----------------------------------------------------------

def _payloads(rng, tenants, d, n, method):
    from repro_torch.serve.ingest import Payload

    out = []
    for t in range(tenants):
        for m in range(2):
            if method == "sign":
                codes = rng.choice(np.array([-1, 1], np.int8), (n, d))
            else:
                codes = rng.integers(0, 8, (n, d)).astype(np.int8)
            out.append(Payload(tenant=t, machine=m, seq=1, codes=codes))
        if method == "sign":     # and a packed-sign payload a tenant
            out.append(Payload(tenant=t, machine=2, seq=1, n=n - 3,
                               packed=rng.integers(0, 256, (d, n // 8))
                               .astype(np.uint8)))
    return out


@pytest.mark.parametrize("method", ["sign", "persymbol"])
def test_tenant_mesh_keeps_every_tenants_bits(method):
    from repro_torch.core.gram import GramEngine
    from repro_torch.launch.mesh import make_tenant_mesh
    from repro_torch.serve.table import TenantTable

    cpu = torch.device("cpu")
    mesh = make_tenant_mesh(8, devices=[cpu] * 4)
    assert mesh.size == 4
    kw = dict(tenants=8, d=16, method=method, rate=3, block_n=32,
              max_slots=16, engine=GramEngine(device="cpu"))
    tables = [TenantTable(**kw), TenantTable(**kw, mesh=mesh)]
    calls = []
    for t in tables:
        pay = _payloads(np.random.default_rng(4), 8, 16, 32, method)
        t.fold(pay)
        calls.append(t.resolve(np.arange(8)))
    assert calls[0] == calls[1]
    for k, v in tables[0].state_tree().items():
        np.testing.assert_array_equal(tables[1].state_tree()[k], v, err_msg=k)


def test_mesh_constructors():
    from repro_torch.launch.mesh import (make_host_mesh,
                                         make_production_mesh,
                                         make_tenant_mesh)

    make_host_mesh(1, 1, device="cpu")            # a one-rank group
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks"):
            make_production_mesh(multi_pod=multi_pod, device="cpu")
    cpus = [torch.device("cpu")] * 4
    assert make_tenant_mesh(devices=cpus).size == 4
    assert make_tenant_mesh(3, devices=cpus).size == 2
    assert make_tenant_mesh(8, devices=cpus[:3]).size == 2
    assert make_tenant_mesh(1, devices=cpus).size == 1
