"""The port's wire collectives (``repro_torch.comm.collectives``) and each
channel's ``transmit`` against ``repro``'s, on 1 gloo rank (in this
process) and on 4 gloo ranks (``torch.multiprocessing.spawn`` on a
``FileStore``: no port to race for).

Every rank builds the same full payloads from a numpy seed and keeps its
block; the gathered or summed result must equal ``repro``'s collective
(run in a one-device ``shard_map``) on the full payload bit for bit.
``repro`` and JAX are imported inside the tests only: the spawned ranks
import this module and must stay free of them.
"""
import os
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.comm.channel import BudgetChannel, GatherChannel, MACChannel
from repro_torch.comm.collectives import (erasure_all_gather, neutral_fill,
                                          superposed_psum)
from repro_torch.core.gram import GramEngine
from repro_torch.core.quantizers import MASKED_CODE

B, N, D = 2, 64, 16
#: layout -> (payload kind, fill, feature axis)
LAYOUTS = {"int8": ("signs", 0, 2), "codes": ("codes", MASKED_CODE, 2),
           "f32": ("values", 0, 2), "packed": ("packed", 0, 1)}
TRANSMITS = ("gather", "gather_keep", "mac", "budget")


def _payloads():
    """The full operands every rank derives from one numpy seed."""
    rng = np.random.default_rng(0)
    signs = rng.choice(np.array([-1, 1], np.int8), (B, N, D))
    return {
        "signs": signs,
        "codes": rng.integers(0, 16, (B, N, D)).astype(np.int8),
        "values": rng.normal(size=(B, N, D)).astype(np.float32),
        "packed": rng.integers(0, 256, (B, D, N // 8)).astype(np.uint8),
        "keep": rng.random((B, D)) < 0.6,
    }


def _block(a: np.ndarray, axis: int, r: int, k: int) -> torch.Tensor:
    size = a.shape[axis] // k
    return torch.from_numpy(np.take(a, range(r * size, (r + 1) * size),
                                    axis=axis).copy())


def _cases(r: int, k: int, group) -> dict:
    """Every collective case on rank ``r`` of ``k`` over ``group``."""
    p = _payloads()
    out = {}
    for name, (kind, fill, axis) in LAYOUTS.items():
        local = _block(p[kind], axis, r, k)
        keep = _block(p["keep"], 1, r, k)
        out[f"erasure-{name}"] = erasure_all_gather(
            local, group, keep, axis=axis, fill=fill).numpy()
    eng = GramEngine(device="cpu")
    rows = _block(p["signs"], 1, r, k)
    partial = eng.gram_batch(rows)
    out["psum"] = superposed_psum(partial, group).numpy()
    out["psum-input-kept"] = bool((partial == eng.gram_batch(rows)).all())
    signs = _block(p["signs"], 2, r, k)
    keep = _block(p["keep"], 1, r, k)
    out["transmit-gather"] = GatherChannel().transmit(
        signs, group, axis=2).numpy()
    out["transmit-gather_keep"] = GatherChannel().transmit(
        signs, group, axis=2, keep=keep, fill=0).numpy()
    out["transmit-mac"] = MACChannel(4).transmit(partial, group).numpy()
    codes = _block(p["codes"], 2, r, k)
    out["transmit-budget"] = BudgetChannel(budget_bits=1, machines=4) \
        .transmit(codes, group, axis=2).numpy()
    return out


def _rank_main(rank, world, store, out_dir):
    from repro_torch.launch.mesh import init_rank, make_trial_mesh

    torch.set_num_threads(1)
    init_rank(rank, world, store, device="cpu")
    mesh = make_trial_mesh(1, model=world, device="cpu")
    res = _cases(mesh.get_local_rank("model"), world, mesh.get_group("model"))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{rank count: results on rank 0}, after checking that every rank
    returned the same results."""
    from repro_torch.launch.mesh import make_host_mesh

    one = make_host_mesh(1, 1, device="cpu")
    got = {1: _cases(0, 1, one.get_group("model"))}
    tmp = tmp_path_factory.mktemp("collectives")
    mp.spawn(_rank_main, args=(4, str(tmp / "store"), str(tmp)), nprocs=4)
    res = [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]
    for other in res[1:]:
        for key, val in res[0].items():
            assert np.array_equal(other[key], val), key
    got[4] = res[0]
    return got


def _repro_transmit(channel: str, full: np.ndarray, keep=None, axis=2,
                    fill=0) -> np.ndarray:
    """``repro``'s ``transmit`` of ``channel`` ("gather" / "mac" /
    "budget") on the full payload, in a one-device ``shard_map``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.comm import channel as jch  # (repro shims jax.shard_map)

    ch = {"gather": jch.GatherChannel(), "mac": jch.MACChannel(4),
          "budget": jch.BudgetChannel(budget_bits=1, machines=4)}[channel]
    args = (jnp.asarray(full),) + (() if keep is None
                                   else (jnp.asarray(keep),))

    def body(x, *k):
        return ch.transmit(x, "model", axis=axis, keep=k[0] if k else None,
                           fill=fill)

    fn = jax.shard_map(body, mesh=jax.make_mesh((1,), ("model",)),
                       in_specs=(P(),) * len(args), out_specs=P(),
                       check_vma=False)
    return np.asarray(fn(*args))


_DTYPES = {"int8": torch.int8, "uint8": torch.uint8, "float32": torch.float32}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("method", ["sign", "persymbol", "original"])
def test_neutral_fill_is_repros(method, dtype):
    import jax.numpy as jnp

    from repro.comm.collectives import neutral_fill as j_fill

    assert neutral_fill(method, _DTYPES[dtype]) == j_fill(
        method, getattr(jnp, dtype))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_erasure_gather_equals_masking_before_the_gather(ranks, layout, k):
    kind, fill, axis = LAYOUTS[layout]
    p = _payloads()
    full, keep = p[kind], p["keep"]
    shape = [B, 1, 1]
    shape[axis] = D
    masked = np.where(keep.reshape(shape), full, np.asarray(fill, full.dtype))
    got = ranks[k][f"erasure-{layout}"]
    assert got.dtype == full.dtype
    np.testing.assert_array_equal(got, masked)
    np.testing.assert_array_equal(
        got, _repro_transmit("gather", full, keep, axis, fill))


def _sign_gram() -> np.ndarray:
    s = _payloads()["signs"].astype(np.int64)
    return np.einsum("bni,bnj->bij", s, s).astype(np.float32)


@pytest.mark.parametrize("k", [1, 4])
def test_superposed_psum_of_integer_grams_is_exact(ranks, k):
    """The ranks' row-share sign Grams sum to the full Gram exactly (and
    the summand is left as it was)."""
    np.testing.assert_array_equal(ranks[k]["psum"], _sign_gram())
    assert ranks[k]["psum-input-kept"]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("how", TRANSMITS)
def test_channel_transmit(ranks, how, k):
    p = _payloads()
    want = {"gather": lambda: _repro_transmit("gather", p["signs"]),
            "gather_keep": lambda: _repro_transmit("gather", p["signs"],
                                                   p["keep"]),
            "budget": lambda: _repro_transmit("budget", p["codes"]),
            "mac": lambda: _repro_transmit("mac", _sign_gram())}[how]()
    np.testing.assert_array_equal(ranks[k][f"transmit-{how}"], want)
