"""The port's boundary: plan values carried across from ``repro``, the
import wall between the packages, and the no-silent-CPU rule."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.comm.channel import BudgetChannel, MACChannel
from repro.configs import ggm_paper as j_configs
from repro.core.gram import GramConfig as JGramConfig
from repro.core.gram import GramEngine as JGramEngine
from repro.core.strategy import FIG3_STRATEGIES as J_FIG3
from repro.core.strategy import Strategy as JStrategy
from repro_torch import configs as t_configs
from repro_torch import interop
from repro_torch.core import chow_liu
from repro_torch.core.gram import GramConfig, GramEngine
from repro_torch.core.strategy import FIG3_STRATEGIES
from repro_torch.data import GGMDataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("s", list(J_FIG3) + [
    JStrategy(wire="packed", mst="kruskal"),
    JStrategy("persymbol", rate=4, wire="packed", placement="rowblock"),
    JStrategy(structure="sparse", lam=0.1)], ids=lambda s: s.label)
def test_strategy_round_trip(s):
    t = interop.strategy_from_fields(dataclasses.asdict(s))
    assert dataclasses.asdict(t)["channel"] == {}
    for f in ("method", "rate", "wire", "placement", "mst", "structure",
              "lam"):
        assert getattr(t, f) == getattr(s, f)
    assert t.label == s.label
    assert t.bits_per_symbol == s.bits_per_symbol
    assert t.wire_bits(1000, 20) == s.wire_bits(1000, 20)
    assert t.logical_bits(1000, 20) == s.logical_bits(1000, 20)
    assert t.packed_gram_ok(64) == s.packed_gram_ok(64)
    assert t.packed_gram_ok(60) == s.packed_gram_ok(60)


def test_fig3_and_configs_match():
    assert [s.label for s in FIG3_STRATEGIES] == [s.label for s in J_FIG3]
    for name in ("FIG3", "PRODUCTION"):
        assert dataclasses.asdict(getattr(t_configs, name)) == \
            dataclasses.asdict(getattr(j_configs, name))


@pytest.mark.parametrize("channel", [MACChannel(machines=4),
                                     BudgetChannel(budget_bits=1 << 20)])
def test_other_channels_wait_for_the_wire_plane(channel):
    """strategy_from_fields builds the MAC and budget channels (``kind``
    is a class attribute, so ``asdict`` leaves it out)."""
    method = "sign" if isinstance(channel, MACChannel) else "persymbol"
    s = JStrategy(method, rate=2 if method == "persymbol" else 1,
                  channel=channel)
    t = interop.strategy_from_fields(dataclasses.asdict(s))
    assert type(t.channel).__name__ == type(channel).__name__
    assert t.channel.kind == channel.kind
    assert dataclasses.asdict(t) == dataclasses.asdict(s)
    assert t.label == s.label


def test_engine_from_fields():
    e = interop.engine_from_fields(
        dataclasses.asdict(JGramEngine(backend="pallas", d_tile=256,
                                       n_chunk=4096, block_n=1024)),
        device="cpu")
    assert e == GramEngine(backend="kernel", d_tile=256, n_chunk=4096,
                           device="cpu")
    assert interop.engine_from_fields(
        dataclasses.asdict(JGramEngine(backend="xla"))).backend == "torch"
    assert interop.engine_from_fields(
        dataclasses.asdict(JGramConfig(d_tile=128))) == GramConfig(d_tile=128)
    # autotune carries across (the port keeps its own cache of winners)
    e = interop.engine_from_fields(
        dataclasses.asdict(JGramEngine(autotune=True)), device="cpu")
    assert e == GramEngine(autotune=True, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_params_and_opt_state_round_trip(dtype):
    """repro's params and OptState -> the port -> repro's layout again,
    bit for bit (bf16 widens to f32 exactly on the way back)."""
    import jax
    import jax.numpy as jnp

    from repro import optim as jo
    from repro.models import transformer as T
    from repro.models.arch import get_arch
    from repro_torch import optim as to

    jcfg = get_arch("stablelm-3b").reduced()
    params = T.init_params(jcfg, jax.random.key(1), getattr(jnp, dtype))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), params)
    jopt = jo.adamw()
    _, state = jopt.update(grads, jopt.init(params), params,
                           jnp.float32(1e-3))
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    host = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = interop.lm_params_from_numpy(cfg, host, device="cpu",
                                         dtype=getattr(torch, dtype))
    opt = to.AdamW(model.parameters())
    interop.opt_state_from_numpy(cfg, model, opt,
                                 jax.tree.map(np.asarray, state._asdict()))
    assert opt.step_count == 1
    back = interop.lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        np.testing.assert_array_equal(a, b)
    ost = interop.opt_state_to_numpy(cfg, model, opt)
    assert int(ost["step"]) == 1
    want = jax.tree.map(np.asarray, state.moments)
    assert jax.tree.structure(ost["moments"]) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(ost["moments"]), jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_tensors_from_numpy_keeps_dtypes_and_layouts():
    arrays = {"codes": np.zeros((6, 4), np.int8),
              "packed": np.zeros((4, 2), np.uint8)[:, ::1],
              "x": np.asfortranarray(np.ones((6, 4), np.float32))}
    out = interop.tensors_from_numpy(arrays, device="cpu")
    for k, a in arrays.items():
        assert out[k].dtype == getattr(torch, str(a.dtype))
        assert tuple(out[k].shape) == a.shape and out[k].is_contiguous()
        np.testing.assert_array_equal(out[k].numpy(), a)


def test_entry_points_raise_without_cuda(monkeypatch):
    """Host input goes to cuda by default; without CUDA the entry points
    raise rather than carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((16, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chow_liu.learn_structure(x)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GGMDataset(d=4).sample(8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GramEngine().gram(np.ones((8, 4), np.int8))
    # asked for the CPU, or handed CPU tensors, they run
    assert len(chow_liu.learn_structure(x, device="cpu")) == 3
    assert GramEngine().gram(torch.ones(8, 4, dtype=torch.int8)).shape == (4, 4)


_IMPORT_WALL = r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))"


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith"
        "(('jax.', 'jaxlib')) or k == 'repro' or k.startswith('repro.'))\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
        "need = {'repro_torch.core.' + m for m in ('bounds', 'distributed',"
        " 'experiments', 'faults', 'glasso', 'path', 'prng', 'sampler')}\n"
        "need |= {'repro_torch.comm.collectives', 'repro_torch.launch.mesh',"
        " 'repro_torch.data.ggm', 'repro_torch.data.tokens',"
        " 'repro_torch.optim.optimizers', 'repro_torch.optim.schedules',"
        " 'repro_torch.launch.steps', 'repro_torch.launch.train',"
        " 'repro_torch.launch.shapes', 'repro_torch.launch.serve',"
        " 'repro_torch.models.sharding', 'repro_torch.models.layers',"
        " 'repro_torch.models.transformer', 'repro_torch.interop',"
        " 'repro_torch.checkpoint.ckpt', 'repro_torch.serve.table',"
        " 'repro_torch.serve.server'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py",
                                             "lm_mesh_timing.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, f) for f in names if f.endswith(".py")]
    pattern = re.compile(_IMPORT_WALL, re.MULTILINE)
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders, offenders
