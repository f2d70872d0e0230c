"""The port's channel plane (``repro_torch.comm.channel``, the MAC and
budget estimators, the row-block fault view, the channel ledgers)
against ``repro``'s, on the CPU, on ``tests/test_channels.py``'s plans.

The plan values, labels, allocations, MAC and budget codes, row-block
fault counts and MAC Grams are held bit for bit; budget Grams to the f32
Gram tolerance and weights to ``WEIGHT_TOL`` (ROADMAP §3);
``comm_report`` field for field.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.comm import channel as j_channel
from repro.core import chow_liu as j_cl
from repro.core import estimators as j_est
from repro.core import experiments as je
from repro.core import faults as j_faults
from repro.core import sampler as j_sampler
from repro.core.distributed import WirePlan
from repro.core.strategy import Strategy as JStrategy
from repro_torch import comm as t_comm
from repro_torch import core as t_core
from repro_torch.comm import channel as t_channel
from repro_torch.core import chow_liu as t_cl
from repro_torch.core import distributed as t_dist
from repro_torch.core import estimators as t_est
from repro_torch.core import faults as t_faults
from repro_torch.core.strategy import Strategy
from repro_torch.interop import strategy_from_fields

WEIGHT_TOL = dict(rtol=1e-6, atol=2.5e-7)
GRAM_TOL_PER_N = 1e-5
#: budget weights and correlations: their f32 value Grams sum in another
#: order than XLA's (GRAM_TOL_PER_N), which moves a weight near 0.8 by up
#: to ~2e-6; on repro's own Gram the port's tail is held to WEIGHT_TOL
F32_STAT_TOL = dict(rtol=1e-5, atol=1e-6)
D = 12

J_MAC = JStrategy("sign", channel=j_channel.MACChannel(4))
J_BUDGET = JStrategy("persymbol", rate=4, channel=j_channel.BudgetChannel(
    budget_bits=4 * 100 * D, machines=4))
#: a budget that runs out: machines at (1, 1, 1, 0) at n = 100
J_SHORT = JStrategy("persymbol", rate=3, channel=j_channel.BudgetChannel(
    budget_bits=3 * 100 * 3, machines=4))

FAULTS = {
    "mixed": dict(dropout=0.3, straggle=0.4, bitflip=0.05, retries=2,
                  machines=4, seed=3),
    "bench": dict(dropout=0.15, straggle=0.3, straggle_frac=0.5,
                  machines=4, seed=1),
    "heavy": dict(dropout=0.6, straggle=0.5, straggle_frac=0.25,
                  machines=4, seed=11),
}


def _port(s) -> Strategy:
    return strategy_from_fields(dataclasses.asdict(s))


@pytest.fixture(scope="module")
def samples():
    """repro's (4, 128, 12) bucketed tree samples (n_valid 100)."""
    jp = je.TrialPlan(d=D, ns=(100,), reps=4, seed0=3)
    par, rho, _ = je.stacked_trees(jp)
    return np.asarray(j_sampler.sample_tree_ggm_rows_batch(
        je.trial_keys(jp), 128, par, rho))


def _faults(name, reps=4, n_pad=128, n_valid=100, machines=4):
    """repro's feature-view and row-block draws of one FaultPlan."""
    jp = j_faults.FaultPlan(**FAULTS[name])
    keys = j_faults.fault_trial_keys(jp, reps)
    n_rows, flip, _ = jp.draw_batch(keys, n_pad, jnp.asarray(n_valid,
                                                             jnp.int32), D)
    delivered = jp.draw_rowblock_batch(keys, n_pad, jnp.asarray(
        n_valid, jnp.int32), machines)
    return n_rows, flip, delivered


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# Plan values
# --------------------------------------------------------------------------

def test_channels_are_plan_values_with_repros_labels():
    for j, t in ((j_channel.GatherChannel(), t_channel.GatherChannel()),
                 (j_channel.MACChannel(4), t_channel.MACChannel(4)),
                 (j_channel.BudgetChannel(budget_bits=99, machines=3),
                  t_channel.BudgetChannel(budget_bits=99, machines=3))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.kind, t.suffix) == (j.kind, j.suffix)
        assert hash(t) == hash(type(t)(**dataclasses.asdict(t)))
    assert t_comm.MACChannel is t_core.MACChannel is t_channel.MACChannel
    assert t_comm.BudgetChannel is t_core.BudgetChannel
    assert Strategy("sign").channel is t_channel.GATHER
    for s in (J_MAC, J_BUDGET, J_SHORT,
              JStrategy("persymbol", rate=3,
                        channel=j_channel.BudgetChannel(budget_bits=99)),
              JStrategy("sign", channel=j_channel.MACChannel(2),
                        structure="sparse", lam=0.1)):
        t = _port(s)
        assert t.label == s.label
        assert t.channel == type(t.channel)(**dataclasses.asdict(s.channel))
        assert dataclasses.asdict(t) == dataclasses.asdict(s)
    assert _port(J_MAC).label == "sign@mac4"
    assert _port(J_BUDGET).label == "R4@bgt4800"


VETOES = {
    "mac-persymbol": lambda m: m.Strategy("persymbol", rate=3,
                                          channel=m.MACChannel(2)),
    "mac-packed": lambda m: m.Strategy("sign", wire="packed",
                                       channel=m.MACChannel(2)),
    "mac-rowblock": lambda m: m.Strategy("sign", placement="rowblock",
                                         channel=m.MACChannel(2)),
    "mac-machines": lambda m: m.MACChannel(0),
    "budget-sign": lambda m: m.Strategy("sign", channel=m.BudgetChannel(
        budget_bits=64)),
    "budget-original": lambda m: m.Strategy(
        "original", channel=m.BudgetChannel(budget_bits=64)),
    "budget-packed": lambda m: m.Strategy("persymbol", rate=2, wire="packed",
                                          channel=m.BudgetChannel(
                                              budget_bits=64)),
    "budget-bits": lambda m: m.BudgetChannel(budget_bits=0),
    "budget-machines": lambda m: m.BudgetChannel(budget_bits=8, machines=0),
    "plan-budget-divide": lambda m: m.TrialPlan(
        d=9, ns=(64,), reps=2, strategies=(m.Strategy(
            "persymbol", rate=2, channel=m.BudgetChannel(budget_bits=999,
                                                         machines=2)),)),
    "plan-mac-faults": lambda m: m.TrialPlan(
        d=8, ns=(64,), reps=2, strategies=(m.Strategy(
            "sign", channel=m.MACChannel(2)),),
        faults=m.FaultPlan(machines=4)),
    "block-rows": lambda m: m.MACChannel(3).block_rows(64),
    "allocate-divide": lambda m: m.BudgetChannel(
        budget_bits=99, machines=5).allocate(10, 12, 3),
}


class _Repro:
    from repro.core import FaultPlan, Strategy, TrialPlan
    from repro.comm import BudgetChannel, MACChannel


class _Port:
    from repro_torch.core import (BudgetChannel, FaultPlan, MACChannel,
                                  Strategy, TrialPlan)


@pytest.mark.parametrize("case", sorted(VETOES))
def test_channel_vetoes_are_repros(case):
    with pytest.raises(Exception) as want:
        VETOES[case](_Repro)
    with pytest.raises(Exception) as got:
        VETOES[case](_Port)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value).replace("repro_torch.", "repro.") == \
        str(want.value)


ALLOCATIONS = [  # (n, d, cap, B, machines)
    (100, 12, 4, 4 * 100 * 12, 4), (100, 12, 4, 100 * 12, 4),
    (64, 12, 7, 7 * 64 * 12, 2), (64, 12, 3, 5, 2),
    (200, 12, 3, 3 * 200 * 12 // 2, 3), (512, 16, 4, 6 * 512 * 16, 4),
    (2048, 16, 4, 6 * 512 * 16, 4), (8192, 1024, 4, 24 * 8192 * 64, 16),
    (2048, 1024, 4, 24 * 8192 * 64, 16), (1 << 18, 4096, 4,
                                          24 * (1 << 18) * 256, 16),
    (1000, 64, 4, 24 * 1024 * 4, 16), (7, 6, 2, 1 << 30, 6),
]


@pytest.mark.parametrize("n,d,cap,B,m", ALLOCATIONS)
def test_allocate_and_column_rates_are_repros(n, d, cap, B, m):
    j = j_channel.BudgetChannel(budget_bits=B, machines=m)
    t = t_channel.BudgetChannel(budget_bits=B, machines=m)
    assert t.allocate(n, d, cap) == j.allocate(n, d, cap)
    cols = t.column_rates(n, d, cap)
    want = j.column_rates(n, d, cap)
    assert cols.dtype == want.dtype
    np.testing.assert_array_equal(cols, want)
    rates = t.allocate(n, d, cap)
    assert sum(n * (d // m) * r for r in rates) <= B


# --------------------------------------------------------------------------
# The row-block fault view
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("n_pad,n_valid,machines",
                         [(128, 100, 4), (64, 64, 4), (128, 37, 8),
                          (256, 250, 2)])
def test_draw_rowblock_batch_is_bit_identical(name, n_pad, n_valid,
                                              machines):
    reps = 7
    kw = dict(FAULTS[name], machines=machines)
    jp, tp = j_faults.FaultPlan(**kw), t_faults.FaultPlan(**kw)
    jk = j_faults.fault_trial_keys(jp, reps)
    tk = t_faults.fault_trial_keys(tp, reps, device="cpu")
    want = np.asarray(jp.draw_rowblock_batch(
        jk, n_pad, jnp.asarray(n_valid, jnp.int32), machines))
    got = tp.draw_rowblock_batch(tk, n_pad, n_valid, machines)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the row-block and feature views realize the same machine fates
    # (one machine per feature block when d == machines)
    n_rows, _, tele = tp.draw_batch(tk, n_pad, n_valid, machines)
    holds = torch.arange(machines) * (n_pad // machines) < n_valid
    assert torch.equal((got == 0)[:, holds], (n_rows == 0)[:, holds])
    assert torch.equal((n_rows == 0).sum(dim=1).float(), tele[:, 0])
    with pytest.raises(ValueError, match="divide"):
        tp.draw_rowblock_batch(tk, n_pad + 1, n_valid, machines)


# --------------------------------------------------------------------------
# MAC estimators
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_pad,n_valid", [(128, 100), (128, 128),
                                           (128, 3), (64, None)])
def test_mac_delivered_rows_are_repros(n_pad, n_valid):
    for m in (1, 2, 4, 8):
        jc, tc = j_channel.MACChannel(m), t_channel.MACChannel(m)
        want = np.asarray(j_est.mac_delivered_rows(jc, n_pad, n_valid))
        got = t_est.mac_delivered_rows(tc, n_pad, n_valid, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got.sum()) == (n_pad if n_valid is None else n_valid)


@pytest.mark.parametrize("fault", [None, "mixed", "bench", "heavy"])
def test_mac_codes_gram_and_weights_are_repros(samples, fault):
    """repro's samples under repro's row-block draws through the port's
    MAC path: codes and Gram bit for bit, weights and correlations within
    the sign tolerance."""
    n = 100
    ts = _port(J_MAC)
    x = jnp.asarray(samples)
    xt = torch.from_numpy(samples.copy())
    jkw, tkw = dict(n_valid=n), dict(n_valid=n)
    if fault is not None:
        _, flip, delivered = _faults(fault)
        jkw.update(delivered=delivered, flip=flip)
        tkw.update(delivered=_t(delivered), flip=_t(flip))
    want_u = np.asarray(j_est.mac_sign_codes(x, J_MAC, **jkw))
    got_u = t_est.mac_sign_codes(xt, ts, **tkw)
    assert got_u.dtype == torch.int8
    np.testing.assert_array_equal(got_u.numpy(), want_u)
    want_g = np.asarray(j_est.resolve_engine(None).gram_batch(
        jnp.asarray(want_u)))
    got_g = t_est.resolve_engine(None).gram_batch(got_u)
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    ecount = dict(n_valid=n, delivered=tkw.get("delivered"))
    np.testing.assert_array_equal(
        t_est.mac_effective_count(ts, 128, device="cpu", **ecount).numpy(),
        np.asarray(j_est.mac_effective_count(
            J_MAC, 128, n_valid=n, delivered=jkw.get("delivered"))))
    want_w = np.asarray(j_est.mac_weights_batch(x, J_MAC, **jkw))
    got_w = t_est.mac_weights_batch(xt, ts, **tkw)
    np.testing.assert_allclose(got_w.numpy(), want_w, **WEIGHT_TOL)
    # the batch dispatch reaches the same path
    got_b = t_est.strategy_weights_batch(xt, ts, **tkw)
    assert torch.equal(got_b, got_w)
    want_c = np.asarray(j_est.mac_weights_batch(x, J_MAC, corr=True, **jkw))
    got_c = t_est.mac_weights_batch(xt, ts, corr=True, **tkw)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)


def test_mac_lossless_codes_are_the_gather_sign_payload(samples):
    xt = torch.from_numpy(samples)
    for m in (1, 2, 4, 8):
        ts = Strategy("sign", channel=t_channel.MACChannel(m))
        for n in (100, 128, 1):
            got = t_est.mac_sign_codes(xt, ts, n_valid=n)
            assert torch.equal(got, t_est.strategy_payload(
                xt, Strategy("sign"), n_valid=n))
    with pytest.raises(ValueError, match="divide"):
        t_est.mac_sign_codes(xt[:, :100], ts)


# --------------------------------------------------------------------------
# Budget estimators
# --------------------------------------------------------------------------

def test_budget_centroid_table_is_repros():
    for cap in range(1, 8):
        np.testing.assert_array_equal(t_est.budget_centroid_table(cap),
                                      j_est.budget_centroid_table(cap))


@pytest.mark.parametrize("s", [J_BUDGET, J_SHORT], ids=lambda s: s.label)
@pytest.mark.parametrize("fault", [None, "mixed", "heavy"])
def test_budget_codes_counts_and_weights_are_repros(samples, s, fault):
    n = 100
    ts = _port(s)
    rates = s.channel.column_rates(n, D, s.rate)
    x = jnp.asarray(samples)
    xt = torch.from_numpy(samples.copy())
    jkw, tkw = dict(n_valid=n), dict(n_valid=n)
    if fault is not None:
        n_rows, _, _ = _faults(fault)
        jkw["n_rows"] = n_rows
        tkw["n_rows"] = _t(n_rows)
    want_c = np.asarray(j_est.budget_payload(x, s, rates, **jkw))
    got_c = t_est.budget_payload(xt, ts, rates, **tkw)
    assert got_c.dtype == torch.int8
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    want_v = np.asarray(j_est.budget_operand(jnp.asarray(want_c), s, rates))
    got_v = t_est.budget_operand(got_c, ts, rates)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    np.testing.assert_array_equal(
        t_est.budget_counts(rates, 128, device="cpu", **tkw).numpy(),
        np.asarray(j_est.budget_counts(rates, 128, **jkw)))
    want_g = np.asarray(j_est.resolve_engine(None).gram_batch(
        jnp.asarray(want_v)))
    got_g = t_est.resolve_engine(None).gram_batch(got_v).numpy()
    np.testing.assert_allclose(got_g, want_g, rtol=GRAM_TOL_PER_N,
                               atol=GRAM_TOL_PER_N * n)
    want_w = np.asarray(j_est.budget_weights_batch(x, s, rates, **jkw))
    got_w = t_est.strategy_weights_batch(xt, ts, rates=torch.from_numpy(
        rates), **tkw)
    np.testing.assert_allclose(got_w.numpy(), want_w, **F32_STAT_TOL)
    counts = t_est.budget_counts(rates, 128, device="cpu", **tkw)
    np.testing.assert_allclose(
        t_est.weights_from_gram(torch.from_numpy(want_g), counts,
                                ts).numpy(), want_w, **WEIGHT_TOL)
    # silent machines' features are voided to weight exactly 0
    assert (got_w.numpy()[want_w == 0] == 0).all()
    want_r = np.asarray(j_est.strategy_corr_batch(x, s, rates=rates, **jkw))
    got_r = t_est.strategy_corr_batch(xt, ts, rates=rates, **tkw)
    np.testing.assert_allclose(got_r.numpy(), want_r, **F32_STAT_TOL)


def test_budget_decode_masks_and_blocks(monkeypatch):
    """The mixed-rate decode block by block equals one block; MASKED_CODE
    and rate-0 columns decode to 0, out-of-range codes as repro's."""
    rng = np.random.default_rng(5)
    codes = rng.integers(-1, 16, size=(3, 50, 8)).astype(np.int8)
    rates = np.array([0, 1, 2, 3, 4, 4, 2, 1], np.int32)
    s = J_BUDGET
    want = np.asarray(j_est.budget_operand(jnp.asarray(codes), s, rates))
    got = t_est.budget_operand(torch.from_numpy(codes), _port(s), rates)
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(t_est, "_DECODE_BLOCK", 17)
    assert torch.equal(t_est.budget_operand(torch.from_numpy(codes),
                                            _port(s), rates), got)
    assert (got.numpy()[codes == -1] == 0).all()
    assert (got.numpy()[..., 0] == 0).all()


def test_budget_batch_needs_rates():
    ts = _port(J_BUDGET)
    for fn in (t_est.strategy_weights_batch, t_est.strategy_corr_batch):
        with pytest.raises(ValueError, match="rates"):
            fn(torch.zeros(2, 16, D), ts, n_valid=16)


# --------------------------------------------------------------------------
# Unbatched doors and learn_structure
# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [J_MAC, J_BUDGET, J_SHORT,
                               JStrategy("sign", channel=j_channel.MACChannel(
                                   8))], ids=lambda s: s.label)
def test_strategy_weights_and_learn_structure_are_repros(samples, s):
    x = samples[0]
    ts = _port(s)
    tol = WEIGHT_TOL if s.method == "sign" else F32_STAT_TOL
    want = np.asarray(j_est.strategy_weights(jnp.asarray(x), s))
    got = t_est.strategy_weights(torch.from_numpy(x), ts)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    want_c = np.asarray(j_est.strategy_corr(jnp.asarray(x), s))
    got_c = t_est.strategy_corr(torch.from_numpy(x), ts)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)
    for mst in ("kruskal", "boruvka"):
        sm = dataclasses.replace(s, mst=mst)
        assert t_cl.learn_structure(x, strategy=_port(sm), device="cpu") == \
            j_cl.learn_structure(x, strategy=sm)
    np.testing.assert_array_equal(
        t_cl.learn_structure_jit(x, _port(s), device="cpu").numpy(),
        np.asarray(j_cl.learn_structure_jit(jnp.asarray(x), s)))


# --------------------------------------------------------------------------
# Communication ledgers
# --------------------------------------------------------------------------

LEDGER_GRID = [
    JStrategy("sign"), JStrategy("sign", wire="packed"),
    JStrategy("persymbol", rate=4), JStrategy("original"),
    JStrategy("sign", channel=j_channel.MACChannel(4)),
    JStrategy("sign", channel=j_channel.MACChannel(2)),
    JStrategy("persymbol", rate=4, channel=j_channel.BudgetChannel(
        budget_bits=4 * 200 * 12, machines=4)),
    JStrategy("persymbol", rate=7, channel=j_channel.BudgetChannel(
        budget_bits=3 * 200 * 12, machines=2)),
    JStrategy("persymbol", rate=3, channel=j_channel.BudgetChannel(
        budget_bits=5, machines=3)),
]


@pytest.mark.parametrize("s", LEDGER_GRID, ids=lambda s: s.label)
@pytest.mark.parametrize("n,n_pad", [(200, 256), (250, 256), (256, None),
                                     (3, 8)])
def test_comm_report_is_repros(s, n, n_pad):
    want = WirePlan(s).comm_report(n, 12, n_pad=n_pad)
    got = t_dist.comm_report(_port(s), n, 12, n_pad=n_pad)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if got.machine_bits is not None:
        assert all(b >= 0 for b in got.machine_bits)
        if s.channel.kind == "budget":
            assert sum(got.machine_bits) == got.logical_bits \
                <= s.channel.budget_bits
