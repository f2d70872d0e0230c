"""Sweeps of the port's channel plane (``run_trials`` with MAC and budget
strategies, ``learn_structure``'s single-dataset doors) against
``repro``'s, on the CPU, on ``tests/test_channels.py``'s plans and
``benchmarks/channels.py``'s.

Every metric is a ratio of integer channel sums, so tree sweeps are held
equal: metrics, buckets, ``CommReport``s (rates and machine-bit ledgers
included), fault telemetry and ``host_syncs == 1``. Sparse sweeps are
held by ``tests/_sparse_parity.py``'s threshold rule.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.comm import channel as j_channel
from repro.core import experiments as je
from repro.core import faults as j_faults
from repro.core import sampler as j_sampler
from repro.core.faults import fault_trial_keys as j_fault_keys
from repro.core.gram import resolve_engine as j_engine
from repro.core.strategy import Strategy as JStrategy
from repro_torch.comm.channel import BudgetChannel, MACChannel
from repro_torch.core import experiments as te
from repro_torch.core import faults as t_faults
from repro_torch.core.strategy import Strategy
from repro_torch.interop import strategy_from_fields

RESULT_FIELDS = ("error_rate", "edit_distance", "edge_f1", "precision",
                 "recall", "buckets", "host_syncs", "faults", "tiling")


def _port(s) -> Strategy:
    return strategy_from_fields(dataclasses.asdict(s))


def _comm(result):
    return {k: [dataclasses.asdict(r) for r in v]
            for k, v in result.comm.items()}


def _plans(strategies, faults=None, **kw):
    return (je.TrialPlan(strategies=strategies, faults=None if faults is None
                         else j_faults.FaultPlan(**faults), **kw),
            te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                         faults=None if faults is None
                         else t_faults.FaultPlan(**faults), **kw))


def _assert_same(got, want):
    for field in RESULT_FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert _comm(got) == _comm(want)
    assert got.host_syncs == 1


#: tests/test_channels.py's plan: d = 12, four machines
TESTS_KW = dict(d=12, ns=(100, 230), reps=8, seed0=3)
TESTS_STRATEGIES = (
    JStrategy("sign"), JStrategy("persymbol", rate=4),
    JStrategy("sign", channel=j_channel.MACChannel(4)),
    JStrategy("persymbol", rate=4, channel=j_channel.BudgetChannel(
        budget_bits=4 * 100 * 12, machines=4)))
#: benchmarks/channels.py: d = 16, 4 machines, B = 6 * 512 * 16 (cap 4),
#: its two scenarios; ns cut to the bench's quick (128, 512)
BENCH_KW = dict(d=16, ns=(128, 512), reps=32, seed0=7)
BENCH_STRATEGIES = (
    JStrategy("sign"), JStrategy("persymbol", rate=4),
    JStrategy("sign", channel=j_channel.MACChannel(4)),
    JStrategy("persymbol", rate=4, channel=j_channel.BudgetChannel(
        budget_bits=6 * 512 * 16, machines=4)))
BENCH_FAULTS = dict(dropout=0.15, straggle=0.3, straggle_frac=0.5,
                    machines=4, seed=1)

SWEEPS = {
    "tests-pristine": (TESTS_STRATEGIES, None, TESTS_KW),
    "tests-faulty": (TESTS_STRATEGIES, dict(machines=4, dropout=0.25,
                                            straggle=0.3, seed=11),
                     TESTS_KW),
    "tests-retries": (TESTS_STRATEGIES, dict(machines=4, dropout=0.4,
                                             straggle=0.3, bitflip=0.02,
                                             retries=2, seed=5), TESTS_KW),
    "bench-pristine": (BENCH_STRATEGIES, None, BENCH_KW),
    "bench-faulty": (BENCH_STRATEGIES, BENCH_FAULTS, BENCH_KW),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_channel_run_trials_matches_repro(name):
    strategies, faults, kw = SWEEPS[name]
    jp, tp = _plans(strategies, faults, **kw)
    want = je.run_trials(jp)
    got = te.run_trials(tp, device="cpu")
    _assert_same(got, want)
    labels = [s.label for s in tp.strategies]
    assert any("@mac" in lab for lab in labels)
    assert any("@bgt" in lab for lab in labels)
    if faults is not None:
        assert any(f["dropped_machines"] + f["straggling_machines"] > 0
                   for f in got.faults)
        assert all(np.isfinite(v).all() for v in got.error_rate.values())
    if faults is not None and faults.get("retries"):
        assert any(r.retry_bytes > 0 for r in got.comm["sign@mac4"])
    for c in got.comm[labels[3]]:
        assert sum(c.machine_bits) == c.logical_bits \
            <= tp.strategies[3].channel.budget_bits


def test_channel_host_kruskal_matches_repro():
    strategies, faults, kw = SWEEPS["tests-faulty"]
    jp, tp = _plans(strategies, faults, **dict(kw, reps=4))
    want = je.run_trials(jp, mst="host_kruskal")
    got = te.run_trials(tp, device="cpu", mst="host_kruskal")
    _assert_same(got, want)
    device = te.run_trials(tp, device="cpu")
    for field in ("error_rate", "edit_distance", "edge_f1", "faults"):
        assert getattr(device, field) == getattr(got, field), field


def test_mac_lossless_equals_gather_and_budget_at_full_rate_equals_r4():
    """tests/test_channels.py's identities on the port: lossless MAC is
    the gather sign statistic bit for bit, a budget that lets every
    machine reach the cap is plain R4 bit for bit (both contract the same
    decoded f32 values on the CPU), and channel strategies joining a plan
    leave the gather columns as they were."""
    cap, d = 4, 12
    strategies = (Strategy("sign"), Strategy("persymbol", rate=cap),
                  Strategy("sign", channel=MACChannel(4)),
                  Strategy("persymbol", rate=cap, channel=BudgetChannel(
                      budget_bits=cap * 230 * d, machines=4)))
    mixed = te.TrialPlan(d=d, ns=(100, 230), reps=8, seed0=3,
                         strategies=strategies)
    parents, rhos, _, keys = te._plan_setup(*te._setup_key(mixed), "cpu")
    for n in mixed.ns:
        w = te._stacked_weights(
            keys, parents, rhos, n, strategies, mixed.bucket_for(n),
            te.GramEngine(), rates=te._rates_operand(strategies, n, d, "cpu"))
        assert torch.equal(w[2], w[0]) and torch.equal(w[3], w[1])
    res = te.run_trials(mixed, device="cpu")
    lab_mac, lab_bgt = strategies[2].label, strategies[3].label
    for tbl in (res.error_rate, res.edit_distance, res.edge_f1):
        assert tbl[lab_mac] == tbl["sign"] and tbl[lab_bgt] == tbl["R4"]
    alone = te.run_trials(dataclasses.replace(
        mixed, strategies=strategies[:2]), device="cpu")
    for tbl_a, tbl_b in ((alone.error_rate, res.error_rate),
                         (alone.edit_distance, res.edit_distance),
                         (alone.edge_f1, res.edge_f1)):
        assert tbl_a["sign"] == tbl_b["sign"] and tbl_a["R4"] == tbl_b["R4"]


def test_channel_zero_fault_plan_is_bit_identical_to_none():
    strategies = tuple(_port(s) for s in TESTS_STRATEGIES)
    plan = te.TrialPlan(strategies=strategies, **TESTS_KW)
    null = dataclasses.replace(plan, faults=t_faults.FaultPlan(machines=4,
                                                               retries=1))
    parents, rhos, _, keys = te._plan_setup(*te._setup_key(plan), "cpu")
    fkeys = t_faults.fault_trial_keys(null.faults, plan.reps, device="cpu")
    rates = te._rates_operand(strategies, 100, plan.d, "cpu")
    w = te._stacked_weights(keys, parents, rhos, 100, strategies, 128,
                            te.GramEngine(), rates=rates)
    wf, tele = te._stacked_weights(keys, parents, rhos, 100, strategies,
                                   128, te.GramEngine(), null.faults, fkeys,
                                   rates)
    assert torch.equal(wf, w) and not tele.any()
    a = te.run_trials(plan, device="cpu")
    b = te.run_trials(null, device="cpu")
    for field in ("error_rate", "edit_distance", "edge_f1", "buckets"):
        assert getattr(b, field) == getattr(a, field), field


def test_rates_and_channel_operands():
    strategies = tuple(_port(s) for s in TESTS_STRATEGIES)
    assert te._rates_operand(strategies[:3], 100, 12, "cpu") is None
    rates = te._rates_operand(strategies, 230, 12, "cpu")
    assert rates.dtype == torch.int32 and rates.shape == (4, 12)
    np.testing.assert_array_equal(
        rates[3].numpy(), TESTS_STRATEGIES[3].channel.column_rates(230, 12,
                                                                   4))
    fp = t_faults.FaultPlan(machines=4, dropout=0.5, seed=2)
    fkeys = t_faults.fault_trial_keys(fp, 8, device="cpu")
    ops = te._channel_operands(strategies, rates, fp, fkeys, 256, 230)
    assert ops[0] == ops[1] == {}
    assert torch.equal(ops[2]["delivered"],
                       fp.draw_rowblock_batch(fkeys, 256, 230, 4))
    assert ops[3]["rates"] is not None and "delivered" not in ops[3]


# --------------------------------------------------------------------------
# The sparse plane and the single-dataset doors
# --------------------------------------------------------------------------

J_SPARSE = (
    JStrategy("sign", structure="sparse", lam=0.08),
    JStrategy("sign", structure="sparse", lam=0.08,
              channel=j_channel.MACChannel(4)),
    JStrategy("persymbol", rate=4, structure="sparse", lam=0.06,
              channel=j_channel.BudgetChannel(budget_bits=3 * 300 * 12,
                                              machines=4)))


def _repro_corr(jplan, n):
    """``repro``'s (S, r, d, d) statistics of one point with the budget
    channels' rates operand (``_sparse_parity.repro_corr`` for channel
    plans)."""
    chols, _, keys = je._sparse_plan_setup(*je._sparse_setup_key(jplan))
    lead = () if jplan.faults is None else (
        j_fault_keys(jplan.faults, jplan.reps),)
    tail = ((je._rates_operand(jplan.strategies, n, jplan.d),)
            if je._needs_rates(jplan.strategies) else ())
    out = je._corr_stage(jplan.strategies, jplan.bucket_for(n),
                         j_engine(None), jplan.faults)(
        keys, *lead, chols, jnp.asarray(n, jnp.int32), *tail)
    return np.asarray(out if jplan.faults is None else out[0])


@pytest.mark.parametrize("faults", [None, dict(machines=4, dropout=0.3,
                                               straggle=0.3, seed=4)])
def test_sparse_channel_sweep_matches_repro(monkeypatch, faults):
    import _sparse_parity

    monkeypatch.setattr(_sparse_parity, "repro_corr", _repro_corr)
    jp, tp = _plans(J_SPARSE, faults, d=12, ns=(300, 900), tree="sparse",
                    density=0.25, reps=6, glasso_steps=150)
    want = je.run_trials(jp)
    got = te.run_trials(tp, device="cpu")
    _sparse_parity.assert_sparse_sweeps_agree(jp, tp, want, got)
    assert _comm(got) == _comm(want)
    # the sparse corr stage of a lossless MAC strategy is the gather's
    if faults is None:
        chols, _, keys = te._sparse_plan_setup(*te._sparse_setup_key(tp),
                                               "cpu")
        corr = te._stacked_corr(keys, chols, 300, tp.strategies[:2], 512,
                                te.GramEngine())
        assert torch.equal(corr[0], corr[1])


def test_channel_evaluate_strategies_matches_repro():
    jp = je.TrialPlan(d=16, ns=(512,), reps=1, seed0=2)
    par, rho, adj = je.stacked_trees(jp)
    x = np.array(j_sampler.sample_tree_ggm_rows_batch(
        je.trial_keys(jp), 512, par, rho))[0]
    strategies = BENCH_STRATEGIES + (JStrategy(
        "persymbol", rate=3, channel=j_channel.BudgetChannel(
            budget_bits=2 * 512 * 16, machines=8)),)
    want = je.evaluate_strategies(jnp.asarray(x), adj[0], strategies)
    got = te.evaluate_strategies(x, np.asarray(adj[0]),
                                 [_port(s) for s in strategies],
                                 device="cpu")
    assert got == want
    for s in strategies[2:]:
        np.testing.assert_array_equal(
            te.learned_adjacency(torch.from_numpy(x), _port(s)).numpy(),
            np.asarray(je.learned_adjacency(jnp.asarray(x), s)))
    sparse = JStrategy("sign", structure="sparse", lam=0.08,
                       channel=j_channel.MACChannel(4))
    np.testing.assert_array_equal(
        te.learned_adjacency(torch.from_numpy(x), _port(sparse),
                             glasso_steps=60).numpy(),
        te.learned_adjacency(torch.from_numpy(x), _port(dataclasses.replace(
            sparse, channel=j_channel.GATHER)), glasso_steps=60).numpy())
