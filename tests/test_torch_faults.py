"""The port's fault plane (``repro_torch.core.faults`` and the masked-Gram
path of ``estimators``) against ``repro``'s, on the CPU.

The fault draws — delivered-row counts, bit-flip masks, telemetry — and
their keys are held bit for bit; the masked integer Grams bit for bit;
weights to ``WEIGHT_TOL`` (ROADMAP §3); a faulty sweep's metrics,
``TrialResult.faults`` and ``CommReport`` retry fields exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import estimators as j_est
from repro.core import experiments as je
from repro.core import faults as j_faults
from repro.core import sampler as j_sampler
from repro.core import strategy as j_strategy
from repro_torch.core import estimators as t_est
from repro_torch.core import experiments as te
from repro_torch.core import faults as t_faults
from repro_torch.interop import strategy_from_fields

WEIGHT_TOL = dict(rtol=1e-6, atol=2.5e-7)
GRAM_TOL_PER_N = 1e-5

FAULTS = {
    "mixed": dict(dropout=0.3, straggle=0.4, bitflip=0.05, retries=2,
                  machines=4, seed=3),
    # benchmarks/faults.py's mixed plan with its machines widened
    "bench": dict(dropout=0.15, straggle=0.3, straggle_frac=0.5,
                  bitflip=0.005, retries=1, machines=16, seed=1),
    "per-feature": dict(dropout=0.1, straggle=0.2, straggle_frac=0.25,
                        seed=9),
    "null": dict(machines=4, retries=1),
}
STRATEGIES = (j_strategy.Strategy("sign"),
              j_strategy.Strategy("sign", wire="packed"),
              j_strategy.Strategy("persymbol", rate=1),
              j_strategy.Strategy("persymbol", rate=2, wire="packed"),
              j_strategy.Strategy("persymbol", rate=4),
              j_strategy.Strategy("original"))


def _port(s):
    return strategy_from_fields(dataclasses.asdict(s))


def _key_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("kw", [
    dict(dropout=-0.1), dict(straggle=1.5), dict(bitflip=2.0),
    dict(straggle_frac=0.0), dict(straggle_frac=1.5), dict(retries=-1),
    dict(machines=0),
])
def test_fault_plan_validation_is_repros(kw):
    with pytest.raises(ValueError) as want:
        j_faults.FaultPlan(**kw)
    with pytest.raises(ValueError) as got:
        t_faults.FaultPlan(**kw)
    assert str(got.value) == str(want.value)


def test_fault_plan_properties_are_repros():
    for kw in FAULTS.values():
        jp, tp = j_faults.FaultPlan(**kw), t_faults.FaultPlan(**kw)
        assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
        assert (tp.is_null, tp.channels) == (jp.is_null, jp.channels)
        assert tp.n_machines(32) == jp.n_machines(32)
        np.testing.assert_array_equal(
            tp.feature_machines(32, device="cpu").numpy(),
            np.asarray(jp.feature_machines(32)))
    with pytest.raises(ValueError, match="divide"):
        t_faults.FaultPlan(machines=3).n_machines(32)
    with pytest.raises(TypeError, match="FaultPlan"):
        te.TrialPlan(d=8, ns=(16,), faults=dict(dropout=0.1))
    with pytest.raises(ValueError, match="divide"):
        te.TrialPlan(d=10, ns=(16,), faults=t_faults.FaultPlan(machines=4))
    # the MAC channel's row-block view is repro's, bit for bit
    jp, tp = j_faults.FaultPlan(**FAULTS["mixed"]), t_faults.FaultPlan(
        **FAULTS["mixed"])
    np.testing.assert_array_equal(
        tp.draw_rowblock_batch(t_faults.fault_trial_keys(tp, 5, device="cpu"),
                               64, 50, 4).numpy(),
        np.asarray(jp.draw_rowblock_batch(j_faults.fault_trial_keys(jp, 5),
                                          64, jnp.asarray(50, jnp.int32), 4)))


@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("n_pad,n_valid", [(40, 37), (64, 64)])
def test_draw_batch_is_bit_identical(name, n_pad, n_valid):
    d, reps = 32, 6
    jp = j_faults.FaultPlan(**FAULTS[name])
    tp = t_faults.FaultPlan(**FAULTS[name])
    jk = j_faults.fault_trial_keys(jp, reps)
    tk = t_faults.fault_trial_keys(tp, reps, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), _key_data(jk))
    want = jp.draw_batch(jk, n_pad, jnp.asarray(n_valid, jnp.int32), d)
    got = tp.draw_batch(tk, n_pad, n_valid, d)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[1] is None) == (want[1] is None)
    if got[1] is not None:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # bucket-stable: the flip rows of a shorter pad are a prefix
    if got[1] is not None and n_pad > n_valid:
        short = tp.draw_batch(tk, n_valid, n_valid, d)
        assert torch.equal(short[1], got[1][:, :n_valid])


@pytest.fixture(scope="module")
def samples():
    jp = je.TrialPlan(d=32, ns=(100,), reps=4)
    par, rho, _ = je.stacked_trees(jp)
    return np.asarray(j_sampler.sample_tree_ggm_rows_batch(
        je.trial_keys(jp), 128, par, rho))


@pytest.mark.parametrize("s", STRATEGIES, ids=lambda s: f"{s.label}-{s.wire}")
def test_masked_gram_weights_are_repros(samples, s):
    """repro's samples under repro's fault draws through the port's
    masked-Gram path: integer Grams bit for bit, float Grams and weights
    within the stated tolerances."""
    jp = j_faults.FaultPlan(**FAULTS["mixed"])
    n = 100
    n_rows, flip, _ = jp.draw_batch(j_faults.fault_trial_keys(jp, 4), 128,
                                    jnp.asarray(n, jnp.int32), 32)
    ts = _port(s)
    x = jnp.asarray(samples)
    jkw = dict(n_valid=n, n_rows=n_rows)
    tkw = dict(n_valid=n, n_rows=torch.from_numpy(np.asarray(n_rows)))
    tflip = torch.from_numpy(np.asarray(flip))
    want_g = np.asarray(j_est.payload_gram(
        j_est.strategy_payload(x, s, flip=flip, **jkw), s, **jkw))
    got_g = t_est.payload_gram(
        t_est.strategy_payload(torch.from_numpy(samples), ts, flip=tflip,
                               **tkw), ts, **tkw).numpy()
    if s.method == "sign" or s.rate == 1:
        np.testing.assert_array_equal(got_g, want_g)
    else:
        np.testing.assert_allclose(got_g, want_g, rtol=GRAM_TOL_PER_N,
                                   atol=GRAM_TOL_PER_N * n)
    want = np.asarray(j_est.strategy_weights_batch(x, s, flip=flip, **jkw))
    got = t_est.strategy_weights_batch(torch.from_numpy(samples), ts,
                                       flip=tflip, **tkw)
    np.testing.assert_allclose(got.numpy(), want, **WEIGHT_TOL)
    # the voided entries (a dropped machine's features) are exactly 0
    assert (got.numpy()[want == 0] == 0).all()


def test_zero_fault_plan_is_bit_identical_to_none():
    strategies = tuple(_port(s) for s in STRATEGIES[1:])
    plan = te.TrialPlan(d=32, ns=(100,), strategies=strategies, reps=4)
    null = dataclasses.replace(
        plan, faults=t_faults.FaultPlan(**FAULTS["null"]))
    parents, rhos, _, keys = te._plan_setup(*te._setup_key(plan), "cpu")
    fkeys = t_faults.fault_trial_keys(null.faults, 4, device="cpu")
    engine = te.GramEngine()
    w = te._stacked_weights(keys, parents, rhos, 100, strategies, 128,
                            engine)
    wf, tele = te._stacked_weights(keys, parents, rhos, 100, strategies, 128,
                                   engine, null.faults, fkeys)
    assert torch.equal(wf, w)
    assert not tele.any()
    a = te.run_trials(plan, device="cpu")
    b = te.run_trials(null, device="cpu")
    for field in ("error_rate", "edit_distance", "edge_f1", "buckets"):
        assert getattr(b, field) == getattr(a, field), field
    assert b.faults == [{"n": 100, "dropped_machines": 0.0,
                         "straggling_machines": 0.0,
                         "retransmissions": [0.0],
                         "retry_rounds_used": [0.0]}]


@pytest.mark.parametrize("mst", ["device", "host_kruskal"])
def test_faulty_run_trials_matches_repro(mst):
    strategies = (j_strategy.Strategy("sign", wire="packed"),
                  j_strategy.Strategy("persymbol", rate=4),
                  j_strategy.Strategy("original"))
    kw = dict(d=32, ns=(100, 250), reps=6, seed0=7)
    jp = je.TrialPlan(strategies=strategies,
                      faults=j_faults.FaultPlan(**FAULTS["bench"]), **kw)
    tp = te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                      faults=t_faults.FaultPlan(**FAULTS["bench"]), **kw)
    want = je.run_trials(jp, mst=mst)
    got = te.run_trials(tp, device="cpu", mst=mst)
    for field in ("error_rate", "edit_distance", "edge_f1", "buckets",
                  "faults", "host_syncs"):
        assert getattr(got, field) == getattr(want, field), field
    for label, reports in want.comm.items():
        for w, g in zip(reports, got.comm[label]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
    assert got.faults[0]["dropped_machines"] + got.faults[0][
        "straggling_machines"] > 0
    assert any(r.retry_bytes > 0 for r in got.comm["sign"])


# --------------------------------------------------------------------------
# The sparse plane under faults (tests/test_faults.py's sparse plan)
# --------------------------------------------------------------------------

SPARSE_FAULTS = dict(dropout=0.3, machines=4, seed=8)


def _sparse_fault_plans(faults=SPARSE_FAULTS, **kw):
    strategies = (j_strategy.Strategy("sign", structure="sparse", lam=0.1),)
    base = dict(d=8, ns=(64,), reps=6, seed0=3, tree="sparse")
    base.update(kw)
    return (je.TrialPlan(strategies=strategies,
                         faults=j_faults.FaultPlan(**faults), **base),
            te.TrialPlan(strategies=tuple(_port(s) for s in strategies),
                         faults=t_faults.FaultPlan(**faults), **base))


@pytest.mark.parametrize("faults", [SPARSE_FAULTS, FAULTS["mixed"]],
                         ids=["dropout", "mixed"])
def test_sparse_faulty_run_trials_matches_repro(faults):
    """The fault draws and telemetry bit for bit, the metrics under the
    near-threshold rule of tests/_sparse_parity.py."""
    import _sparse_parity

    jp, tp = _sparse_fault_plans(faults)
    want = je.run_trials(jp)
    got = te.run_trials(tp, device="cpu")
    assert got.faults == want.faults and got.faults is not None
    _sparse_parity.assert_sparse_sweeps_agree(jp, tp, want, got)
    for label, reports in want.comm.items():
        for w, g in zip(reports, got.comm[label]):
            assert dataclasses.asdict(g) == dataclasses.asdict(w)
    for lab in got.error_rate:
        assert all(np.isfinite(v) for v in got.error_rate[lab])


def test_sparse_zero_fault_plan_is_bit_identical_to_none():
    _, tp = _sparse_fault_plans(dict(machines=4, retries=1), d=16,
                                ns=(100, 300), reps=4, glasso_steps=100)
    tp = dataclasses.replace(tp, strategies=tuple(_port(s) for s in (
        j_strategy.Strategy("sign", wire="packed", structure="sparse",
                            lam=0.08),
        j_strategy.Strategy("persymbol", rate=4, structure="sparse",
                            lam=0.06),
        j_strategy.Strategy("original", structure="sparse", lam=0.06))))
    none = dataclasses.replace(tp, faults=None)
    chols, _, keys = te._sparse_plan_setup(*te._sparse_setup_key(tp), "cpu")
    fkeys = t_faults.fault_trial_keys(tp.faults, tp.reps, device="cpu")
    engine = te.GramEngine()
    c = te._stacked_corr(keys, chols, 100, tp.strategies, 128, engine)
    cf, tele = te._stacked_corr(keys, chols, 100, tp.strategies, 128, engine,
                                tp.faults, fkeys)
    assert torch.equal(cf, c) and not tele.any()
    a = te.run_trials(none, device="cpu")
    b = te.run_trials(tp, device="cpu")
    for field in ("error_rate", "edit_distance", "edge_f1", "precision",
                  "recall", "buckets", "host_syncs"):
        assert getattr(b, field) == getattr(a, field), field
