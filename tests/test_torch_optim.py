"""The port's optimizers, schedules and token stream against ``repro``'s.

AdamW (f32, and bf16 parameters with f32 moments), SGD (plain and
Nesterov), ``global_norm`` / ``clip_by_global_norm`` and the three
schedules run on identical numpy inputs in both packages, on the CPU.
Both evaluate the same f32 operations in the same order; what may differ
is the last ulp of a transcendental (``b**step`` in the bias corrections,
the schedules' ``cos``) and of a sum's order, so the results are held to
``rtol=4e-7`` (a few f32 ulps) and the integer-valued pieces (a warm-up
step's learning rate, the step count) exactly; a schedule also to
``1e-7`` of its peak rate, where ``1 + cos`` cancels near the end of a
decay to 0. ``TokenStream`` batches
and ``unigram_entropy_bound`` are equal bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jo
from repro.data.tokens import TokenStream as JTokenStream
from repro_torch import optim as to
from repro_torch.data import TokenStream, token_batches

RTOL = 4e-7


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((7, 5)).astype(dtype),
            "b": {"c": rng.standard_normal((13,)).astype(dtype),
                  "d": rng.standard_normal((3, 4, 2)).astype(dtype)}}


def _leaves(tree):
    return [tree["a"], tree["b"]["c"], tree["b"]["d"]]


def _params(tree, dtype):
    return [torch.nn.Parameter(torch.tensor(np.asarray(a, np.float32),
                                            dtype=dtype))
            for a in _leaves(tree)]


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("param_dtype", ["f32", "bf16"])
def test_adamw_matches_repro(param_dtype):
    jdt = jnp.float32 if param_dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if param_dtype == "f32" else torch.bfloat16
    params = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(0))
    jopt = jo.adamw()
    state = jopt.init(params)
    tparams = _params(jax.tree.map(np.asarray, params), tdt)
    opt = to.AdamW(tparams)
    assert opt.step_count == 0
    for step in range(5):
        grads = jax.tree.map(lambda a: jnp.asarray(a, jdt), _tree(10 + step))
        lr = jnp.float32(1e-2 * (step + 1))
        params, state = jopt.update(grads, state, params, lr)
        opt.step(float(lr), [torch.tensor(np.asarray(g, np.float32),
                                          dtype=tdt)
                             for g in _leaves(jax.tree.map(np.asarray,
                                                           grads))])
    assert opt.step_count == int(state.step) == 5
    named = [(str(i), p) for i, p in enumerate(tparams)]
    tree = opt.state_tree(named)
    for i, (jp, p) in enumerate(zip(_leaves(params), tparams)):
        assert p.dtype == tdt
        # bf16: the same f32 update rounded once to bf16
        np.testing.assert_allclose(_np(p), np.asarray(jp, np.float32),
                                   rtol=RTOL, atol=0)
        for m in ("mu", "nu"):
            got = tree["moments"][m][str(i)]
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                _np(got), np.asarray(_leaves(state.moments[m])[i]),
                rtol=RTOL, atol=0)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_matches_repro(nesterov):
    params = jax.tree.map(jnp.asarray, _tree(1))
    jopt = jo.sgd(momentum=0.9, nesterov=nesterov)
    state = jopt.init(params)
    tparams = _params(jax.tree.map(np.asarray, params), torch.float32)
    opt = to.SGD(tparams, momentum=0.9, nesterov=nesterov)
    for step in range(4):
        grads = _tree(20 + step)
        params, state = jopt.update(jax.tree.map(jnp.asarray, grads), state,
                                    params, jnp.float32(0.05))
        opt.step(0.05, [torch.from_numpy(g) for g in _leaves(grads)])
    assert opt.step_count == int(state.step) == 4
    for jp, p in zip(_leaves(params), tparams):
        np.testing.assert_allclose(_np(p), np.asarray(jp), rtol=RTOL,
                                   atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_repro(max_norm):
    tree = _tree(2)
    jclipped, jnorm = jo.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                             max_norm)
    clipped, norm = to.clip_by_global_norm(
        [torch.from_numpy(a) for a in _leaves(tree)], max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=RTOL)
    np.testing.assert_allclose(float(to.global_norm(clipped)),
                               float(jo.global_norm(jclipped)), rtol=RTOL)
    for got, want in zip(clipped, _leaves(jclipped)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=1e-7)
    if max_norm > float(jnorm):      # under the limit: unchanged
        for got, a in zip(clipped, _leaves(tree)):
            np.testing.assert_array_equal(got.numpy(), a)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("cosine_decay", (1e-3, 50)),
    ("cosine_decay", (1e-3, 50, 0.0)),
    ("linear_warmup_cosine", (3e-4, 20, 100)),
    ("linear_warmup_cosine", (1e-3, 1, 3)),
])
def test_schedules_match_repro(name, args):
    jf, tf = getattr(jo, name)(*args), getattr(to, name)(*args)
    for step in range(0, 130):
        want = np.float32(jf(jnp.int32(step)))
        got = tf(step)
        assert isinstance(got, np.float32)
        # near the end of a decay to 0, 1 + cos cancels: an ulp of cos
        # is ~6e-8 of the peak rate there
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7 * args[0])
    if name == "linear_warmup_cosine":
        assert tf(0) == 0.0    # the first update's rate under warm-up


def test_adamw_first_step_lr_zero_keeps_params():
    p = torch.nn.Parameter(torch.ones(4))
    opt = to.AdamW([p])
    opt.step(to.linear_warmup_cosine(1e-3, 2, 6)(opt.step_count),
             [torch.full((4,), 3.0)])
    assert torch.equal(p.detach(), torch.ones(4)) and opt.step_count == 1


@pytest.mark.parametrize("vocab,seq,batch,seed", [
    (1024, 48, 2, 0), (50304, 16, 3, 7)])
def test_token_stream_bit_identical(vocab, seq, batch, seed):
    js = JTokenStream(vocab=vocab, seq_len=seq, global_batch=batch,
                      seed=seed)
    ts = TokenStream(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    assert ts.unigram_entropy_bound() == js.unigram_entropy_bound()
    for step in (0, 1, 5):
        want, got = js.batch(step), ts.batch(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("prefetch", [0, 3])
def test_token_batches_in_order_on_device(prefetch):
    ts = TokenStream(vocab=512, seq_len=12, global_batch=2, seed=3)
    it = token_batches(ts, 4, device="cpu", prefetch=prefetch)
    try:
        for step in range(4, 9):
            got, want = next(it), ts.batch(step)
            assert got["tokens"].dtype == torch.int64
            assert got["mask"].dtype == torch.float32
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        it.close()
    # a bounded stream ends at ``stop`` (and draws nothing past it)
    got = list(token_batches(ts, 2, device="cpu", prefetch=prefetch, stop=5))
    assert len(got) == 3
    np.testing.assert_array_equal(got[-1]["labels"].numpy(),
                                  ts.batch(4)["labels"])
