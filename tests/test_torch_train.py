"""The port's LM training path against ``repro``'s, on the CPU.

``repro``'s params and ``OptState`` cross over as numpy
(``interop.lm_params_from_numpy``, ``interop.opt_state_from_numpy``);
the batches are ``repro``'s ``TokenStream``'s (the port's are equal bit
for bit, ``tests/test_torch_optim.py``). ``repro`` runs its default jnp
attention route (``_flash_attn``, the one its training differentiates),
the port the plain version of ``flash_prefill`` with its chunked
backward. All in f32. Tolerances, from the measured differences:

* step-1 gradients: ``rtol=1e-5`` and ``2e-5`` of each leaf's largest
  entry (the softmax in another order, sums in another order);
* three steps of ``make_train_step``: loss and grad norm within
  ``rtol=2e-6``, the learning rate exactly, the parameters within
  ``atol=5e-6`` at lr 1e-3 (measured ~8e-7; AdamW's first update is
  lr * sign(g), so an element whose gradient differs in sign would be
  2 lr = 2e-3 off);
* a resumed run equals the straight run bit for bit.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import optim as jo
from repro.data.tokens import TokenStream as JTokenStream
from repro.launch import steps as jsteps
from repro.launch.shapes import SHAPES as JSHAPES
from repro.launch.shapes import InputShape as JInputShape
from repro.launch.shapes import reduced_shape as j_reduced_shape
from repro.models import transformer as T
from repro.models.arch import ArchConfig as JArchConfig
from repro.models.arch import LayerSpec as JLayerSpec
from repro.models.arch import get_arch as j_get_arch
from repro_torch import interop
from repro_torch import optim as to
from repro_torch.launch import shapes as t_shapes
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

#: vocab 500 pads to 512: padded-vocab columns get exactly zero gradients
GQA = JArchConfig(name="gqa-train", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=500, head_dim=16,
                  pattern=(JLayerSpec(mixer="attn", ff="mlp"),),
                  rope_theta=1e4)
CONFIGS = {"stablelm-3b-reduced": j_get_arch("stablelm-3b").reduced(),
           "gqa": GQA}
B, S, LR = 2, 64, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_np(jcfg, step, b=B, s=S):
    return JTokenStream(vocab=jcfg.vocab, seq_len=s, global_batch=b,
                        seed=0).batch(step)


def _batch_t(nb):
    return {k: torch.from_numpy(v).to(torch.int64 if v.dtype == np.int32
                                      else torch.float32)
            for k, v in nb.items()}


def _setup(jcfg):
    """(repro params, repro OptState, port cfg, port model, port AdamW),
    the port's state carried across from repro's."""
    params = T.init_params(jcfg, jax.random.key(0))
    jopt = jo.adamw()
    state = jopt.init(params)
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    model = interop.lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device="cpu")
    model.requires_grad_(True)
    opt = to.AdamW(model.parameters())
    interop.opt_state_from_numpy(cfg, model, opt,
                                 jax.tree.map(np.asarray, state._asdict()))
    return params, jopt, state, cfg, model, opt


def _close_tree(got: dict, want, rtol, atol_frac=0.0, atol=0.0):
    flat_w = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, want))[0]
    flat_g = jax.tree.leaves(got)
    assert len(flat_w) == len(flat_g)
    for (path, w), g in zip(flat_w, flat_g):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            g, w, rtol=rtol, atol=atol + atol_frac * float(np.abs(w).max()),
            err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_step1_gradients_match_repro(name):
    jcfg = CONFIGS[name]
    params, _, _, cfg, model, _ = _setup(jcfg)
    nb = _batch_np(jcfg, 0)

    def jloss(p):
        h, _ = T.forward(jcfg, p, jnp.asarray(nb["tokens"]))
        return T.lm_loss(jcfg, p, h, jnp.asarray(nb["labels"]),
                         jnp.asarray(nb["mask"]))

    want_loss, want = jax.value_and_grad(jloss)(params)
    tb = _batch_t(nb)
    h, aux = model(tb["tokens"])
    loss = model.lm_loss(h, tb["labels"], tb["mask"])
    assert float(aux) == 0.0
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in
                                       model.named_parameters()])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=2e-6)
    got = interop.lm_tree_from_named(cfg, dict(zip(names, grads)))
    _close_tree(got, want, rtol=1e-5, atol_frac=2e-5)
    # embedding rows no token touches, and padded-vocab columns: exactly 0
    g = dict(zip(names, grads))
    unseen = np.setdiff1d(np.arange(cfg.padded_vocab), nb["tokens"])
    assert unseen.size and torch.all(g["embed"][unseen] == 0)
    assert np.all(np.asarray(want["embed"])[unseen] == 0)
    if cfg.padded_vocab > cfg.vocab:
        assert torch.all(g["unembed"][:, cfg.vocab:] == 0)
        assert np.all(np.asarray(want["unembed"])[:, cfg.vocab:] == 0)


def _run_both(jcfg, steps, warmup, microbatches=1, port_mb=None):
    """``steps`` train steps of each package from the same state: (repro
    metrics, port metrics, repro params, port model, cfg, ...)."""
    params, jopt, state, cfg, model, opt = _setup(jcfg)
    jshape = JInputShape("cli", "train", S, B)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, jshape, jopt, jo.linear_warmup_cosine(LR, warmup, steps),
        microbatches=microbatches))
    tstep = tsteps.make_train_step(
        cfg, t_shapes.InputShape("cli", "train", S, B),
        to.linear_warmup_cosine(LR, warmup, steps),
        microbatches=microbatches if port_mb is None else port_mb)
    jms, tms = [], []
    for i in range(steps):
        nb = _batch_np(jcfg, i)
        params, state, jm = jstep(params, state,
                                  {k: jnp.asarray(v) for k, v in nb.items()})
        jms.append({k: float(v) for k, v in jm.items()})
        tms.append({k: float(v) for k, v in
                    tstep(model, opt, _batch_t(nb)).items()})
    return jms, tms, params, state, cfg, model, opt


def _close_metrics(tms, jms):
    for t, j in zip(tms, jms):
        assert t["lr"] == j["lr"]
        assert t["moe_aux"] == j["moe_aux"] == 0.0
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-6)
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"],
                                   rtol=2e-6)


def test_three_steps_match_repro():
    jms, tms, params, state, cfg, model, opt = _run_both(
        CONFIGS["stablelm-3b-reduced"], 3, 1)
    assert tms[0]["lr"] == 0.0 and tms[1]["lr"] == np.float32(LR)
    _close_metrics(tms, jms)
    _close_tree(interop.lm_params_to_numpy(model), params, rtol=0,
                atol=5e-6)
    ost = interop.opt_state_to_numpy(cfg, model, opt)
    assert int(ost["step"]) == int(state.step) == 3
    for m in ("mu", "nu"):   # moments: sums of gradients (rel. to max)
        _close_tree(ost["moments"][m], state.moments[m], rtol=1e-4,
                    atol_frac=1e-4)


def test_microbatched_step_matches_repro_and_full_batch():
    jcfg = CONFIGS["gqa"]
    jms, tms, params, *_ , model, _ = _run_both(jcfg, 2, 1, microbatches=2)
    _close_metrics(tms, jms)
    _close_tree(interop.lm_params_to_numpy(model), params, rtol=0,
                atol=5e-6)
    # the port's own full batch: the same gradient, summed otherwise
    _, full, *_, full_model, _ = _run_both(jcfg, 2, 1, port_mb=1)
    for a, b in zip(tms, full):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-6)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=2e-6)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              full_model.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=5e-6, msg=n)


class _Preempted(Exception):
    pass


def test_resume_is_bit_identical(tmp_path):
    kw = dict(reduced=True, steps=4, batch=2, seq=32, lr=LR, warmup=1,
              device="cpu", log_every=100)
    straight = ttrain.train("stablelm-3b", **kw)

    def preempt(step, *_):
        if step == 1:
            raise _Preempted

    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(_Preempted):
        ttrain.train("stablelm-3b", ckpt_dir=ckpt, ckpt_every=2,
                     on_step=preempt, **kw)
    resumed = ttrain.train("stablelm-3b", ckpt_dir=ckpt, ckpt_every=2, **kw)
    assert resumed.start == 2 and len(resumed.losses) == 2
    assert resumed.losses == straight.losses[2:]
    assert resumed.optimizer.step_count == straight.optimizer.step_count == 4
    named_a = list(straight.model.named_parameters())
    named_b = list(resumed.model.named_parameters())
    for (n, a), (_, b) in zip(named_a, named_b):
        assert torch.equal(a, b), n
    ta = straight.optimizer.state_tree(named_a)["moments"]
    tb = resumed.optimizer.state_tree(named_b)["moments"]
    for m in ta:
        for n in ta[m]:
            assert torch.equal(ta[m][n], tb[m][n]), (m, n)


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b",
                                  "seamless-m4t-large-v2"])
def test_resume_with_stub_embeds_is_bit_identical(arch, tmp_path):
    """The trainer on a vision-prefixed and an encoder-decoder model: 3
    steps straight, and 2 + checkpoint + resume, give the same losses,
    parameters (the encoder's and the cross layers' included) and
    moments bit for bit (each step's embeddings are a function of (seed,
    step))."""
    kw = dict(reduced=True, steps=3, batch=2, seq=32, lr=LR, warmup=1,
              device="cpu", log_every=100)
    straight = ttrain.train(arch, **kw)
    assert all(np.isfinite(straight.losses))

    def preempt(step, *_):
        if step == 1:
            raise _Preempted

    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(_Preempted):
        ttrain.train(arch, ckpt_dir=ckpt, ckpt_every=2, on_step=preempt,
                     **kw)
    resumed = ttrain.train(arch, ckpt_dir=ckpt, ckpt_every=2, **kw)
    assert resumed.start == 2 and resumed.losses == straight.losses[2:]
    named_a = list(straight.model.named_parameters())
    named_b = list(resumed.model.named_parameters())
    assert any(n.startswith(("enc_layers.", "layers.0.cross."))
               for n, _ in named_a) == (arch == "seamless-m4t-large-v2")
    for (n, a), (_, b) in zip(named_a, named_b):
        assert torch.equal(a, b), n
    ta = straight.optimizer.state_tree(named_a)["moments"]
    tb = resumed.optimizer.state_tree(named_b)["moments"]
    for m in ta:
        for n in ta[m]:
            assert torch.equal(ta[m][n], tb[m][n]), (m, n)


def test_step_embeds_match_jax_random():
    """The trainer's stub embeddings of a step within 2^-21 (relative) of
    ``repro``'s ``0.02 * jax.random.normal(fold_in(key(seed), step))``
    (``key(seed + 1)`` for the encoder's frames), sign for sign."""
    for arch, name, seed, step, rows in (
            ("llava-next-mistral-7b", "modal_embeds", 0, 0, 8),
            ("seamless-m4t-large-v2", "enc_embeds", 0, 0, 16),
            ("seamless-m4t-large-v2", "enc_embeds", 3, 5, 16)):
        jcfg = j_get_arch(arch).reduced()
        cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
        got = ttrain.step_embeds(cfg, seed, step, 2, 64, "cpu")
        assert list(got) == [name]
        k = jax.random.fold_in(jax.random.key(
            seed + (name == "enc_embeds")), step)
        want = np.asarray(0.02 * jax.random.normal(
            k, (2, rows, jcfg.d_model)))
        g = got[name].numpy()
        assert g.shape == want.shape and g.dtype == np.float32
        np.testing.assert_array_equal(np.sign(g), np.sign(want))
        np.testing.assert_allclose(g, want, rtol=2.0 ** -21, atol=0)
    gqa = interop.arch_from_fields(dataclasses.asdict(GQA))
    assert ttrain.step_embeds(gqa, 0, 0, 2, 64, "cpu") == {}


def test_train_main_loss_falls(capsys):
    res = ttrain.main(["--arch", "stablelm-3b", "--reduced", "--device",
                       "cpu", "--steps", "20", "--batch", "2", "--seq", "64",
                       "--log-every", "10"])
    out = capsys.readouterr().out
    assert "step    20 loss" in out and "unigram entropy bound" in out
    assert all(np.isfinite(res.losses)) and all(np.isfinite(res.grad_norms))
    assert res.lrs[0] == 0.0
    assert res.final_loss < res.losses[0] - 0.5
    # repro's size check: a 2x1 mesh on a one-rank world
    with pytest.raises(ValueError, match="requested 2x1 mesh on 1 devices"):
        ttrain.main(["--arch", "stablelm-3b", "--reduced", "--device", "cpu",
                     "--data-par", "2"])


@pytest.mark.parametrize("arch,shape", [
    ("stablelm-3b", "train_4k"), ("granite-8b", "train_4k"),
    ("stablelm-3b", "prefill_32k")])
def test_auto_microbatches_matches_repro_on_one_shard(arch, shape):
    mesh = jax.make_mesh((1,), ("data",))
    jcfg = j_get_arch(arch)
    cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
    assert tsteps.auto_microbatches(cfg, t_shapes.SHAPES[shape]) == \
        jsteps.auto_microbatches(jcfg, JSHAPES[shape], mesh)
    assert dataclasses.asdict(t_shapes.reduced_shape(
        t_shapes.SHAPES[shape])) == dataclasses.asdict(
            j_reduced_shape(JSHAPES[shape]))


def test_stub_step_helpers_match_repro():
    for arch in ("llava-next-mistral-7b", "llama4-scout-17b-a16e",
                 "seamless-m4t-large-v2", "granite-8b"):
        jcfg = j_get_arch(arch)
        cfg = interop.arch_from_fields(dataclasses.asdict(jcfg))
        for shape in JSHAPES.values():
            tshape = t_shapes.SHAPES[shape.name]
            assert tsteps.modal_tokens(cfg) == jsteps.modal_tokens(jcfg)
            assert tsteps.encoder_frames(cfg, tshape) == \
                jsteps.encoder_frames(jcfg, shape)
            assert tsteps.text_len(cfg, tshape) == \
                jsteps.text_len(jcfg, shape)


def test_prefill_and_serve_steps_drive_the_model():
    jcfg = CONFIGS["gqa"]
    _, _, _, cfg, model, _ = _setup(jcfg)
    shape = t_shapes.InputShape("cli", "prefill", 16, 2)
    tokens = torch.from_numpy(_batch_np(jcfg, 0, 2, 16)["tokens"]).long()
    logits, cache = tsteps.make_prefill_step(cfg, shape)(
        model, {"tokens": tokens})
    want, _ = model.prefill(tokens)
    assert torch.equal(logits, want)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    nxt, _ = tsteps.make_serve_step(cfg, shape)(model, cache, tok, 16)
    assert nxt.shape == (2, 1, cfg.padded_vocab)
