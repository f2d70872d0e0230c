"""The port's StreamingGram against ``repro``'s on shared numpy inputs.

Sign and packed accumulators are bit-identical; per-symbol R >= 2 agrees
with ``repro``'s f32 route to rtol=1e-5, atol=1e-5*n (the reduction order
differs); the learned edge lists are equal. Both of the port's CPU
routes are held: ``torch`` (what ``auto`` picks on the CPU) and
``kernel`` (the kernels' plain versions, what the card replaces).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.chow_liu import learn_structure as j_learn
from repro.core.quantizers import pack_codes as j_pack
from repro.core.streaming import StreamingGram as JStream
from repro_torch.core import StreamingGram, Strategy
from repro_torch.core.chow_liu import learn_structure
from repro_torch.core.gram import GramEngine

D = 12
BACKENDS = ("torch", "kernel")


def _eng(backend):
    return GramEngine(backend=backend, device="cpu")


def _chain(rng, n, d=D, rho=0.7):
    """(n, d) f32 samples of a chain GGM, columns shuffled."""
    z = rng.standard_normal((n, d))
    x = np.empty_like(z)
    x[:, 0] = z[:, 0]
    for j in range(1, d):
        x[:, j] = rho * x[:, j - 1] + np.sqrt(1 - rho * rho) * z[:, j]
    return x[:, rng.permutation(d)].astype(np.float32)


def _packed(bits):
    """(n, d) {0,1} -> (d, ceil(n/8)) packed, zero tail bits."""
    n, d = bits.shape
    pad = np.zeros(((-n) % 8, d), np.uint8)
    return np.asarray(j_pack(np.concatenate([bits.astype(np.uint8), pad]).T,
                             1))


def _same(port, ref):
    np.testing.assert_array_equal(port.gram.numpy(), np.asarray(ref.gram))
    assert port.n == ref.n


def _close(port, ref):
    assert port.n == ref.n
    np.testing.assert_allclose(port.gram.numpy(), np.asarray(ref.gram),
                               rtol=1e-5, atol=1e-5 * ref.n)


BATCHES = (100, 37, 64)   # ragged last batches


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method", ["sign", "original"])
def test_update_raw_batches(backend, method):
    rng = np.random.default_rng(1)
    a = StreamingGram(d=D, method=method, engine=_eng(backend))
    b = JStream(d=D, method=method)
    for n in BATCHES:
        x = _chain(rng, n)
        a.update(torch.from_numpy(x))
        b.update(jnp.asarray(x))
    if method == "sign":
        _same(a, b)
    else:
        _close(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rate", [2, 4, 7])
def test_update_persymbol_raw_batches(backend, rate):
    rng = np.random.default_rng(rate)
    a = StreamingGram(d=D, method="persymbol", rate=rate,
                      engine=_eng(backend))
    b = JStream(d=D, method="persymbol", rate=rate)
    for n in BATCHES:
        x = _chain(rng, n)
        a.update(x)            # numpy goes to the engine's device
        b.update(jnp.asarray(x))
    _close(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("wire", ["pm1", "bits"])
def test_update_codes_sign(backend, wire):
    rng = np.random.default_rng(2)
    a = StreamingGram(d=D, engine=_eng(backend))
    b = JStream(d=D)
    for n in BATCHES:
        bits = rng.integers(0, 2, (n, D)).astype(np.int8)
        c = bits if wire == "bits" else 2 * bits - 1
        a.update_codes(c)
        b.update_codes(jnp.asarray(c))
    _same(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rate", [1, 2, 4, 7])
def test_update_codes_persymbol(backend, rate):
    rng = np.random.default_rng(10 + rate)
    a = StreamingGram(d=D, method="persymbol", rate=rate,
                      engine=_eng(backend))
    b = JStream(d=D, method="persymbol", rate=rate)
    for n in BATCHES:
        c = rng.integers(0, 1 << rate, (n, D)).astype(np.int8)
        a.update_codes(torch.from_numpy(c))
        b.update_codes(jnp.asarray(c))
    if rate == 1:
        _same(a, b)    # c^2 * integer sign Gram on both
    else:
        _close(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [64, 37, 1])
def test_update_packed(backend, n):
    rng = np.random.default_rng(n)
    a = StreamingGram(d=D, engine=_eng(backend))
    b = JStream(d=D)
    for k in (n, 8, n + 3):
        p = _packed(rng.integers(0, 2, (k, D)))
        a.update_packed(p, k)
        b.update_packed(jnp.asarray(p), k)
    _same(a, b)


N_VALID = (None, [40, 0, 17, 40], [1, 40, 39, 8])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_valid", N_VALID)
@pytest.mark.parametrize("method,rate", [("sign", 1), ("persymbol", 1),
                                         ("persymbol", 4)])
def test_update_codes_batch(backend, n_valid, method, rate):
    rng = np.random.default_rng(3)
    a = StreamingGram(d=D, method=method, rate=rate, engine=_eng(backend))
    b = JStream(d=D, method=method, rate=rate)
    hi = 2 if method == "sign" else 1 << rate
    for _ in range(2):
        c = rng.integers(0, hi, (4, 40, D)).astype(np.int8)
        if method == "sign":
            c = 2 * c - 1
        a.update_codes_batch(c, n_valid)
        b.update_codes_batch(jnp.asarray(c), n_valid)
    if rate == 1:
        _same(a, b)
    else:
        _close(a, b)
    if n_valid is not None:       # the fold of the surviving prefixes
        assert a.n == 2 * sum(n_valid)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n_valid", N_VALID)
@pytest.mark.parametrize("n", [40, 37])
def test_update_packed_batch(backend, n_valid, n):
    rng = np.random.default_rng(4)
    a = StreamingGram(d=D, engine=_eng(backend))
    b = JStream(d=D)
    seq = StreamingGram(d=D, engine=_eng(backend))
    nv = None if n_valid is None else [min(v, n) for v in n_valid]
    bits = rng.integers(0, 2, (4, n, D))
    p = np.stack([_packed(m) for m in bits])
    a.update_packed_batch(torch.from_numpy(p), n, nv)
    b.update_packed_batch(jnp.asarray(p), n, nv)
    _same(a, b)
    for m in range(4):            # the surviving prefixes, one at a time
        k = n if nv is None else nv[m]
        if k:
            seq.update_codes(bits[m, :k])
    np.testing.assert_array_equal(a.gram.numpy(), seq.gram.numpy())
    assert a.n == seq.n


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("method,rate", [("sign", 1), ("persymbol", 4)])
def test_merge(backend, method, rate):
    rng = np.random.default_rng(5)
    parts, ref = [], JStream(d=D, method=method, rate=rate)
    for n in BATCHES:
        x = _chain(rng, n)
        parts.append(StreamingGram(d=D, method=method, rate=rate,
                                   engine=_eng(backend)).update(x))
        ref.merge(JStream(d=D, method=method, rate=rate).update(
            jnp.asarray(x)))
    merged = parts[0].merge(parts[1]).merge(parts[2])
    (_same if method == "sign" else _close)(merged, ref)
    with pytest.raises(ValueError):
        merged.merge(StreamingGram(d=D + 1, method=method, rate=rate,
                                   engine=_eng(backend)))
    with pytest.raises(TypeError):
        merged.merge(ref)


@pytest.mark.parametrize("method,rate", [("sign", 1), ("persymbol", 2),
                                         ("persymbol", 4), ("persymbol", 7),
                                         ("original", 1)])
def test_weights_and_edges_match_repro_and_batch(method, rate):
    rng = np.random.default_rng(6)
    x = _chain(rng, 3000)
    a = StreamingGram(d=D, method=method, rate=rate,
                      engine=_eng("torch"))
    b = JStream(d=D, method=method, rate=rate)
    for lo in range(0, 3000, 700):
        a.update(x[lo:lo + 700])
        b.update(jnp.asarray(x[lo:lo + 700]))
    # off the diagonal, which the MWST ignores and where the Gaussian MI's
    # clip near r^2 = 1 magnifies the Gram's rounding; the sign weights
    # near independence agree to an ulp of 1.0 (torch's and XLA's log2)
    off = ~np.eye(D, dtype=bool)
    tol = (dict(rtol=1e-6, atol=2.5e-7) if method == "sign"
           else dict(rtol=1e-5, atol=1e-6))
    np.testing.assert_allclose(a.weights().numpy()[off],
                               np.asarray(b.weights())[off], **tol)
    want = j_learn(jnp.asarray(x), method=method, rate=rate)
    assert a.learn_structure() == b.learn_structure() == want  # Kruskal order
    assert (sorted(a.learn_structure("boruvka"))
            == sorted(learn_structure(
                x, strategy=Strategy(method=method, rate=rate),
                device="cpu"))
            == sorted(tuple(sorted(e)) for e in want))
    assert a.learn_adjacency().dtype == torch.bool


def test_errors_and_strategy():
    eng = _eng("torch")
    s = StreamingGram.from_strategy(D, Strategy(method="persymbol", rate=3),
                                    engine=eng)
    assert (s.method, s.rate, s.device.type) == ("persymbol", 3, "cpu")
    with pytest.raises(ValueError):
        s.update_packed(np.zeros((D, 2), np.uint8), 16)
    with pytest.raises(ValueError):
        StreamingGram(d=D, method="original", engine=eng).update_codes(
            np.ones((4, D), np.int8))
    with pytest.raises(ValueError):
        StreamingGram(d=D, engine=eng).update_codes_batch(
            np.ones((2, 4, D), np.int8), [1, 2, 3])
    with pytest.raises(ValueError):
        StreamingGram(d=D, engine=eng).update(np.ones((4, D + 1), np.float32))
    with pytest.raises(ValueError):
        StreamingGram(d=D, engine=eng).learn_structure("prim")


def test_default_engine_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamingGram(d=D)


def test_sign_weights_are_symmetric_in_the_gram():
    """I(theta) = I(1 - theta): Grams of opposite sign give the same
    weight bits (so the MWST breaks such exact ties by index alike on
    every device), and they agree with repro's weights to an ulp of 1."""
    from repro.core import estimators as j_est
    from repro_torch.core import estimators

    n = 864
    g = np.arange(-n, n + 1, dtype=np.float32).reshape(1, -1)
    for norm in (False, True):
        x = g / n if norm else g
        w = estimators.weights_from_gram(torch.from_numpy(x), n, "sign",
                                         normalized=norm).numpy()
        np.testing.assert_array_equal(w, w[:, ::-1])
        np.testing.assert_allclose(
            w, np.asarray(j_est.weights_from_gram(jnp.asarray(x), n, "sign",
                                                  normalized=norm)),
            rtol=1e-6, atol=2.5e-7)
