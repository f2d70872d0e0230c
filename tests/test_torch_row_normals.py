"""The row-keyed normals' wrapper (``repro_torch.kernels.row_normals``) on
the CPU, where it runs its plain version (``kernels.ref.row_normals_ref``).

Held bit for bit to the ``core.prng`` composition the sampler ran before
the kernel (``fold_in`` of the row, ``normal``, the scale multiply), and to
``repro``'s row-keyed sampler within ``NORMAL_RTOL`` relative (2^-21, as
``test_torch_prng.py``), signs exactly. The CUDA kernel is held to the same
plain version on the card, bit for bit (``test_torch_cuda.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sampler as j_sampler
from repro_torch import kernels
from repro_torch.core import prng, sampler, trees
from repro_torch.kernels import ref

#: |normal - repro normal| <= NORMAL_RTOL * |repro normal|
NORMAL_RTOL = 2.0 ** -21
SEEDS = (0, 2 ** 32 - 1)
#: rows r0..r1 of each trial: r0 > 0, as every block after a sweep's first
R0, R1 = 3, 9


def _keys(seed: int, t: int):
    """(port keys (t, 2) int64, repro keys (t,)): trial k is
    ``fold_in(key(seed), k)``."""
    tk = prng.fold_in(prng.key(seed, device="cpu"), torch.arange(t))
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.key(seed), jnp.arange(t, dtype=jnp.uint32))
    return tk, jk


def _scale(t: int, d: int, seed: int) -> torch.Tensor:
    """Innovation scales of random rhos in [0.4, 0.9], as a tree's."""
    rng = np.random.default_rng(seed % 1000)
    rho = torch.as_tensor(rng.uniform(0.4, 0.9, size=(t, d)),
                          dtype=torch.float32)
    return trees._innovation_scale(rho)


def _plain(keys, r0, r1, d, scale):
    """The sampler's composition before the kernel, written out."""
    rows = torch.arange(r0, r1)
    z = prng.normal(prng.fold_in(keys[:, None, :], rows[None, :]), (d,))
    return z if scale is None else z * scale[:, None, :]


@pytest.mark.parametrize("scaled", [False, True], ids=["bare", "scaled"])
@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("d", [20, 1023, 1024])
@pytest.mark.parametrize("seed", SEEDS)
def test_row_normals_match_repro(seed, d, t, scaled):
    tk, jk = _keys(seed, t)
    scale = _scale(t, d, seed) if scaled else None
    got = kernels.row_normals(tk, R0, R1, d, scale)
    assert got.shape == (t, R1 - R0, d) and got.dtype == torch.float32
    assert torch.equal(got, _plain(tk, R0, R1, d, scale))
    want = np.asarray(j_sampler._row_normals(jk, R1, d))[:, R0:]
    if scaled:
        want = want * scale.numpy()[:, None, :]
    got = got.numpy()
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_cpu_path_is_the_plain_version_bit_for_bit(seed):
    tk, _ = _keys(seed, 4)
    d = 33
    scale = _scale(4, d, seed)
    before = kernels.launches()
    got = kernels.row_normals(tk, 5, 12, d, scale)
    assert torch.equal(got, ref.row_normals_ref(tk, 5, 12, d, scale))
    assert torch.equal(got, _plain(tk, 5, 12, d, scale))
    # rows are keyed by their index alone: a block is a slice of the draw
    whole = kernels.row_normals(tk, 0, 12, d)
    assert torch.equal(kernels.row_normals(tk, 5, 12, d), whole[:, 5:])
    assert kernels.row_normals(tk, 7, 7, d).shape == (4, 0, d)
    assert kernels.launches() == before


def test_mixed_rows_draw_one_call_a_block(monkeypatch):
    """``_mixed_rows`` draws each row block with one ``row_normals`` call,
    the scale passed in (on a card, one launch a block); the mixing
    product of smaller blocks rounds otherwise, within f32's tolerance."""
    tk, _ = _keys(7, 3)
    d, n = 16, 50
    rng = np.random.default_rng(3)
    parents = torch.as_tensor(np.stack([trees.topological_parents(
        d, trees.random_tree(d, rng), np.full(d - 1, 0.6))[0]
        for _ in range(3)]))
    rhos = torch.full((3, d), 0.6)
    rhos[:, 0] = 0.0
    whole = sampler.sample_tree_ggm_rows_batch(tk, n, parents, rhos)
    calls = []
    real = kernels.row_normals

    def spy(keys, r0, r1, d, scale=None):
        calls.append((r0, r1, scale is not None))
        return real(keys, r0, r1, d, scale)

    monkeypatch.setattr(kernels, "row_normals", spy)
    monkeypatch.setattr(sampler, "_ROW_KEYED_BLOCK", 3 * d * 7)
    blocked = sampler.sample_tree_ggm_rows_batch(tk, n, parents, rhos)
    assert calls == [(r0, min(n, r0 + 7), True) for r0 in range(0, n, 7)]
    torch.testing.assert_close(blocked, whole)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    tk, _ = _keys(1, 2)
    with pytest.raises(TypeError):
        kernels.row_normals(tk.to(torch.int32), 0, 4, 8)
    with pytest.raises(TypeError):
        kernels.row_normals(tk.numpy(), 0, 4, 8)
    with pytest.raises(TypeError):
        kernels.row_normals(tk, 0, 4, 8,
                            torch.ones(2, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="keys"):
        kernels.row_normals(tk[0], 0, 4, 8)
    with pytest.raises(ValueError, match="keys"):
        kernels.row_normals(torch.zeros(2, 3, dtype=torch.int64), 0, 4, 8)
    with pytest.raises(ValueError, match="scale"):
        kernels.row_normals(tk, 0, 4, 8, torch.ones(2, 9))
    with pytest.raises(ValueError, match="scale"):
        kernels.row_normals(tk, 0, 4, 8, torch.ones(8))
    with pytest.raises(ValueError, match="rows"):
        kernels.row_normals(tk, 5, 4, 8)
    with pytest.raises(ValueError, match="rows"):
        kernels.row_normals(tk, -1, 4, 8)
    with pytest.raises(ValueError, match="2\\^32"):
        kernels.row_normals(tk, 0, 4, 1 << 32)
    with pytest.raises(ValueError, match="2\\^32"):
        kernels.row_normals(tk, 0, 4, -1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        kernels.row_normals(tk.to("meta"), 0, 4, 8)
    with pytest.raises(ValueError, match="meta"):
        kernels.row_normals(tk, 0, 4, 8, torch.ones(2, 8, device="meta"))
