"""GramEngine: one dispatch point for every pairwise-statistic contraction.

The port of ``repro.core.gram``. Every pipeline reduces to the Gram
``G = U^T V`` over (quantized) codes (paper §4.2 eq. 8, §5 eq. 32); the
engine routes it through one of three backends:

* ``kernel`` — the hand-written CUDA kernels of ``repro_torch.kernels``
  (``repro``'s ``pallas``). Codes stay in their wire dtype into the
  kernel; on a CPU tensor each wrapper runs its plain version.
* ``torch``  — plain PyTorch contractions (``repro``'s ``xla``): the CPU
  path and, on a CUDA tensor, an explicit caller's choice of reference.
* ``numpy``  — host reference returning ``np.ndarray``.

``backend="auto"`` picks ``kernel`` for CUDA tensors and ``torch`` for
CPU tensors. Host (numpy) operands go to the engine's ``device``
(default ``cuda``; raises without CUDA unless ``device="cpu"``).

Input kinds and bytes per symbol on the wire:

  ============  =====================  =============================  =====
  input kind    entry point            kernel backend                 B/sym
  ============  =====================  =============================  =====
  f32 values    ``gram(x)``            torch.matmul in full f32       4
  int8 values   ``gram(u)``            ``sign_corr`` (int32 sums)     1
  int8 codes    ``code_gram(c, cb)``   ``code_corr`` (in-kernel dec.) 1
  packed bits   ``packed_sign_gram``   ``sign_corr_packed`` (popc)    1/8
  ============  =====================  =============================  =====

Every entry point has a ``*_batch`` twin over a leading batch axis.

Two streaming knobs bound the transient working set at large d:
``d_tile`` assembles the (d, d) output from (d_tile, d_tile) blocks, and
``n_chunk`` accumulates the integer-exact paths of the torch/numpy
backends over sample chunks. Both are bit-identical on integer paths.

``autotune=True`` picks (d_tile, n_chunk) per (platform, backend, path,
shape bucket) by timing :func:`candidate_configs` on first use, as
``repro``'s autotune layer does. Winners persist in a JSON file
(``REPRO_TORCH_GRAM_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/gram_autotune.json``, apart from ``repro``'s: the
two packages' configs have different fields), keyed by platform (``cpu``
or ``cuda:<device name>``); a warm process runs no sweep.
``REPRO_TORCH_GRAM_AUTOTUNE=0`` disables sweeping (cached winners still
load). ``run_trials`` tunes an autotuning engine before its sweeps. A
candidate that fails raises: a kernel that does not build or launch is
never passed over.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Literal

import numpy as np
import torch

from repro_torch._device import as_tensor, resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.sign_corr import code_corr, sign_corr, sign_corr_packed

Backend = Literal["auto", "kernel", "torch", "numpy"]
_BACKENDS = ("kernel", "torch", "numpy")

#: Env var: set to "0" to disable autotune sweeps (cached winners still load)
AUTOTUNE_ENV = "REPRO_TORCH_GRAM_AUTOTUNE"
#: Env var: path of the persistent autotune JSON cache
AUTOTUNE_CACHE_ENV = "REPRO_TORCH_GRAM_AUTOTUNE_CACHE"


@dataclasses.dataclass(frozen=True)
class GramConfig:
    """The engine-level streaming knobs of one Gram call (``None`` =
    monolithic along that axis). The kernels' tiles are their own."""

    d_tile: int | None = None
    n_chunk: int | None = None


def _spans(size: int, tile: int) -> list[tuple[int, int]]:
    return [(i, min(i + tile, size)) for i in range(0, size, tile)]


def _cat(parts, dim: int, xp):
    if len(parts) == 1:
        return parts[0]
    if xp is np:
        return np.concatenate(parts, axis=dim)
    return torch.cat(parts, dim=dim)


def _assemble_tiles(block_fn, dl: int, dr: int, tile: int, xp):
    """Assemble a (.., dl, dr) Gram from (d_tile, d_tile) output blocks."""
    rows = []
    for i0, i1 in _spans(dl, tile):
        rows.append(_cat([block_fn(i0, i1, j0, j1)
                          for j0, j1 in _spans(dr, tile)], -1, xp))
    return _cat(rows, -2, xp)


def _binary_antisymmetric_centroid(centroids) -> float | None:
    """c > 0 when ``centroids`` is a 2-level codebook [-c, +c].

    The rate-1 per-symbol codebook is exactly this shape, so its decoded
    Gram factors as c^2 * (sign Gram of the ±1 mapped codes) — an INTEGER
    contraction, bit-stable under any reduction order.
    """
    if isinstance(centroids, torch.Tensor):
        centroids = centroids.detach().cpu().numpy()
    cb = np.asarray(centroids, dtype=np.float32)
    if cb.shape != (2,) or not (cb[1] > 0.0 and cb[0] == -cb[1]):
        return None
    return float(cb[1])


def _binary_codes_to_signs(codes):
    """{0 -> -1, 1 -> +1, anything else (MASKED_CODE, OOB) -> 0} as int8."""
    if isinstance(codes, np.ndarray):
        return (codes == 1).astype(np.int8) - (codes == 0).astype(np.int8)
    return (codes == 1).to(torch.int8) - (codes == 0).to(torch.int8)


def _to_f32(a, xp):
    if xp is np:
        return np.asarray(a, dtype=np.float32)
    return a.to(torch.float32)


def _contract_values(uf, vf, xp):
    """(.., n, dl) x (.., n, dr) -> (.., dl, dr)."""
    if xp is np:
        return np.matmul(np.swapaxes(uf, -1, -2), vf)
    return torch.matmul(uf.transpose(-1, -2), vf)


def _is_int(a) -> bool:
    if isinstance(a, np.ndarray):
        return np.issubdtype(a.dtype, np.integer)
    return not a.dtype.is_floating_point and not a.dtype.is_complex \
        and a.dtype != torch.bool


@dataclasses.dataclass(frozen=True)
class GramEngine:
    """Backend-dispatched Gram contraction over (quantized) sample matrices.

    Attributes:
      backend: ``auto`` | ``kernel`` | ``torch`` | ``numpy``; ``auto``
        resolves per call from the operands' device (kernel on CUDA,
        torch on CPU).
      d_tile: stream the (d, d) output in (d_tile, d_tile) blocks when d
        exceeds it (``None`` = monolithic). Bit-identical on integer paths.
      n_chunk: accumulate the torch/numpy integer-exact paths over
        n-chunks of this many samples (packed: ``n_chunk/8``-byte
        chunks). Never applied to float values.
      device: where host (numpy) operands are placed; tensors stay on
        their own device. ``None`` = cuda.
      autotune: look up (sweeping on first use) a tuned
        :class:`GramConfig` per (path, shape bucket), overriding
        ``d_tile`` / ``n_chunk``; see the module docstring.
    """

    backend: Backend = "auto"
    d_tile: int | None = None
    n_chunk: int | None = None
    device: str | None = None
    autotune: bool = False

    def resolve(self, *operands) -> str:
        b = self.backend
        if b == "auto":
            dev = resolve_device(self.device, *operands)
            b = "kernel" if dev.type == "cuda" else "torch"
        if b not in _BACKENDS:
            raise ValueError(f"unknown gram backend {b!r}")
        return b

    def _base_config(self) -> GramConfig:
        return GramConfig(self.d_tile, self.n_chunk)

    def _tune_target(self, device=None, *operands):
        """(backend, device) a call or a tune resolves to; the numpy
        backend runs on the host whatever the device."""
        if self.backend == "numpy":
            return "numpy", None
        dev = resolve_device(self.device if device is None else device,
                             *operands)
        if self.backend == "auto":
            return ("kernel" if dev.type == "cuda" else "torch"), dev
        return self.resolve(*operands), dev

    def tune(self, path: str, n: int, d: int, *, budget: int | None = None,
             device=None) -> GramConfig:
        """Resolve (sweeping on first use) the tuned config of one (path,
        shape) point on ``device`` (default: the engine's); ``budget``
        keeps the candidates whose :func:`gram_working_set_bytes` fits.
        path: f32 | int8 | code | packed."""
        return tuned_config(path, n, d, self, budget=budget, device=device)

    def _tuned(self, path: str, n: int, d: int, *operands) -> "GramEngine":
        """A copy with the tuned streaming knobs for this call's bucket."""
        cfg = tuned_config(path, n, d, self,
                           device=self._tune_target(None, *operands)[1])
        return dataclasses.replace(self, autotune=False, d_tile=cfg.d_tile,
                                   n_chunk=cfg.n_chunk)

    def _operands(self, backend: str, *ops):
        """Operands in the backend's array type (``None`` passes)."""
        if backend == "numpy":
            return tuple(
                None if a is None else
                a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                else np.asarray(a) for a in ops)
        first = next((a for a in ops if isinstance(a, torch.Tensor)), None)
        dev = resolve_device(self.device, first)
        return tuple(None if a is None else as_tensor(a, dev) for a in ops)

    @staticmethod
    def _xp(backend: str):
        return np if backend == "numpy" else torch

    # -- values: f32 / int8 ±1 ----------------------------------------------

    def gram(self, u, v=None):
        """G = u^T v (v defaults to u) over (n, d)-shaped value matrices.

        int8 codes go to the ``sign_corr`` kernel on the kernel backend;
        f32/f64 values — the unquantized baseline — contract in full f32
        with ``torch.matmul``.
        """
        return self._value_gram(u, v)

    def gram_batch(self, u, v=None):
        """Batched :meth:`gram`: (b, n, d_l) [x (b, n, d_r)] -> (b, d_l, d_r)."""
        if u.ndim != 3:
            raise ValueError(f"gram_batch takes (b, n, d), got {u.shape}")
        return self._value_gram(u, v)

    def _value_gram(self, u, v):
        if self.autotune:
            ops = (u,) if v is None else (u, v)
            exact = all(_is_int(a) or getattr(a, "dtype", None)
                        == torch.bfloat16 for a in ops)
            return self._tuned("int8" if exact else "f32", u.shape[-2],
                               max(u.shape[-1], ops[-1].shape[-1]),
                               u, v)._value_gram(u, v)
        backend = self.resolve(u, v)
        u, v = self._operands(backend, u, v)
        vv = u if v is None else v
        dl, dr = u.shape[-1], vv.shape[-1]
        t = self.d_tile
        if t is not None and t < max(dl, dr):
            return _assemble_tiles(
                lambda i0, i1, j0, j1: self._value_block(
                    u[..., i0:i1], vv[..., j0:j1], backend),
                dl, dr, t, self._xp(backend))
        return self._value_block(u, v, backend)

    def _value_block(self, u, v, backend: str):
        ops = (u,) if v is None else (u, v)
        exact_int = all(_is_int(a) for a in ops)
        if backend == "kernel":
            if all(a.dtype == torch.int8 for a in ops):
                return sign_corr(u, v)
            if not all(a.dtype in (torch.float32, torch.float64)
                       for a in ops):
                raise NotImplementedError(
                    f"the kernel backend contracts int8 codes or f32 "
                    f"values; a {ops[0].dtype} value Gram has no kernel yet")
        xp = self._xp(backend)
        n = u.shape[-2]
        nc = self.n_chunk
        if backend != "kernel" and exact_int and nc is not None and nc < n:
            # partial Grams are exact integers in f32 -> bit-identical
            acc = None
            for k0, k1 in _spans(n, nc):
                uf = _to_f32(u[..., k0:k1, :], xp)
                vf = uf if v is None else _to_f32(v[..., k0:k1, :], xp)
                g = _contract_values(uf, vf, xp)
                acc = g if acc is None else acc + g
            return acc
        uf = _to_f32(u, xp)
        vf = uf if v is None else _to_f32(v, xp)
        return _contract_values(uf, vf, xp)

    # -- int8 bin codes + centroid codebook ---------------------------------

    def code_gram(self, codes, centroids, codes_rhs=None):
        """Gram of centroid-decoded codes; the kernel backend decodes
        in-kernel, torch/numpy decode then contract. Out-of-range codes
        (the -1 mask sentinel) decode to 0 on every backend."""
        return self._code_gram(codes, centroids, codes_rhs)

    def code_gram_batch(self, codes, centroids, codes_rhs=None):
        """Batched :meth:`code_gram`: (b, n, d) int8 codes -> (b, d, d),
        the codebook shared across the batch."""
        if codes.ndim != 3:
            raise ValueError(f"code_gram_batch takes (b, n, d), got "
                             f"{codes.shape}")
        return self._code_gram(codes, centroids, codes_rhs)

    def _code_gram(self, codes, centroids, rhs):
        c = _binary_antisymmetric_centroid(centroids)
        if c is not None:
            # 2-level antisymmetric codebook (the rate-1 per-symbol path):
            # decode(u) = c * sign(u), so G = c^2 * (integer sign Gram),
            # integer-exact on every backend.
            backend = self.resolve(codes, rhs)
            codes, rhs = self._operands(backend, codes, rhs)
            u = _binary_codes_to_signs(codes)
            v = None if rhs is None else _binary_codes_to_signs(rhs)
            scale = np.float32(c) * np.float32(c)  # one f32 rounding
            return self._value_gram(u, v) * float(scale)
        if self.autotune:
            rr = codes if rhs is None else rhs
            return self._tuned("code", codes.shape[-2],
                               max(codes.shape[-1], rr.shape[-1]), codes,
                               rhs)._code_gram(codes, centroids, rhs)
        backend = self.resolve(codes, rhs)
        codes, rhs = self._operands(backend, codes, rhs)
        rr = codes if rhs is None else rhs
        dl, dr = codes.shape[-1], rr.shape[-1]
        t = self.d_tile
        if t is not None and t < max(dl, dr):
            return _assemble_tiles(
                lambda i0, i1, j0, j1: self._code_block(
                    codes[..., i0:i1], centroids, rr[..., j0:j1], backend),
                dl, dr, t, self._xp(backend))
        return self._code_block(codes, centroids, rhs, backend)

    def _code_block(self, codes, centroids, rhs, backend: str):
        if backend == "kernel":
            return code_corr(codes, centroids, rhs)
        # decode is float-valued: d-tiled only, never n-chunked
        if backend == "numpy":
            uf = self._decode_np(codes, centroids)
            vf = uf if rhs is None else self._decode_np(rhs, centroids)
            return _contract_values(uf, vf, np)
        cb = torch.as_tensor(centroids, dtype=torch.float32,
                             device=codes.device)
        uf = ref.decode_codes(codes, cb)
        vf = uf if rhs is None else ref.decode_codes(rhs, cb)
        return _contract_values(uf, vf, torch)

    @staticmethod
    def _decode_np(codes, centroids) -> np.ndarray:
        if isinstance(centroids, torch.Tensor):
            centroids = centroids.detach().cpu().numpy()
        cb = np.asarray(centroids, dtype=np.float32)
        c = np.asarray(codes, dtype=np.int64)
        in_range = (c >= 0) & (c < cb.shape[0])
        return np.where(in_range, cb[np.clip(c, 0, cb.shape[0] - 1)],
                        np.float32(0.0))

    # -- 1-bit packed sign codes --------------------------------------------

    def packed_sign_gram(self, packed, n: int, packed_rhs=None):
        """Sign Gram straight from the packed wire payload.

        ``packed``: (d, ceil(n/8)) uint8, feature-major, little bit order;
        tail bits beyond ``n`` must be zero. Exact on every backend:
        G = n - 2*popcount(xor) — pad bits xor to zero and drop out.
        """
        return self._packed_gram(packed, n, packed_rhs)

    def packed_sign_gram_batch(self, packed, n: int, packed_rhs=None):
        """Batched :meth:`packed_sign_gram`: (b, d, ceil(n/8)) -> (b, d, d)."""
        if packed.ndim != 3:
            raise ValueError(f"packed_sign_gram_batch takes (b, d, nb), got "
                             f"{packed.shape}")
        return self._packed_gram(packed, n, packed_rhs)

    def _packed_gram(self, packed, n: int, rhs):
        if rhs is not None and packed.shape[-1] != rhs.shape[-1]:
            raise ValueError(f"packed operands disagree on byte width: "
                             f"{packed.shape} vs {rhs.shape}")
        if self.autotune:
            rr = packed if rhs is None else rhs
            return self._tuned("packed", n, max(packed.shape[-2],
                                                rr.shape[-2]), packed,
                               rhs)._packed_gram(packed, n, rhs)
        backend = self.resolve(packed, rhs)
        packed, rhs = self._operands(backend, packed, rhs)
        rr = packed if rhs is None else rhs
        dl, dr = packed.shape[-2], rr.shape[-2]
        t = self.d_tile
        if t is not None and t < max(dl, dr):
            return _assemble_tiles(
                lambda i0, i1, j0, j1: self._packed_block(
                    packed[..., i0:i1, :], n, rr[..., j0:j1, :], backend),
                dl, dr, t, self._xp(backend))
        return self._packed_block(packed, n, rhs, backend)

    def _packed_block(self, packed, n: int, rhs, backend: str):
        if backend == "kernel":
            return sign_corr_packed(packed, n, rhs)
        nb = packed.shape[-1]
        chunk_b = nb if self.n_chunk is None else max(
            1, min(-(-self.n_chunk // 8), nb))
        if backend == "numpy":
            a = packed
            b = a if rhs is None else rhs
            pop = None  # int64 popcount sums: chunking is bit-identical
            for b0, b1 in _spans(nb, chunk_b):
                p = np.bitwise_count(
                    a[..., :, None, b0:b1] ^ b[..., None, :, b0:b1]).sum(
                        axis=-1, dtype=np.int64)
                pop = p if pop is None else pop + p
            return (n - 2 * pop).astype(np.float32)
        # torch: unpack to ±1 planes with pad bits masked to 0; chunked
        # planes stay bounded and partial products are exact integers
        acc = None
        for b0, b1 in _spans(nb, chunk_b):
            uf = ref.unpack_signs_pm1(packed[..., :, b0:b1], n - 8 * b0)
            vf = uf if rhs is None else ref.unpack_signs_pm1(
                rhs[..., :, b0:b1], n - 8 * b0)
            g = torch.matmul(uf, vf.transpose(-1, -2))
            acc = g if acc is None else acc + g
        return acc


# ---------------------------------------------------------------------------
# Analytic working-set model
# ---------------------------------------------------------------------------

def gram_working_set_bytes(
    path: str,
    n: int,
    d: int,
    *,
    backend: str = "torch",
    config: GramConfig | None = None,
    batch: int = 1,
) -> int:
    """Transient working set (bytes) of one Gram call, operands included,
    EXCLUDING the (d, d) f32 output every path must materialize anyway.

    Counts the operand payload plus the largest intermediate the backend
    stages in device memory: the torch f32 upcast / decode / bit-unpack
    planes, the numpy XOR-popcount cube. The kernels stage only on-chip
    tiles, so their model is the operand payload itself.

    path: ``f32`` | ``int8`` | ``code`` | ``packed``.
    """
    if path not in ("f32", "int8", "code", "packed"):
        raise ValueError(f"unknown gram path {path!r}")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown gram backend {backend!r}")
    cfg = config or GramConfig()
    t = d if cfg.d_tile is None else min(cfg.d_tile, d)
    if path == "packed":
        nb = -(-n // 8)
        chunk_b = nb if cfg.n_chunk is None else max(
            1, min(-(-cfg.n_chunk // 8), nb))
        oper = batch * d * nb
        if backend == "kernel":
            work = 0
        elif backend == "numpy":
            work = batch * t * t * chunk_b  # uint8 XOR/popcount cube
        else:  # torch: two unpacked ±1 f32 planes per (tile, byte-chunk)
            work = 4 * batch * 2 * t * chunk_b * 8
        return oper + work
    bytes_per = 4 if path == "f32" else 1
    nc = n if cfg.n_chunk is None else min(cfg.n_chunk, n)
    oper = batch * n * d * bytes_per
    if backend == "kernel" or path == "f32":
        work = 0
    else:
        work = 4 * batch * 2 * nc * t  # f32 upcast/decode of both tile slabs
    return oper + work


#: environment override of :func:`default_memory_budget` (bytes)
MEMORY_BUDGET_ENV = "REPRO_MEMORY_BUDGET_BYTES"


def default_memory_budget() -> int:
    """Per-device memory budget in bytes for plan and tile decisions.

    ``REPRO_MEMORY_BUDGET_BYTES`` overrides; else the card's total memory
    (``torch.cuda.get_device_properties``) when there is a card, so a
    plan decides alike on the card and on its host's CPU; else an 8 GiB
    host heuristic.
    """
    env = os.environ.get(MEMORY_BUDGET_ENV)
    if env:
        return int(env)
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return 8 << 30


# ---------------------------------------------------------------------------
# Autotune layer: per-(platform, backend, path, shape bucket) tile sweeps
# ---------------------------------------------------------------------------

_tuned: dict[str, GramConfig] = {}
_cache_loaded_from: str | None = None
_sweep_count = 0
_sweep_log: list[dict] = []
#: the d_tile candidates of every sweep (those below the bucket's d)
_D_TILES = (128, 256, 512, 1024)
#: the sweep's sample count is capped here (tiles carry across n buckets)
SWEEP_N_CAP = 4096


def autotune_enabled() -> bool:
    return os.environ.get(AUTOTUNE_ENV, "1") != "0"


def autotune_cache_path() -> str:
    return os.environ.get(AUTOTUNE_CACHE_ENV) or os.path.join(
        os.path.expanduser("~"), ".cache", "repro_torch",
        "gram_autotune.json")


def autotune_sweep_count() -> int:
    """Timing sweeps run by this process: a warm cache (in memory or in
    the file) keeps it flat across repeat calls."""
    return _sweep_count


def autotune_sweep_log() -> list[dict]:
    """Every sweep of this process, in order: {"key", "winner", "times":
    [(GramConfig, best-of-2 seconds)]}."""
    return list(_sweep_log)


def clear_autotune_cache(*, remove_file: bool = False) -> None:
    """Drop the in-memory tuned configs (and optionally the JSON file).
    The sweep counter is not reset: callers diff it around calls."""
    global _cache_loaded_from
    _tuned.clear()
    _cache_loaded_from = None
    if remove_file:
        try:
            os.remove(autotune_cache_path())
        except OSError:
            pass


def _pow2_bucket(x: int) -> int:
    b = 8
    while b < x:
        b <<= 1
    return b


def _platform(dev: torch.device | None) -> str:
    if dev is None or dev.type == "cpu":
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name(dev)}"


def _tune_key(path: str, n: int, d: int, backend: str, dev) -> str:
    return (f"{_platform(dev)}:{backend}:{path}"
            f":n{_pow2_bucket(n)}:d{_pow2_bucket(d)}")


def _load_cache_file() -> None:
    global _cache_loaded_from
    path = autotune_cache_path()
    if _cache_loaded_from == path:
        return
    _cache_loaded_from = path
    try:
        with open(path) as f:
            data = json.load(f)
        for key, fields in data.get("entries", {}).items():
            _tuned.setdefault(key, GramConfig(**fields))
    except (OSError, ValueError, TypeError):
        pass  # absent, corrupt or foreign cache: resweep


def _store_cache_file() -> None:
    path = autotune_cache_path()
    try:
        entries = {}
        try:  # merge-on-write: keep other processes' winners
            with open(path) as f:
                entries = json.load(f).get("entries", {})
        except (OSError, ValueError):
            pass
        entries.update({k: dataclasses.asdict(c) for k, c in _tuned.items()})
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": dict(sorted(entries.items()))},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only file system: the in-memory cache still serves


def candidate_configs(path: str, n: int, d: int, backend: str = "torch", *,
                      budget: int | None = None) -> list[GramConfig]:
    """The configs a sweep times for one (path, shape, backend) point; the
    first is the all-default config.

    The torch and numpy backends get ``repro``'s ``xla`` set: d_tile below
    d, and with n > 4096 the integer paths' n_chunk = 4096. The kernel
    backend varies d_tile, the one knob its kernels take from the engine
    (their tiles are their own), on the paths a kernel runs: f32 values
    contract in ``torch.matmul`` there, where d_tile is a memory knob
    only. ``budget`` drops candidates whose working set exceeds it
    (keeping the thriftiest if none fits).
    """
    cands = [GramConfig()]
    d_tiles = [t for t in _D_TILES if t < d]
    if backend == "kernel":
        if path != "f32":
            cands += [GramConfig(d_tile=t) for t in d_tiles]
    else:
        cands += [GramConfig(d_tile=t) for t in d_tiles]
        if path in ("int8", "packed") and n > 4096:
            for t in d_tiles or [d]:
                cands.append(GramConfig(d_tile=None if t == d else t,
                                        n_chunk=4096))
    uniq = list(dict.fromkeys(cands))
    if budget is not None:
        def ws(c):
            return gram_working_set_bytes(path, n, d, backend=backend,
                                          config=c)
        uniq = [c for c in uniq if ws(c) <= budget] or [min(uniq, key=ws)]
    return uniq


def _sweep_operands(path: str, n: int, d: int, backend: str, dev) -> tuple:
    """``repro``'s sweep operands: zero or one codes of the bucket's
    shape, on the device (numpy for the numpy backend)."""
    if path == "packed":
        ops = (np.zeros((d, max(1, -(-n // 8))), np.uint8),)
    elif path == "code":
        ops = (np.zeros((n, d), np.int8),
               np.linspace(-1.0, 1.0, 8, dtype=np.float32))
    elif path == "int8":
        ops = (np.ones((n, d), np.int8),)
    else:
        ops = (np.ones((n, d), np.float32),)
    if backend == "numpy":
        return ops
    return tuple(torch.from_numpy(o).to(dev) for o in ops)


def _sync(dev) -> None:
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time_config(engine: GramEngine, cfg: GramConfig, path: str, ops: tuple,
                 n: int, dev) -> float:
    """Best of two timed calls after a warm one, in seconds."""
    eng = dataclasses.replace(engine, autotune=False, d_tile=cfg.d_tile,
                              n_chunk=cfg.n_chunk)
    if path == "packed":
        fn = lambda: eng.packed_sign_gram(ops[0], n)  # noqa: E731
    elif path == "code":
        fn = lambda: eng.code_gram(ops[0], ops[1])  # noqa: E731
    else:
        fn = lambda: eng.gram(ops[0])  # noqa: E731
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


def tuned_config(path: str, n: int, d: int, engine: GramEngine, *,
                 budget: int | None = None, device=None) -> GramConfig:
    """The tuned config for (platform, backend, path, shape bucket) on
    ``device`` (default: the engine's).

    In-memory cache, then the JSON file, then a timing sweep over
    :func:`candidate_configs` at the bucketed shape (n capped at
    ``SWEEP_N_CAP``), persisted for later processes. With sweeps
    disabled, the engine's own config.
    """
    global _sweep_count
    if not autotune_enabled():
        return engine._base_config()
    backend, dev = engine._tune_target(device)
    key = _tune_key(path, n, d, backend, dev)
    hit = _tuned.get(key)
    if hit is None:
        _load_cache_file()
        hit = _tuned.get(key)
    if hit is not None:
        return hit
    nb, db = min(_pow2_bucket(n), SWEEP_N_CAP), _pow2_bucket(d)
    _sweep_count += 1
    ops = _sweep_operands(path, nb, db, backend, dev)
    best_cfg, best_t, times = None, float("inf"), []
    for cfg in candidate_configs(path, nb, db, backend, budget=budget):
        t = _time_config(engine, cfg, path, ops, nb, dev)
        times.append((cfg, t))
        if t < best_t:
            best_cfg, best_t = cfg, t
    _tuned[key] = best_cfg
    _sweep_log.append({"key": key, "winner": best_cfg, "times": times})
    _store_cache_file()
    return best_cfg


_default_engine = GramEngine()


def default_engine() -> GramEngine:
    """The process-wide engine ``engine=None`` resolves to."""
    return _default_engine


def set_default_engine(engine: GramEngine) -> GramEngine:
    """Swap the process-wide default engine; returns the previous one."""
    global _default_engine
    prev, _default_engine = _default_engine, engine
    return prev


def resolve_engine(engine: GramEngine | None) -> GramEngine:
    return _default_engine if engine is None else engine
