"""Synthetic language-model token pipeline.

The port of ``repro.data.tokens``, batch for batch: the corpus is a
two-level Markov chain over a Zipf-distributed vocabulary (tables from
``numpy.random.default_rng(seed ^ 0x5EED)``), and global batch ``i`` is
drawn from ``default_rng((seed << 32) ^ i)``. The batches are numpy, made
by the same calls in the same order as ``repro``'s, so they are equal bit
for bit; a batch is a pure function of (seed, step), which makes a resumed
run exact. ``token_batches`` moves them to a device, optionally drawing
the next few in worker threads (numpy's generators and ufuncs release the
GIL) while the device trains.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_states: int = 64          # hidden Markov states driving bigram stats

    def _tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(state transition (S,S), emission logits (S,V)) — deterministic."""
        rng = np.random.default_rng(self.seed ^ 0x5EED)
        s, v = self.n_states, self.vocab
        trans = rng.dirichlet(np.full(s, 0.3), size=s).astype(np.float32)
        # Zipfian base frequencies, state-dependent tilt
        base = 1.0 / np.power(np.arange(1, v + 1), self.zipf_a)
        tilt = rng.normal(0.0, 2.0, size=(s, min(v, 512))).astype(np.float32)
        logits = np.log(base)[None, :].repeat(s, 0).astype(np.float32)
        logits[:, : tilt.shape[1]] += tilt
        return trans, logits

    def batch(self, step: int) -> dict:
        """Generate global batch ``step`` -> {'tokens','labels','mask'}."""
        rng = np.random.default_rng((self.seed << 32) ^ step)
        trans, logits = _cached_tables(self)
        b, l = self.global_batch, self.seq_len
        state = rng.integers(0, self.n_states, size=b)
        toks = np.empty((b, l + 1), dtype=np.int32)
        # vectorized over batch, sequential over length
        gumbel_shape = (b, logits.shape[1])
        for t in range(l + 1):
            g = rng.gumbel(size=gumbel_shape).astype(np.float32)
            toks[:, t] = np.argmax(logits[state] + g, axis=1)
            state = _sample_rows(trans, state, rng)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((b, l), dtype=np.float32),
        }

    def unigram_entropy_bound(self) -> float:
        """Entropy (nats) of the marginal token distribution: the loss an
        order-0 model converges to, the bar a trained model must beat."""
        _, logits = _cached_tables(self)
        p = np.exp(logits - logits.max(axis=1, keepdims=True))
        p /= p.sum(axis=1, keepdims=True)
        marg = p.mean(axis=0)
        return float(-(marg * np.log(np.maximum(marg, 1e-30))).sum())


_TABLE_CACHE: dict = {}


def _cached_tables(stream: TokenStream):
    key = (stream.vocab, stream.seed, stream.zipf_a, stream.n_states)
    if key not in _TABLE_CACHE:
        _TABLE_CACHE[key] = stream._tables()
    return _TABLE_CACHE[key]


def _sample_rows(trans: np.ndarray, state: np.ndarray, rng) -> np.ndarray:
    """Sample next states, one categorical draw per row of trans[state]."""
    cdf = np.cumsum(trans[state], axis=1)
    u = rng.random(size=(state.shape[0], 1)).astype(np.float32)
    return (u > cdf).sum(axis=1).astype(np.int64).clip(0, trans.shape[0] - 1)


def _to_device(arrs: dict, dev: torch.device) -> dict:
    """Tokens and labels as int64 (torch's index dtype), the mask f32."""
    return {k: torch.from_numpy(v).to(
        dev, torch.int64 if v.dtype == np.int32 else None)
        for k, v in arrs.items()}


def token_batches(stream: TokenStream, start_step: int = 0, *, device=None,
                  prefetch: int = 0, stop: int | None = None
                  ) -> Iterator[dict]:
    """Batches ``start_step``, ``start_step + 1``, ... (up to ``stop``
    exclusive, else without end) as tensors on ``device`` (default cuda;
    raises without it unless ``device="cpu"``).

    ``prefetch > 0`` draws up to ``prefetch`` batches ahead in as many
    worker threads (never past ``stop``); the batches are the same, in the
    same order. Closing the iterator cancels what has not started and
    waits for what has.
    """
    dev = resolve_device(device)
    _cached_tables(stream)      # once, before any worker needs it
    steps = itertools.count(start_step) if stop is None \
        else iter(range(start_step, stop))
    if prefetch <= 0:
        for step in steps:
            yield _to_device(stream.batch(step), dev)
        return
    with ThreadPoolExecutor(prefetch, thread_name_prefix="tokens") as ex:
        pending = collections.deque(
            ex.submit(stream.batch, s)
            for s in itertools.islice(steps, prefetch))
        try:
            while pending:
                arrs = pending.popleft().result()
                for s in itertools.islice(steps, 1):
                    pending.append(ex.submit(stream.batch, s))
                yield _to_device(arrs, dev)
        finally:
            for f in pending:
                f.cancel()
