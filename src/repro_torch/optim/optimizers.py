"""AdamW and SGD as ``torch.optim.Optimizer``s with ``repro``'s arithmetic.

The port of ``repro.optim.optimizers``. ``repro``'s optimizers are
(init, update) pairs over pytrees; here the optimizer object holds the
state: a step count (in ``param_groups``, so it checkpoints with
``state_dict``) and, per parameter, the moments in ``mu_dtype``, made
with the optimizer (``repro``'s ``init``). ``step(lr, grads)`` is
``repro``'s ``update``: the learning rate is the caller's (a schedule of
the step count *before* the increment, as ``repro`` reads it), the
gradients are passed in (default: each parameter's ``.grad``).

The update is ``repro``'s, op for op, in f32: bias corrections
``1 - b**step`` with the step as f32, ``(m/c1)/(sqrt(v/c2)+eps) + wd*p``,
then ``p - lr*upd`` cast back to the parameter's dtype.
``torch.optim.AdamW`` decays ``p *= 1 - lr*wd`` before its step and
rounds differently. Parameters are updated one at a time, so the f32
temporaries stay the size of the largest parameter.

``state_tree(named)`` / ``load_state_tree(named, tree)`` give the state
as ``repro``'s ``OptState`` layout ({"step", "moments": {name: {param
name: tensor}}}) for checkpoints and ``interop``.
"""
from __future__ import annotations

import numpy as np
import torch


def global_norm(grads, weights=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum over the gradients of their f32 sums of squares.

    For gradients sharded over ranks: ``weights`` (one per gradient, a
    float or a tensor broadcast against it) is 1 / how many ranks hold
    each element, so a replicated element is counted once, and
    ``reduce`` sums the rank's total over every rank."""
    if weights is None:
        sq = [g.to(torch.float32).square().sum() for g in grads]
    else:
        sq = [(g.to(torch.float32).square()
               * (w.to(g.device) if isinstance(w, torch.Tensor) else w)
               ).sum() for g, w in zip(grads, weights)]
    total = torch.stack(sq).sum()
    if reduce is not None:
        total = reduce(total)
    return total.sqrt()


def clip_by_global_norm(grads, max_norm: float, weights=None, reduce=None):
    """(grads scaled by min(1, max_norm / max(norm, 1e-12)) in f32 and
    cast back to their dtypes, the pre-clip norm); ``weights`` and
    ``reduce`` as :func:`global_norm` takes them, for sharded ones."""
    grads = list(grads)
    norm = global_norm(grads, weights, reduce)
    # a true division (``float / tensor`` multiplies by the reciprocal)
    scale = torch.clamp(torch.full_like(norm, max_norm)
                        / torch.clamp(norm, min=1e-12), max=1.0)
    for i, g in enumerate(grads):
        grads[i] = (g.to(torch.float32) * scale).to(g.dtype)
    return grads, norm


class _Optimizer(torch.optim.Optimizer):
    """The step count and the moments of ``repro``'s ``OptState``."""

    #: the names of the per-parameter moments, as ``repro`` keys them
    moment_names: tuple[str, ...] = ()

    def __init__(self, params, defaults: dict):
        super().__init__(params, dict(defaults, step=0))
        for p in self._params():
            self.state[p] = {name: torch.zeros_like(p, dtype=self._moment_dtype(
                name)) for name in self.moment_names}

    def _moment_dtype(self, name: str) -> torch.dtype:
        return torch.float32

    def _params(self) -> list:
        return [p for g in self.param_groups for p in g["params"]]

    @property
    def step_count(self) -> int:
        """Updates applied so far (``repro``'s ``OptState.step``)."""
        return int(self.param_groups[0]["step"])

    @step_count.setter
    def step_count(self, value: int) -> None:
        for g in self.param_groups:
            g["step"] = int(value)

    def _grads(self, grads) -> list:
        params = self._params()
        grads = [p.grad for p in params] if grads is None else list(grads)
        if len(grads) != len(params) or any(g is None for g in grads):
            raise ValueError(f"{type(self).__name__}.step needs a gradient "
                             f"for each of its {len(params)} parameters")
        return grads

    def state_tree(self, named) -> dict:
        """{"step": int32, "moments": {moment: {name: tensor}}} over the
        (name, parameter) pairs ``named``; the tensors are the state's own."""
        return {"step": np.int32(self.step_count),
                "moments": {m: {name: self.state[p][m] for name, p in named}
                            for m in self.moment_names}}

    @torch.no_grad()
    def load_state_tree(self, named, tree: dict) -> None:
        """Copy ``tree`` (the layout of :meth:`state_tree`, any array
        type) into the state."""
        for m in self.moment_names:
            for name, p in named:
                self.state[p][m].copy_(_as_tensor(tree["moments"][m][name]))
        self.step_count = int(_as_tensor(tree["step"]))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def _scalar(value, ref: torch.Tensor) -> torch.Tensor:
    """An f32 0-d tensor on ``ref``'s device: dividing by it is a true
    division on every device (a host scalar divisor is a multiply by its
    reciprocal on CUDA)."""
    return torch.full((), float(value), dtype=torch.float32,
                      device=ref.device)


class AdamW(_Optimizer):
    """AdamW with decoupled weight decay and bias correction, moments in
    ``mu_dtype`` (f32 by default; bf16 parameters keep f32 moments, the
    usual mixed-precision recipe); ``repro.optim.adamw``'s defaults
    (b2 = 0.95, weight decay 0.1)."""

    moment_names = ("mu", "nu")

    def __init__(self, params, *, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 mu_dtype: torch.dtype = torch.float32):
        self.mu_dtype = mu_dtype
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    def _moment_dtype(self, name: str) -> torch.dtype:
        return self.mu_dtype

    @torch.no_grad()
    def step(self, lr, grads=None) -> None:
        """One update at learning rate ``lr`` (a float or an f32 0-d
        tensor) from ``grads`` (one per parameter, in parameter order)."""
        it = iter(self._grads(grads))
        step = np.float32(self.step_count + 1)
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            c1 = np.float32(1) - np.float32(b1) ** step
            c2 = np.float32(1) - np.float32(b2) ** step
            consts: dict = {}
            for p in group["params"]:
                g = next(it).to(torch.float32)
                if p.device not in consts:
                    consts[p.device] = (_scalar(c1, p), _scalar(c2, p))
                d1, d2 = consts[p.device]
                st = self.state[p]
                m = st["mu"] * b1 + g * (1.0 - b1)
                v = st["nu"] * b2 + g.square() * (1.0 - b2)
                upd = (m / d1) / (torch.sqrt(v / d2) + group["eps"])
                p32 = p.to(torch.float32)
                upd = upd + p32 * group["weight_decay"]
                p.copy_(p32 - upd * lr)
                st["mu"].copy_(m)
                st["nu"].copy_(v)
        self.step_count = self.step_count + 1


class SGD(_Optimizer):
    """SGD with (optionally Nesterov) momentum, the velocity in f32."""

    moment_names = ("v",)

    def __init__(self, params, *, momentum: float = 0.9,
                 nesterov: bool = False):
        super().__init__(params, dict(momentum=momentum, nesterov=nesterov))

    @torch.no_grad()
    def step(self, lr, grads=None) -> None:
        it = iter(self._grads(grads))
        for group in self.param_groups:
            mom = group["momentum"]
            for p in group["params"]:
                g = next(it).to(torch.float32)
                st = self.state[p]
                v = st["v"] * mom + g
                step_dir = g + v * mom if group["nesterov"] else v
                p.copy_(p.to(torch.float32) - step_dir * lr)
                st["v"].copy_(v)
        self.step_count = self.step_count + 1
