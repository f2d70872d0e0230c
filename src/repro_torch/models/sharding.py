"""Sharding rules and the LM's layout on a ``DeviceMesh``.

The port of ``repro.models.sharding``. ``repro`` is GSPMD: one program
on global shapes, the mesh installed process-wide, constraints that
XLA partitions. The port is SPMD over processes, one rank a card: a
model built with a mesh (``Transformer(cfg, mesh=...)``) holds on each
rank plain local tensors, the rank's slices of ``repro``'s global
parameters, cut by ``repro``'s rules table, and its modules call the
collectives on the mesh's sub-groups themselves (an all-reduce after a
row-parallel product, an all-gather of an FSDP'd weight before use).
With no mesh nothing here runs and the single-device code is unchanged.

Axes (``repro``'s):
  * ``model`` — tensor parallel: attention heads, FFN hidden, experts,
    vocabulary, SSM heads.
  * ``data``  — the batch and the FSDP shard of the weights.
  * ``pod``   — an outer data axis (the batch only; no weight spans pods).

``repro``'s ``set_ep2d``/``get_ep2d`` globals are the ``ep2d`` argument
of :class:`LMShard` here.

Where the port cuts differently from GSPMD (a kernel takes whole heads,
not GSPMD's tiles), :class:`LMShard.layout` takes the module's own index
along the model axis:

  * attention K/V when ``n_kv_heads % M != 0``: each rank keeps the K/V
    heads its Q heads read (a head may sit on several ranks);
  * Mamba2's ``in_proj`` [z | x | B | C | dt], ``conv_w``/``conv_b``
    [x | B | C] and ``norm_scale``: the rank's heads' z, x and dt
    columns and every B and C column.

A module whose unit (heads, FFN columns, experts, vocabulary rows) the
model axis does not divide is replicated over it, as ``repro``'s
``_drop_indivisible`` replicates a dim its axes do not divide.

The collectives that gradients cross are ``torch.autograd.Function``s
(Megatron's pair: :meth:`LMShard.enter` is the identity forward and an
all-reduce backward, :meth:`LMShard.reduce` the reverse; an FSDP'd
weight is all-gathered forward and reduce-scattered backward), so every
tensor replicated over ``model`` has the same value and the same
gradient on each of its ranks.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.distributed as dist

# ---------------------------------------------------------------------------
# ``repro``'s rules: specs by leaf name for the UNSTACKED parameter
# ---------------------------------------------------------------------------

_RULES: list[tuple[str, tuple]] = [
    (r"embed$", ("model", None)),
    (r"unembed$", (None, "model")),
    (r"w(q|k|v)$", (None, "model")),
    (r"wo$", ("model", None)),
    (r"w(i|gate)$", (None, "model")),
    (r"w_down$", ("model", None)),
    (r"router$", (None, None)),
    (r"exp_w(i|gate)$", ("model", None, None)),     # expert parallel
    (r"exp_w_down$", ("model", None, None)),
    (r"in_proj$", (None, "model")),
    (r"out_proj$", ("model", None)),
    (r"conv_w$", (None, "model")),
    (r"conv_b$", ("model",)),
    (r"(a_log|dt_bias|ssm_d)$", ("model",)),
    (r"(scale|bias)$", (None,)),
    (r"pos_embed$", (None, None)),
]

_EP2D_RULES = {
    "exp_wgate": ("model", None, "data"),   # (E, d, f): f over data
    "exp_wi": ("model", None, "data"),
    "exp_w_down": ("model", "data", None),  # (E, f, d)
}


def _rule(name: str):
    """The rule for leaf ``name``: the most specific (longest) match.

    ``repro`` takes the first match in table order, which gives
    ``unembed`` and ``pos_embed`` the ``embed`` rule and the experts the
    dense MLP's (GSPMD reshards them inside its expert-parallel
    ``shard_map``). The port's modules compute on the layout they store,
    so it takes the rule that names the leaf: ``unembed``
    column-parallel, the experts over ``model``. Every other leaf gets
    the same rule from both."""
    hits = [(m.end() - m.start(), spec) for pat, spec in _RULES
            if (m := re.search(pat, name))]
    return max(hits, key=lambda h: h[0])[1] if hits else None


def spec_for(path: str, ndim: int, *, fsdp: bool = True) -> tuple:
    """The spec of the leaf at ``path`` (its last ``/``- or ``.``-separated
    name picks the rule, :func:`_rule`): one axis name or None per dim;
    with ``fsdp`` the first replicated dim of a >= 2-D rule goes over
    ``data``; leading stacked dims are None."""
    name = re.split(r"[/.]", path)[-1]
    spec = _rule(name)
    if spec is None:
        return (None,) * ndim
    spec = list(spec)
    if fsdp and len(spec) >= 2:
        for i, s in enumerate(spec):
            if s is None:
                spec[i] = "data"
                break
    while len(spec) < ndim:
        spec.insert(0, None)
    if len(spec) != ndim:
        spec = [None] * (ndim - len(spec)) + list(spec)[-ndim:]
    return tuple(spec)


def param_specs(shapes: dict, *, fsdp: bool = True,
                expert_data: bool = False) -> dict:
    """{name: spec} for {name: shape} (``repro``'s ``param_specs`` over a
    flat dict of parameter names): ``expert_data`` lays the experts out
    2-D (experts over ``model``, d_ff over ``data``)."""
    out = {}
    for path, shape in shapes.items():
        name = re.split(r"[/.]", path)[-1]
        if expert_data and name in _EP2D_RULES:
            spec = list(_EP2D_RULES[name])
            while len(spec) < len(shape):
                spec.insert(0, None)
            out[path] = tuple(spec)
        else:
            out[path] = spec_for(path, len(shape), fsdp=fsdp)
    return out


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name``, 1 when it has none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def _axes(s) -> tuple:
    return s if isinstance(s, tuple) else (s,) if s else ()


def _drop_indivisible(mesh, spec: tuple, shape: tuple) -> tuple:
    """Drop mesh axes whose size does not divide the dim they cut."""
    fixed = []
    for dim, s in zip(shape, spec):
        size = math.prod(axis_size(mesh, a) for a in _axes(s))
        fixed.append(s if size and dim % max(size, 1) == 0 else None)
    return tuple(fixed)


def batch_axes(mesh) -> tuple | None:
    """Mesh axes a global batch dim is sharded over (``pod``, ``data``)."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names) or None


def batch_axes_for(mesh, b: int):
    """Largest divisible batch sharding among (pod+data), data, nothing
    (``repro``'s ``launch.steps.batch_axes_for``;
    :meth:`LMShard.batch` cuts a batch so)."""
    pod, data = axis_size(mesh, "pod"), axis_size(mesh, "data")
    if "pod" in (mesh.mesh_dim_names or ()) and b % (pod * data) == 0:
        return ("pod", "data")
    if b % data == 0:
        return ("data",)
    return None


def cache_pspec(key_leaf: str, shape: tuple, cfg, mesh, batch) -> tuple:
    """The spec of one cache leaf of the port's per-layer cache (no n_rep
    axis), ``batch`` the batch dim's: ``repro``'s
    ``launch.steps.cache_pspec``, with the port's two differences. K/V
    (B, S, Hkv, Dh): kv heads over ``model`` when it divides them;
    otherwise ``repro`` splits head_dim, which the kernels cannot take,
    and each rank keeps the K/V heads its Q heads read ("model*": the
    heads of ``layers.kv_heads_kept``). Conv (B, W-1, C): ``repro`` splits
    the channels evenly; the port keeps its heads' x channels and every B
    and C channel ("model*"). SSM (B, H, P, N): heads over ``model``.
    ``Transformer.init_cache`` sizes each rank's cache by it."""
    m = axis_size(mesh, "model")
    if key_leaf in ("k", "v", "xk", "xv") or key_leaf.endswith(
            ("_xk", "_xv")):
        if m == 1 or cfg.n_heads % m:
            return (batch, None, None, None)
        return (batch, None, "model" if shape[2] % m == 0 else "model*",
                None)
    if key_leaf == "conv":
        tp = m > 1 and cfg.ssm_heads % m == 0
        return (batch, None, "model*" if tp else None)
    if key_leaf == "ssm":
        return (batch, "model" if shape[1] % m == 0 and m > 1 else None,
                None, None)
    return (None,) * len(shape)


def fsdp_axis(mesh) -> str | None:
    if mesh is None:
        return None
    return "data" if "data" in (mesh.mesh_dim_names or ()) else None


def local_slice(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` on ``mesh``: each dim
    cut into equal contiguous blocks over its axes (several axes: the
    first outermost), as ``jax.sharding`` tiles. A cut block is a copy
    of its own, so it never keeps ``full``'s storage alive; an uncut
    leaf is ``full`` itself (contiguous)."""
    spec = _drop_indivisible(mesh, spec, tuple(full.shape))
    t = full
    for dim, s in enumerate(spec):
        axes = _axes(s)
        if not axes:
            continue
        idx, size = 0, 1
        for a in axes:
            n = axis_size(mesh, a)
            idx = idx * n + mesh.get_local_rank(a)
            size *= n
        t = t.chunk(size, dim)[idx]
    if t is full:
        return t.contiguous()
    return t.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# The port's layouts and collectives
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """How one parameter lies on the mesh. ``mdim``: the dim cut over
    ``model``, every rank's indices along it in ``mindex`` (M, k) (equal
    counts; an index may sit on several ranks); ``ddim``: the dim then
    cut into D contiguous blocks over ``data``; ``gather``: whether the
    data blocks are all-gathered before use (FSDP) or stay stationary
    (ep2d's experts)."""
    shape: tuple
    mdim: int | None = None
    mindex: torch.Tensor | None = None
    ddim: int | None = None
    gather: bool = False
    #: whether an index along ``mdim`` sits on more than one rank
    dup: bool = False
    #: the spec :func:`local_slice` cuts by: the rule's axes that cut
    #: contiguous blocks (``model`` only where ``mindex`` is the rule's
    #: own contiguous cut)
    spec: tuple = ()
    #: whether ``mindex`` is a module's own index (heads kept, Mamba2's
    #: columns), taken before the contiguous cut
    custom: bool = False


def _backend(group) -> str:
    return str(dist.get_backend(group))


#: ``observer(op, result)`` for each collective below over more than one
#: rank while set (``launch.op_analysis`` counts their bytes by it): op is
#: "all-gather", "reduce-scatter" or "all-reduce", ``result`` the rank's
#: result
collective_observer = None


def _observe(op: str, result: torch.Tensor) -> torch.Tensor:
    if collective_observer is not None:
        collective_observer(op, result)
    return result


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return _observe("all-gather", torch.cat(parts, dim=dim))


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The sum over ``group`` of ``x``, this rank's block along ``dim``
    (NCCL's reduce-scatter, as on the dry run's fake group, which stands
    for NCCL ranks; an all-reduce and a slice on gloo)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    r = dist.get_rank(group)
    if any(b in _backend(group) for b in ("nccl", "fake")):
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, group=group)
        return _observe("reduce-scatter", out.movedim(0, dim).contiguous())
    full = x.contiguous().clone()
    dist.all_reduce(full, group=group)
    return _observe("reduce-scatter", full.chunk(n, dim)[r].contiguous())


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction over ``group`` of ``x`` (a new tensor)."""
    out = x.contiguous().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(out, op=op, group=group)
        _observe("all-reduce", out)
    return out


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherData(torch.autograd.Function):
    """FSDP: all-gather along ``dim`` forward, reduce-scatter (sum) of the
    gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_dim(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.group, ctx.dim), None, None


class _DupSum(torch.autograd.Function):
    """Identity forward; backward, the gradient of each index along
    ``dim`` summed over every rank that holds it (K/V heads kept by
    several ranks)."""

    @staticmethod
    def forward(ctx, x, group, dim, mindex, full):
        ctx.group, ctx.dim, ctx.mindex, ctx.full = group, dim, mindex, full
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        idx = ctx.mindex[r].to(g.device)
        shape = list(g.shape)
        shape[ctx.dim] = ctx.full
        acc = g.new_zeros(shape).index_add_(ctx.dim, idx, g)
        acc = all_reduce(acc, ctx.group)
        return acc.index_select(ctx.dim, idx), None, None, None, None


class LMShard:
    """The LM's place on a ``("data", "model")`` or ``("pod", "data",
    "model")`` ``DeviceMesh``: this rank's coordinates and groups, and
    the parameter layout (``fsdp``: weights' FSDP dims over ``data``;
    ``ep2d``: the experts 2-D, d_ff over ``data``, the rest model-TP
    alone). ``msize``/``mrank``/``mgroup`` are the model axis's size,
    this rank's index on it and its group; ``d*`` the data axis's, ``p*``
    the pod axis's, ``b*`` the batch's (pod, data) shards'. A mesh
    without one of the axes has it at size 1 and group None."""

    def __init__(self, mesh, *, fsdp: bool = False, ep2d: bool = False):
        # ``repro`` lays a 2-D model out with ``fsdp=False`` but the experts
        self.mesh, self.fsdp, self.ep2d = mesh, fsdp and not ep2d, ep2d
        names = mesh.mesh_dim_names or ()
        for a, short in (("model", "m"), ("data", "d"), ("pod", "p")):
            has = a in names
            setattr(self, f"{short}size", axis_size(mesh, a))
            setattr(self, f"{short}rank", mesh.get_local_rank(a) if has else 0)
            setattr(self, f"{short}group", mesh.get_group(a) if has else None)
        #: the mesh's batch axes, (pod, data) where present, and how many
        #: ranks they span
        self.batch_axes = batch_axes(mesh) or ()
        self.bsize = self.psize * self.dsize

    # -- layouts ----------------------------------------------------------

    def spec(self, name: str, ndim: int) -> tuple:
        return param_specs({name: (0,) * ndim}, fsdp=self.fsdp,
                           expert_data=self.ep2d)[name]

    def layout(self, name: str, shape: tuple, *, tp: bool = True,
               model_index=None) -> Layout:
        """The layout of parameter ``name`` (its rule's leaf name) of full
        ``shape``: the rule's spec with indivisible axes dropped. ``tp``
        False replicates it over ``model``; ``model_index`` (mdim, (M, k)
        indices) replaces the rule's contiguous model cut."""
        spec = _drop_indivisible(self.mesh, self.spec(name, len(shape)),
                                 tuple(shape))
        mdim = spec.index("model") if "model" in spec and tp else None
        mindex, custom = None, False
        if model_index is not None and tp and self.msize > 1:
            (mdim, mindex), custom = model_index, True
        elif mdim is not None and self.msize > 1:
            k = shape[mdim] // self.msize
            mindex = torch.arange(shape[mdim]).view(self.msize, k)
        else:
            mdim = None
        ddim = spec.index("data") if "data" in spec \
            and self.dsize > 1 else None
        gather = ddim is not None and not (self.ep2d and
                                           name in _EP2D_RULES)
        dup = mindex is not None and \
            int(mindex.unique().numel()) < mindex.numel()
        cut = tuple(a if (a == "model" and mdim is not None and not custom)
                    or (a == "data" and ddim is not None) else None
                    for a in spec)
        return Layout(tuple(shape), mdim, mindex, ddim, gather, dup, cut,
                      custom)

    def local_shape(self, lay: Layout) -> tuple:
        shape = list(lay.shape)
        if lay.mdim is not None:
            shape[lay.mdim] = lay.mindex.shape[1]
        if lay.ddim is not None:
            shape[lay.ddim] //= self.dsize
        return tuple(shape)

    def cut(self, full: torch.Tensor, lay: Layout) -> torch.Tensor:
        """This rank's local tensor of the full leaf ``full``: a module's
        own model index first, then :func:`local_slice`'s blocks."""
        if lay.custom:
            full = full.index_select(lay.mdim,
                                     lay.mindex[self.mrank].to(full.device))
        return local_slice(full, lay.spec, self.mesh)

    def gather(self, local: torch.Tensor, lay: Layout) -> torch.Tensor:
        """The full leaf from every rank's local tensor (every rank of the
        mesh calls it; every rank gets the leaf)."""
        t = local.detach()
        if lay.ddim is not None:
            t = all_gather_dim(t, self.dgroup, lay.ddim)
        if lay.mdim is None:
            return t
        parts = all_gather_dim(t.unsqueeze(0), self.mgroup, 0)
        full = t.new_empty(lay.shape)
        for r in range(self.msize):
            full.index_copy_(lay.mdim, lay.mindex[r].to(t.device), parts[r])
        return full

    # -- collectives the modules call ---------------------------------------

    def use(self, p: torch.Tensor, lay: Layout | None,
            gather: bool | None = None) -> torch.Tensor:
        """Parameter ``p`` as the rank computes with it: an FSDP'd block
        all-gathered over ``data`` (``gather`` overrides the layout's
        choice: ep2d's stationary experts are gathered for a prefill); a
        K/V-head slice whose heads sit on several ranks with its gradient
        summed over them."""
        if lay is None:
            return p
        if (lay.gather if gather is None else gather) and \
                lay.ddim is not None:
            p = _GatherData.apply(p, self.dgroup, lay.ddim)
        if lay.dup and torch.is_grad_enabled() and p.requires_grad:
            p = _DupSum.apply(p, self.mgroup, lay.mdim, lay.mindex,
                              lay.shape[lay.mdim])
        return p

    def world_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over every rank of the mesh (no gradient)."""
        for g in (self.mgroup, self.dgroup, self.pgroup):
            if g is not None and dist.get_world_size(g) > 1:
                x = all_reduce(x, g)
        return x

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """Into a model-parallel region: identity, gradient all-reduced."""
        if self.msize == 1 or not torch.is_grad_enabled():
            return x
        return _Enter.apply(x, self.mgroup)

    def reduce(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Out of a model-parallel region (after a row-parallel product):
        the sum over ``model`` (or ``group``), gradient passed through."""
        group = self.mgroup if group is None else group
        if group is None or dist.get_world_size(group) == 1:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _Reduce.apply(x, group)
        return all_reduce(x, group)

    def model_cat(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' blocks along ``dim`` over ``model`` (no gradient)."""
        return all_gather_dim(x, self.mgroup, dim % x.dim()) \
            if self.msize > 1 else x

    def batch(self, b: int) -> "BatchShard":
        """A global batch of ``b`` rows on the mesh: sharded over
        ``batch_axes_for``'s axes (pod-major), else run whole on every
        rank."""
        axes = batch_axes_for(self.mesh, b) or ()
        size, index = 1, 0
        for a in axes:
            n = axis_size(self.mesh, a)
            size, index = size * n, index * n + self.mesh.get_local_rank(a)
        n = b // size
        return BatchShard(axes, size, index, slice(index * n, (index + 1) * n),
                          self.bsize // size)

    def _batch_groups(self, axes: tuple) -> list:
        """The groups of ``axes``, innermost (data) first."""
        return [g for a, g in (("data", self.dgroup), ("pod", self.pgroup))
                if a in axes and g is not None
                and dist.get_world_size(g) > 1]

    def batch_cat(self, x: torch.Tensor, axes: tuple, dim: int = 0
                  ) -> torch.Tensor:
        """The blocks of a batch sharded over ``axes`` concatenated in
        block order (no gradient)."""
        for g in self._batch_groups(axes):
            x = all_gather_dim(x, g, dim)
        return x

    def batch_sum(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        """The sum over the ranks of ``axes`` (no gradient)."""
        for g in self._batch_groups(axes):
            x = all_reduce(x, g)
        return x

    def batch_mean(self, x: torch.Tensor, axes: tuple) -> torch.Tensor:
        """The mean over the ranks of ``axes`` (``repro``'s ``pmean`` over
        the data axes), each rank's gradient passed to its own term."""
        n = 1
        for g in self._batch_groups(axes):
            x, n = self.reduce(x, g), n * dist.get_world_size(g)
        return x / n

    def replication(self, lay: Layout | None) -> torch.Tensor | float:
        """1 / how many ranks hold each element of a parameter of layout
        ``lay``, for a global norm that counts each element once: a
        float, or a tensor broadcast along ``mdim`` when heads repeat."""
        w = 1.0 / self.psize
        if lay is None or lay.mdim is None:
            w /= self.msize
        if lay is None or lay.ddim is None:
            w /= self.dsize
        if lay is not None and lay.dup:
            counts = torch.bincount(lay.mindex.flatten(),
                                    minlength=lay.shape[lay.mdim])
            mine = counts[lay.mindex[self.mrank]].to(torch.float32)
            shape = [1] * len(lay.shape)
            shape[lay.mdim] = -1
            return (w / mine).view(shape)
        return w


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """How a global batch lies on the mesh (:meth:`LMShard.batch`): cut
    over ``axes`` (() when every rank runs all of it) into ``size``
    blocks, this rank's block ``index`` and its ``rows``; ``replicas``
    ranks of the batch axes run each row."""
    axes: tuple
    size: int
    index: int
    rows: slice
    replicas: int


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one leaf lies on a mesh (``repro``'s ``NamedSharding`` of a
    leaf): the shard and the leaf's layout. ``cut`` gives this rank's
    local tensor of a full leaf, ``gather`` the full leaf back (every
    rank of the mesh calls it)."""
    shard: "LMShard"
    layout: Layout

    def cut(self, full: torch.Tensor) -> torch.Tensor:
        return self.shard.cut(full, self.layout)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        return self.shard.gather(local, self.layout)


def shard_of(mesh, *, fsdp: bool = False, ep2d: bool = False
             ) -> LMShard | None:
    """An :class:`LMShard` on ``mesh`` (None without one)."""
    return None if mesh is None else LMShard(mesh, fsdp=fsdp, ep2d=ep2d)
