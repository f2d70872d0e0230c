"""Meshes for the production pods, the trial plane, local hosts and the
structure server's tenants, on ``torch.distributed`` (the port of
``repro.launch.mesh``).

``repro`` runs one process that owns every device; here every rank is a
process, and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the ranks of the default process group, with ``repro``'s axis names
(``("data",)`` or ``("data", "model")``). Its size checks are
``repro``'s, with the world size in place of the device count.

The backend follows the device: ``cuda`` means NCCL, one rank a card
(``cuda:{LOCAL_RANK}``); ``cpu`` means gloo. When no default group is
initialized, the first mesh joins the launcher's group when the process
runs under ``torchrun`` (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` in
the environment, ``env://``), else initializes a one-rank group on an
in-memory store, so a plain ``python3`` process gets a mesh of one rank
with no launcher. Several ranks on one host are joined by
:func:`init_rank` (``torch.multiprocessing.spawn`` the ranks, each calls
it first).

The tenant mesh is different: ``repro``'s structure server is one process
over every local device, and so is the port's. :func:`make_tenant_mesh`
returns a :class:`TenantMesh`, a list of local devices in this process,
not a group of ranks.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device


#: how long a rank waits for the others in a collective before it fails
RANK_TIMEOUT = datetime.timedelta(seconds=300)


def init_rank(rank: int, world_size: int, store_path: str, *, device=None,
              backend: str | None = None) -> torch.device:
    """Join rank ``rank`` of ``world_size`` processes on one host to the
    default process group through a ``FileStore`` at ``store_path`` (no
    port to choose, so parallel jobs cannot collide). ``backend``
    defaults to the device's (NCCL for ``cuda``, gloo for ``cpu``);
    ``"cuda:gloo,cpu:gloo"`` runs gloo on CUDA tensors, several ranks to
    a card. Returns the rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world_size), rank=rank,
        world_size=world_size, timeout=RANK_TIMEOUT)
    return dev


def _world_size(device) -> tuple[int, str]:
    """The default group's world size and the mesh's device type. With no
    group initialized, a one-rank group on an in-memory store (NCCL on
    this rank's card, ``cuda:{LOCAL_RANK}``; gloo on the CPU)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            if dev.index is None:
                dev = torch.device("cuda",
                                   int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if _under_launcher():
            dist.init_process_group(backend, init_method="env://",
                                    timeout=RANK_TIMEOUT, **kw)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, **kw)
    return dist.get_world_size(), dev.type


def _under_launcher() -> bool:
    """Whether ``torchrun`` (or any ``env://`` launcher) started this
    process: it sets RANK, WORLD_SIZE and MASTER_ADDR."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR"))


def _mesh(device_type: str, shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production topology of ``repro``: (16, 16) ``("data",
    "model")`` over 256 ranks, or (2, 16, 16) ``("pod", "data",
    "model")`` over 512 (the pod axis an outer pure-DP axis: no weight
    shard spans pods). ``repro`` builds it over a TPU pod's chips; here
    one rank is a card, and any other world size raises."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n, kind = _world_size(device)
    if n != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the world has {n}")
    return _mesh(kind, shape, axes)


def make_trial_mesh(data: int | None = None, model: int | None = None, *,
                    device=None):
    """Mesh for the Monte-Carlo trial plane.

    Without ``model``: the 1-D ``("data",)`` mesh — ``core.experiments.
    run_trials(..., mesh=make_trial_mesh())`` shards the rep axis of a
    sweep over it, every rank by default. ``data`` must divide the
    plan's rep count.

    With ``model=M``: the 2-D ``("data", "model")`` wire mesh of the
    DISTRIBUTED trial plane — reps over ``data`` (by default every
    remaining rank) and features over ``model`` (``M`` must divide the
    plan's d), so every trial's encode -> all-gather -> central chain
    runs the paper's collectives (``distributed.WirePlan``).

    ``device`` (default cuda; raises without it) picks the backend.
    """
    n, kind = _world_size(device)
    if model is not None:
        if model < 1 or n % model != 0:
            raise ValueError(
                f"model={model} must divide the {n} local devices")
        data = (n // model) if data is None else data
        if data * model > n:
            raise ValueError(
                f"requested {data}x{model} trial mesh on {n} devices")
        return _mesh(kind, (data, model), ("data", "model"))
    data = n if data is None else data
    if data > n:
        raise ValueError(f"requested {data}-way trial mesh on {n} devices")
    return _mesh(kind, (data,), ("data",))


def make_host_mesh(data: int = 1, model: int = 1, *, device=None):
    """2-D ``("data", "model")`` mesh over the local ranks (CPU smoke,
    examples, ``distributed_learn_structure``); data * model must not
    exceed the world size."""
    n, kind = _world_size(device)
    if data * model > n:
        raise ValueError(f"requested {data}x{model} mesh on {n} devices")
    return _mesh(kind, (data, model), ("data", "model"))


@dataclasses.dataclass(frozen=True)
class TenantMesh:
    """The structure server's ``("tenant",)`` mesh: local devices of this
    process, in order. A slot bucket split over it puts part i on
    ``devices[i]``."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_tenant_mesh(tenants: int | None = None, *, devices=None
                     ) -> TenantMesh:
    """``repro``'s tenant mesh: the largest power of two <= min(tenants,
    local devices) of ``devices`` (default every local card, ``cuda:0``
    first; raises without CUDA). Slot buckets are powers of two, so the
    mesh divides every launch it can take, and tenants are independent,
    so splitting a batch over it cannot change a tenant's bits."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    size = n if tenants is None else min(tenants, n)
    while size > 1 and (size & (size - 1)):  # largest pow2 <= size
        size &= size - 1
    return TenantMesh(devices[:max(size, 1)])
