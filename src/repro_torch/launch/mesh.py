"""Rank meshes over ``torch.distributed``.

A :class:`Mesh` is a ``(data, model)`` grid of ranks, data-major
(``rank = d * model + m``), the order ``jax.make_mesh((data, model))``
gives its devices.  It holds the process groups of the world, of the
model axis (the ranks that share ``d``: the expert axis) and of the data
axis (the ranks that share ``m``).

    dev = init_distributed("cuda")   # NCCL; "cpu" for gloo
    mesh = make_local_mesh(data=2, model=2)

``init_distributed`` reads the ``torchrun`` environment, or takes an
explicit store, rank and world size.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve

AXES = ("data", "model")
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """A (data, model) grid of ranks and its process groups.

    ``groups`` maps "world", "data" and "model" to this rank's groups; a
    mesh built without them (shape and rank only) serves the shape math of
    ``interop`` and ``DistConfig`` and refuses any collective.
    """

    axis_names = AXES

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0,
                 groups: dict | None = None):
        if data < 1 or model < 1 or not 0 <= rank < data * model:
            raise ValueError(f"bad mesh {data}x{model} for rank {rank}")
        self.shape = {"data": data, "model": model}
        self.rank = rank
        self.groups = groups

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    def coords(self, rank: int | None = None) -> tuple:
        """(d, m) of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        return divmod(r, self.shape["model"])

    def expert_shard(self, num_experts: int, hidden: int, *, tp: bool = False,
                     rank: int | None = None) -> tuple:
        """(experts, hidden units) of ``rank``'s shard of a routed expert
        stack, as slices: rank ``m`` of the model axis holds experts ``[m *
        E_local, (m + 1) * E_local)``; under expert-internal tensor
        parallelism (``tp``) rank ``d`` of the data axis holds hidden units
        ``[d * H_local, (d + 1) * H_local)`` of them, else all."""
        d, m = self.coords(rank)
        mp, dp = self.shape["model"], self.shape["data"] if tp else 1
        if num_experts % mp or hidden % dp:
            raise ValueError(f"{num_experts} experts of hidden {hidden} do "
                             f"not shard over mesh {self.shape}"
                             f"{' (tp)' if tp else ''}")
        e, h = num_experts // mp, hidden // dp
        return (slice(m * e, (m + 1) * e),
                slice(d * h, (d + 1) * h) if tp else slice(0, hidden))

    def axes_size(self, axes) -> int:
        n = 1
        for a in _as_axes(axes):
            n *= self.shape[a]
        return n

    def group(self, axes):
        """The process group spanning ``axes`` ("data", "model", or both)."""
        axes = set(_as_axes(axes))
        if self.groups is None:
            raise RuntimeError(
                "this mesh has no process groups; build it with "
                "make_local_mesh() after init_distributed()")
        if axes == set(AXES):
            return self.groups["world"]
        if len(axes) == 1 and axes <= set(AXES):
            return self.groups[axes.pop()]
        raise ValueError(f"no group for axes {sorted(axes)}")

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']},"
                f" rank={self.rank})")


def _as_axes(axes) -> tuple:
    return axes if isinstance(axes, (tuple, list)) else (axes,)


def init_distributed(device="cuda", *, rank: int | None = None,
                     world_size: int | None = None, store=None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT
                     ) -> torch.device:
    """Join the default process group and return this rank's device.

    NCCL for a CUDA device, gloo for the CPU.  Without ``store`` the
    ``torchrun`` environment (RANK, WORLD_SIZE, MASTER_ADDR/PORT) is read;
    with one, ``rank`` and ``world_size`` must be given.  A CUDA rank takes
    ``cuda:LOCAL_RANK`` unless ``device`` names an index."""
    dev = resolve(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if store is not None:
            if rank is None or world_size is None:
                raise ValueError("a store needs rank and world_size")
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world_size, timeout=timeout)
        else:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
    return dev


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """The (data, model) mesh over the initialized world.

    ``torch.distributed.new_group`` is collective: every rank creates every
    group, in the same order, and keeps its own.  A group that spans the
    whole world is the default group itself."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed() first")
    world = dist.get_world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} ranks; "
                         f"the world has {world}")
    rank = dist.get_rank()
    d_me, m_me = divmod(rank, model)

    def new_group(ranks):
        return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)

    model_groups = [new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    data_groups = [new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    return Mesh(data, model, rank, {"world": dist.group.WORLD,
                                    "model": model_groups[d_me],
                                    "data": data_groups[m_me]})


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in mesh.axis_names if a == "data")


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)
