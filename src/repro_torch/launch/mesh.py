"""Rank meshes over ``torch.distributed``.

A :class:`Mesh` is a ``(data, model)`` grid of ranks, data-major
(``rank = d * model + m``), the order ``jax.make_mesh((data, model))``
gives its devices; with ``node > 1`` a ``(data, node, model)`` grid
(``rank = (d * node + n) * model + m``), the reference's node mesh, whose
expert parallelism spans ``("node", "model")`` node-major and whose ragged
exchange runs two-level (``core.fmoe.DistConfig.node_axis``).  It holds
the process groups of the world, of each axis, and on a node mesh of
("node", "model"): each the ranks that share the other axes'
coordinates.

    dev = init_distributed("cuda")   # NCCL; "cpu" for gloo
    mesh = make_local_mesh(data=2, model=2)

``init_distributed`` reads the ``torchrun`` environment, or takes an
explicit store, rank and world size.
"""
from __future__ import annotations

import datetime
import itertools
import os

import torch
import torch.distributed as dist

from repro_torch.device import resolve

AXES = ("data", "model")
NODE_AXES = ("data", "node", "model")
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """A (data, model) grid of ranks, or (data, node, model) with ``node >
    1``, and its process groups.

    ``groups`` maps "world" and each set of axes with a group (a
    frozenset: each axis, and the expert axes) to this rank's groups; a
    mesh built without them (shape and rank only) serves the shape math
    of ``interop`` and ``DistConfig`` and refuses any collective.
    """

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0,
                 groups: dict | None = None, *, node: int = 1):
        if (data < 1 or model < 1 or node < 1
                or not 0 <= rank < data * node * model):
            raise ValueError(f"bad mesh {data}x{node}x{model} for rank {rank}")
        self.axis_names = NODE_AXES if node > 1 else AXES
        self.shape = {"data": data, "model": model}
        if node > 1:
            self.shape = {"data": data, "node": node, "model": model}
        self.rank = rank
        self.groups = groups

    @property
    def size(self) -> int:
        return self.axes_size(self.axis_names)

    @property
    def expert_axes(self) -> tuple:
        """The axes the routed experts shard over, node-major."""
        return tuple(a for a in self.axis_names if a != "data")

    def coords(self, rank: int | None = None) -> tuple:
        """The coordinates of ``rank`` (default: this rank) in
        ``axis_names`` order: (d, m), or (d, n, m) on a node mesh."""
        r = self.rank if rank is None else rank
        out = []
        for a in reversed(self.axis_names):
            r, c = divmod(r, self.shape[a])
            out.append(c)
        return tuple(reversed(out))

    def axis_index(self, axes, rank: int | None = None) -> int:
        """``rank``'s index over ``axes``, row-major in mesh order: its
        rank within the group of those axes."""
        i = 0
        for a, c in zip(self.axis_names, self.coords(rank)):
            if a in _as_axes(axes):
                i = i * self.shape[a] + c
        return i

    def expert_shard(self, num_experts: int, hidden: int, *, tp: bool = False,
                     rank: int | None = None) -> tuple:
        """(experts, hidden units) of ``rank``'s shard of a routed expert
        stack, as slices: rank ``m`` of the model axis (on a node mesh,
        index ``n * model + m`` over (node, model)) holds experts ``[m *
        E_local, (m + 1) * E_local)``; under expert-internal tensor
        parallelism (``tp``) rank ``d`` of the data axis holds hidden units
        ``[d * H_local, (d + 1) * H_local)`` of them, else all."""
        mp = self.axes_size(self.expert_axes)
        dp = self.shape["data"] if tp else 1
        if num_experts % mp or hidden % dp:
            raise ValueError(f"{num_experts} experts of hidden {hidden} do "
                             f"not shard over mesh {self.shape}"
                             f"{' (tp)' if tp else ''}")
        m = self.axis_index(self.expert_axes, rank)
        d = self.axis_index("data", rank)
        e, h = num_experts // mp, hidden // dp
        return (slice(m * e, (m + 1) * e),
                slice(d * h, (d + 1) * h) if tp else slice(0, hidden))

    def axes_size(self, axes) -> int:
        n = 1
        for a in _as_axes(axes):
            n *= self.shape[a]
        return n

    def group(self, axes):
        """The process group spanning ``axes`` (any of the mesh's axes, or
        all of them: the world)."""
        axes = frozenset(_as_axes(axes))
        if self.groups is None:
            raise RuntimeError(
                "this mesh has no process groups; build it with "
                "make_local_mesh() after init_distributed()")
        if axes == frozenset(self.axis_names):
            return self.groups["world"]
        if axes in self.groups:
            return self.groups[axes]
        raise ValueError(f"no group for axes {sorted(axes)}")

    def __repr__(self) -> str:
        node = (f", node={self.shape['node']}" if "node" in self.shape
                else "")
        return (f"Mesh(data={self.shape['data']}, model={self.shape['model']}"
                f"{node}, rank={self.rank})")


def _as_axes(axes) -> tuple:
    return tuple(axes) if isinstance(axes, (tuple, list)) else (axes,)


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


def make_local_mesh(data: int = 1, model: int = 1, node: int = 1) -> Mesh:
    """The (data, model) mesh over the initialized world, or (data, node,
    model) with ``node > 1``.

    ``torch.distributed.new_group`` is collective: every rank creates every
    group, in the same order, and keeps its own.  A group that spans the
    whole world is the default group itself."""
    if not dist.is_initialized():
        raise RuntimeError("call init_distributed() first")
    world = dist.get_world_size()
    if data * node * model != world:
        raise ValueError(f"mesh {data}x{node}x{model} needs "
                         f"{data * node * model} ranks; the world has {world}")
    mesh = Mesh(data, model, dist.get_rank(), node=node)
    names = mesh.axis_names
    groups = {"world": dist.group.WORLD}
    spans = [(a,) for a in names]
    if len(mesh.expert_axes) > 1:
        spans.append(mesh.expert_axes)
    for axes in spans:
        # one group per coordinate of the other axes; the ranks of a group,
        # sorted, are row-major over ``axes``
        rest = [i for i, a in enumerate(names) if a not in axes]

        def key(r):
            return [mesh.coords(r)[i] for i in rest]
        for fixed in itertools.product(*(range(mesh.shape[names[i]])
                                          for i in rest)):
            ranks = [r for r in range(world) if key(r) == list(fixed)]
            g = (dist.group.WORLD if len(ranks) == world
                 else dist.new_group(ranks))
            if list(fixed) == key(mesh.rank):
                groups[frozenset(axes)] = g
    mesh.groups = groups
    return mesh


def node_axis(mesh):
    """The inter-node axis name, or None for a mesh without one."""
    return "node" if "node" in mesh.axis_names else None


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in mesh.axis_names if a == "data")


def all_axes(mesh) -> tuple:
    return tuple(mesh.axis_names)
