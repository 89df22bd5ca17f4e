"""FastMoE's gradient synchronization (paper §3.2), as explicit
process-group all-reduces.

FastMoE tags every parameter ``world`` / ``data parallel`` / ``none`` and
its ``DistributedGroupedDataParallel`` all-reduces each gradient within
its tag's group.  In the port every param but the routed expert stacks is
replicated on every rank (``world``); the expert stacks are sharded over
the model axis (on a node mesh over node and model) on their expert dim
and replicated over the data axis
(``none``: no sync across expert peers, a sync over ``data`` when the
mesh has one), or, under expert-internal tensor parallelism, sharded over
the data axis on their hidden dim too (``tp``: no sync at all).  Under an
expert placement with shadowed experts, the tail rows of a rank's expert
stacks are the shadowed experts, replicated on every rank (``shadow``:
summed over the world, as a ``world`` leaf is; in the reference
shard_map's transpose sums their gradient so).  The reference derives the
tag from a PartitionSpec; here the param's path and the ``DistConfig``
decide.

The gradient's global norm sums each expert's squares in logical expert
order (gathered over the ranks that hold the experts, each shadowed expert
once), so it does not depend on the placement or the mesh: a placed step
clips exactly as the unplaced one does.
"""
from __future__ import annotations

import torch
import torch.distributed

from repro_torch.core import comm
from repro_torch.core.dispatch import device_index_table


def tagged_leaves(tree, path: str = ""):
    """(path, leaf) of every tensor of a param or grad tree, in
    ``optim.adamw.tree_leaves`` order; paths join keys and list indices
    with "/"."""
    if isinstance(tree, dict):
        for k in tree:
            yield from tagged_leaves(tree[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tagged_leaves(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def layer_of(path: str):
    """The layer index of a leaf path ("layers/3/ffn/experts/wi" -> 3;
    the AdamW state's "1/layers/3/..." too), or None."""
    parts = path.split("/")
    for i, k in enumerate(parts[:-1]):
        if k == "layers" and parts[i + 1].isdigit():
            return int(parts[i + 1])
    return None


def fastmoe_tag(path: str, dist=None) -> str:
    """``world`` for a leaf outside the routed expert stacks (router,
    attention, norms, embedding, head, shared and dense residual FFNs); for
    a routed expert stack (a leaf under an "experts" key) ``tp`` where
    ``dist`` (a ``core.fmoe.DistConfig``) shards it over ``tp_axis`` too
    (``dist.expert_tp``), else ``none``."""
    if "experts" not in path.split("/"):
        return "world"
    return "tp" if dist is not None and dist.expert_tp else "none"


def _num_shadow(dist) -> int:
    place = dist.placement if dist is not None else None
    return 0 if place is None else int(place.num_shadow)


def tagged_parts(tree, dist):
    """(path, tag, tensor) of every gradient part under ``dist``: a leaf,
    or for an expert leaf under shadowing its owned rows (``none``) and its
    shadowed tail rows (``shadow``), as views."""
    S = _num_shadow(dist) if dist.mesh is not None else 0
    for path, g in tagged_leaves(tree):
        tag = fastmoe_tag(path, dist)
        if tag == "none" and S:
            yield path, "none", g[:g.shape[0] - S]
            yield path, "shadow", g[g.shape[0] - S:]
        else:
            yield path, tag, g


def sync_grads(grads, dist):
    """All-reduce every gradient in place within its tag's group under
    ``dist`` (a ``core.fmoe.DistConfig`` over a mesh) and return
    ``grads``.

    Each rank's loss is the mean over its own tokens, so the step's
    gradient is the mean of the ranks' gradients: a ``world`` leaf takes
    the SUM over the world / world size, and so do the ``shadow`` rows of
    an expert leaf (every rank computed the shadowed experts on its own
    rows).  An owned expert part (``none``) takes the SUM over the data
    group / the *world* size, since the exchange's backward already summed
    the other model ranks' contributions into it.  A ``tp`` expert leaf
    takes no all-reduce, only the division: each data rank holds another
    hidden slice, and the row all-gather's backward already summed every
    data rank's rows into it.

    The psum mode needs nothing else: there the M ranks of a model group
    hold the same rows and loss, and the all-reduce's backward hands each
    M times its part of that loss's gradient (experts: M times the whole),
    so the SUM over the world (experts: over data) is M times the sum over
    the data blocks, and / world is their mean.  Under a placement the
    shadowed experts run outside the all-reduce, once on each of the M
    ranks on the same rows: each rank's ``shadow`` rows hold its data
    block's gradient once, so their SUM over the world is again M times
    the sum over the data blocks, and / world their mean; a ``world``
    leaf (the router, upstream) takes M times the owned part and M times
    the shadow part summed over its model group, the same mean."""
    mesh = dist.mesh
    world = mesh.size
    groups = {"world": mesh.group(mesh.axis_names),
              "shadow": mesh.group(mesh.axis_names),
              "none": mesh.group("data"), "tp": None}
    for _, tag, g in tagged_parts(grads, dist):
        group = groups[tag]
        if group is not None:
            torch.distributed.all_reduce(g, group=group)
        if world > 1:
            g.div_(world)
    return grads


def _expert_sq(leaf: torch.Tensor) -> torch.Tensor:
    """Each expert's f32 sum of squares: (rows,)."""
    return torch.sum(torch.square(leaf.float()).reshape(leaf.shape[0], -1),
                     dim=1)


def sharded_sq_norms(tree, dist) -> list:
    """Per leaf, the f32 sum of squares of the *whole* gradient under
    ``dist`` (a ``DistConfig``; with no mesh, the tree is whole).

    A ``world`` leaf's squares are its own.  An expert leaf's are summed
    expert by expert: each expert's squares (over the data axis's hidden
    slices under ``tp``), gathered over the expert axes into the physical
    order (each shadowed expert once, from the rank's own copy), then put
    in logical order by the placement's table and summed, so the result
    does not depend on the layout.  One all-gather for all expert leaves
    (and under ``tp`` one all-reduce first).  ``dist`` None: one process,
    no placement."""
    mesh = None if dist is None else dist.mesh
    place = None if dist is None else dist.placement
    tagged = list(tagged_leaves(tree))
    sq = [None] * len(tagged)
    idx = []
    for i, (path, leaf) in enumerate(tagged):
        if fastmoe_tag(path, dist) == "world":
            sq[i] = torch.sum(torch.square(leaf.float()))
        else:
            idx.append(i)
    if not idx:
        return sq
    per = torch.stack([_expert_sq(tagged[i][1]) for i in idx])  # (n, rows)
    if mesh is not None:
        if dist.expert_tp:
            torch.distributed.all_reduce(per, group=mesh.group("data"))
        mp = mesh.axes_size(dist.expert_axes)
        if mp > 1:
            S = _num_shadow(dist)
            own = comm.all_gather_rows(per[:, :per.shape[1] - S],
                                       mesh.group(dist.expert_axes), dim=1)
            per = torch.cat([own, per[:, per.shape[1] - S:]], dim=1)
    tables = (None if place is None or place.is_identity
              else device_index_table(place, per.device))
    for j, i in enumerate(idx):
        v = per[j]
        if tables is not None:
            v = v[tables if tables.ndim == 1
                  else tables[layer_of(tagged[i][0])]]
        sq[i] = v.sum()
    return sq
