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
the data axis on their hidden dim too (``tp``: no sync at all).  The
reference derives the tag from a PartitionSpec; here the param's path and
the ``DistConfig`` decide.
"""
from __future__ import annotations

import torch
import torch.distributed


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


def fastmoe_tag(path: str, dist=None) -> str:
    """``world`` for a leaf outside the routed expert stacks (router,
    attention, norms, embedding, head, shared and dense residual FFNs); for
    a routed expert stack (a leaf under an "experts" key) ``tp`` where
    ``dist`` (a ``core.fmoe.DistConfig``) shards it over ``tp_axis`` too
    (``dist.expert_tp``), else ``none``."""
    if "experts" not in path.split("/"):
        return "world"
    return "tp" if dist is not None and dist.expert_tp else "none"


def sync_grads(grads, dist):
    """All-reduce every gradient in place within its tag's group under
    ``dist`` (a ``core.fmoe.DistConfig`` over a mesh) and return
    ``grads``.

    Each rank's loss is the mean over its own tokens, so the step's
    gradient is the mean of the ranks' gradients: a ``world`` leaf takes
    the SUM over the world / world size.  An expert leaf (``none``) takes
    the SUM over the data group / the *world* size, since the exchange's
    backward already summed the other model ranks' contributions into it.
    A ``tp`` expert leaf takes no all-reduce, only the division: each data
    rank holds another hidden slice, and the row all-gather's backward
    already summed every data rank's rows into it.

    The psum mode needs nothing else: there the M ranks of a model group
    hold the same rows and loss, and the all-reduce's backward hands each
    M times its part of that loss's gradient (experts: M times the whole),
    so the SUM over the world (experts: over data) is M times the sum over
    the data blocks, and / world is their mean."""
    mesh = dist.mesh
    world = mesh.size
    groups = {"world": mesh.group(mesh.axis_names),
              "none": mesh.group("data"), "tp": None}
    for path, g in tagged_leaves(grads):
        group = groups[fastmoe_tag(path, dist)]
        if group is not None:
            torch.distributed.all_reduce(g, group=group)
        if world > 1:
            g.div_(world)
    return grads


def sharded_sq_norms(tree, dist) -> list:
    """Per leaf, the f32 sum of squares of the *whole* gradient under
    ``dist``: an expert leaf's squares are summed over the ranks that hold
    its shards (``none``: the expert axes' group; ``tp``: the world), a
    ``world`` leaf's are its own.  One all-reduce per expert tag."""
    mesh = dist.mesh
    tagged = list(tagged_leaves(tree))
    sq = [torch.sum(torch.square(leaf.float())) for _, leaf in tagged]
    for tag, group in (("none", mesh.group(dist.expert_axes)),
                       ("tp", mesh.group(mesh.axis_names))):
        idx = [i for i, (path, _) in enumerate(tagged)
               if fastmoe_tag(path, dist) == tag]
        if idx:
            summed = torch.stack([sq[i] for i in idx])
            torch.distributed.all_reduce(summed, group=group)
            for j, i in enumerate(idx):
                sq[i] = summed[j]
    return sq
