"""FastMoE's gradient synchronization (paper §3.2), as explicit
process-group all-reduces.

FastMoE tags every parameter ``world`` / ``data parallel`` / ``none`` and
its ``DistributedGroupedDataParallel`` all-reduces each gradient within
its tag's group.  In the port every param but the routed expert stacks is
replicated on every rank (``world``); the expert stacks are sharded over
the model axis on their expert dim and replicated over the data axis
(``none``: no sync across expert peers, a sync over ``data`` when the
mesh has one).  The reference derives the tag from a PartitionSpec; here
the param's path decides.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


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


def fastmoe_tag(path: str) -> str:
    """``none`` for a routed expert stack (a leaf under an "experts" key),
    ``world`` for everything else: router, attention, norms, embedding,
    head, shared and dense residual FFNs."""
    return "none" if "experts" in path.split("/") else "world"


def sync_grads(grads, mesh):
    """All-reduce every gradient in place within its tag's group and
    return ``grads``.

    Each rank's loss is the mean over its own tokens, so the step's
    gradient is the mean of the ranks' gradients: a ``world`` leaf takes
    the SUM over the world / world size.  An expert leaf takes the SUM
    over the data group / the *world* size, since the exchange's backward
    already summed the other model ranks' contributions into it."""
    world = mesh.size
    groups = {"world": mesh.group(mesh.axis_names),
              "none": mesh.group("data")}
    for path, g in tagged_leaves(grads):
        dist.all_reduce(g, group=groups[fastmoe_tag(path)])
        if world > 1:
            g.div_(world)
    return grads


def sharded_sq_norms(tree, mesh) -> list:
    """Per leaf, the f32 sum of squares of the *whole* gradient: an expert
    leaf's squares are summed over the model group (each rank holds its
    shard), a ``world`` leaf's are its own.  One all-reduce."""
    tagged = list(tagged_leaves(tree))
    sq = [torch.sum(torch.square(leaf.float())) for _, leaf in tagged]
    expert = [i for i, (path, _) in enumerate(tagged)
              if fastmoe_tag(path) == "none"]
    if expert:
        summed = torch.stack([sq[i] for i in expert])
        dist.all_reduce(summed, group=mesh.group("model"))
        for j, i in enumerate(expert):
            sq[i] = summed[j]
    return sq
