"""FastMoE's gradient synchronization (paper §3.2), as explicit
process-group all-reduces.

FastMoE tags every parameter ``world`` / ``data parallel`` / ``none`` and
its ``DistributedGroupedDataParallel`` all-reduces each gradient within
its tag's group.  As in the reference, the tags follow from each leaf's
spec in the params' layout (``DistConfig.layout``, a
``launch.sharding.Layout``; training on a mesh holds the train layout):
:func:`spec_axes`, :func:`grad_sync_axes` (the axes a leaf is replicated
over, which its gradient is all-reduced over), :func:`fastmoe_tag`
(``world`` / ``dp`` / ``none``) and :func:`sync_report`.  The gather of a
leaf's shard at its use (``core.comm.gather_shard``) reduce-scatters its
gradient over the axes it is sharded on, so :func:`sync_grads` only
all-reduces over the rest.  Under an expert placement with shadowed
experts, the tail rows of a rank's expert stacks are the shadowed experts,
replicated on every rank (``shadow``: summed over the expert axes too; in
the reference shard_map's transpose sums their gradient so).

The gradient's global norm sums a leaf's squares once over its shard axes,
and each expert's squares in logical expert order (gathered over the ranks
that hold the experts, each shadowed expert once), so it does not depend
on the placement or the mesh: a placed step clips exactly as the unplaced
one does.
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


def spec_axes(spec) -> set:
    """Mesh axes a spec shards over."""
    axes: set = set()
    for entry in spec or ():
        if entry is None:
            continue
        if isinstance(entry, (tuple, list)):
            axes.update(entry)
        else:
            axes.add(entry)
    return axes


def grad_sync_axes(spec, mesh_axes) -> tuple:
    """Mesh axes over which this parameter's gradient is all-reduced: the
    axes the parameter is *replicated* over."""
    used = spec_axes(spec)
    return tuple(a for a in mesh_axes if a not in used)


def fastmoe_tag(path: str, spec, mesh_axes, *, expert_axis: str = "model",
                data_axes: tuple = ("pod", "data")) -> str:
    """The paper's sync tag of a parameter from its spec, as the
    reference's: ``world`` (replicated on every axis but the data axes:
    router, norms), ``dp`` (sharded over a model-like axis: the attention
    and FFN shards), ``none`` (an expert leaf sharded over the expert
    axis: no sync across expert peers)."""
    used = spec_axes(spec)
    model_like = used - set(data_axes)
    if not model_like:
        return "world"
    is_expert = ("expert" in path) or ("router" not in path
                                       and path.startswith("moe"))
    if expert_axis in model_like and is_expert:
        return "none"
    return "dp"


def sync_report(specs: dict, mesh_axes) -> dict:
    """{param path: (tag, sync axes)} for a flat spec tree."""
    return {path: (fastmoe_tag(path, spec, mesh_axes),
                   grad_sync_axes(spec, mesh_axes))
            for path, spec in specs.items()}


def is_expert_path(path: str) -> bool:
    """A routed expert stack's leaf (under an "experts" key)."""
    return "experts" in path.split("/")


def _num_shadow(dist) -> int:
    place = dist.placement if dist is not None else None
    return 0 if place is None else int(place.num_shadow)


def tagged_parts(tree, dist):
    """(path, tag, tensor) of every gradient part under ``dist``: a leaf
    (``world`` outside the routed expert stacks, ``none`` in them), or for
    an expert leaf under shadowing its owned rows (``none``) and its
    shadowed tail rows (``shadow``), as views."""
    S = _num_shadow(dist) if dist.mesh is not None else 0
    for path, g in tagged_leaves(tree):
        if not is_expert_path(path):
            yield path, "world", g
        elif S:
            yield path, "none", g[:g.shape[0] - S]
            yield path, "shadow", g[g.shape[0] - S:]
        else:
            yield path, "none", g


def _layout_of(dist):
    if dist.layout is None:
        raise ValueError("the gradients of params on a mesh sync by their "
                         "specs: DistConfig.layout is unset (launch.train "
                         "sets the train layout)")
    return dist.layout


def all_reduce_axes(t: torch.Tensor, mesh, axes) -> torch.Tensor:
    """In-place SUM of ``t`` over the mesh ``axes`` (nothing over size-1
    axes): one all-reduce over their group, or one per axis where the mesh
    has no group of them together."""
    axes = tuple(a for a in mesh.axis_names
                 if a in axes and mesh.shape[a] > 1)
    if not axes:
        return t
    try:
        group = mesh.group(axes)
    except ValueError:
        for a in axes:
            comm.all_reduce_(t, mesh.group(a))
        return t
    return comm.all_reduce_(t, group)


def sync_grads(grads, dist):
    """All-reduce every gradient in place under ``dist`` (a
    ``core.fmoe.DistConfig`` over a mesh, with the params' layout) and
    return ``grads``.

    Each part SUMs over its :func:`grad_sync_axes` (the axes its spec
    replicates it over: the gather's reduce-scatter has summed the
    others), a ``shadow`` part over the expert axes too (its rows are
    replicated there), then divides by the world size.  Each rank's loss
    is the mean over its own tokens, so the step's gradient is the mean
    of the ranks' gradients: a leaf replicated everywhere takes the SUM
    over the world / world size, and so do the ``shadow`` rows of an
    expert leaf (every rank computed the shadowed experts on its own
    rows).  An owned expert part takes the SUM over the axes it is not
    sharded on / the *world* size, since the exchange's backward already
    summed the other model ranks' contributions into it; under
    expert-internal tensor parallelism (its hidden dim over ``data``) no
    all-reduce is left, only the division: the row all-gather's backward
    already summed every data rank's rows into it.

    The psum mode needs nothing else: there the M ranks of a model group
    hold the same rows and loss, and the all-reduce's backward hands each
    M times its part of that loss's gradient (experts: M times the whole),
    so the SUM over the world (experts: over data) is M times the sum over
    the data blocks, and / world is their mean.  Under a placement the
    shadowed experts run outside the all-reduce, once on each of the M
    ranks on the same rows: each rank's ``shadow`` rows hold its data
    block's gradient once, so their SUM over the world is again M times
    the sum over the data blocks, and / world their mean; a replicated
    leaf (the router, upstream) takes M times the owned part and M times
    the shadow part summed over its model group, the same mean."""
    mesh, layout = dist.mesh, _layout_of(dist)
    for path, tag, g in tagged_parts(grads, dist):
        axes = grad_sync_axes(layout.spec(path), mesh.axis_names)
        if tag == "shadow":
            axes += tuple(dist.expert_axes)
        all_reduce_axes(g, mesh, axes)
        if mesh.size > 1:
            g.div_(mesh.size)
    return grads


def _expert_sq(leaf: torch.Tensor) -> torch.Tensor:
    """Each expert's f32 sum of squares: (rows,)."""
    return torch.sum(torch.square(leaf.float()).reshape(leaf.shape[0], -1),
                     dim=1)


def sharded_sq_norms(tree, dist) -> list:
    """Per leaf, the f32 sum of squares of the *whole* gradient under
    ``dist`` (a ``DistConfig``; with no mesh, the tree is whole; on a mesh
    each leaf is its shard under ``dist.layout``).

    A leaf outside the expert stacks sums its squares over its shard axes
    (one all-reduce per set of axes).  An expert leaf's are summed expert
    by expert: each expert's squares (over its hidden shards), gathered
    over the expert axes into the physical order (each shadowed expert
    once, from the rank's own copy), then put in logical order by the
    placement's table and summed, so the result does not depend on the
    layout.  One all-gather for all expert leaves.  ``dist`` None: one
    process, no placement."""
    mesh = None if dist is None else dist.mesh
    place = None if dist is None else dist.placement
    layout = None if mesh is None else _layout_of(dist)
    tagged = list(tagged_leaves(tree))
    sq = [None] * len(tagged)
    idx = []
    by_axes: dict = {}  # shard axes -> leaves summed over them
    for i, (path, leaf) in enumerate(tagged):
        if not is_expert_path(path):
            sq[i] = torch.sum(torch.square(leaf.float()))
            if layout is not None:
                axes = frozenset(a for _, ax in layout.gather_dims(path)
                                 for a in ax if mesh.shape[a] > 1)
                if axes:
                    by_axes.setdefault(axes, []).append(i)
        else:
            idx.append(i)
    for axes, ids in by_axes.items():  # one all-reduce per set of axes
        parts = all_reduce_axes(torch.stack([sq[i] for i in ids]), mesh,
                                tuple(axes))
        for j, i in enumerate(ids):
            sq[i] = parts[j]
    if not idx:
        return sq
    per = torch.stack([_expert_sq(tagged[i][1]) for i in idx])  # (n, rows)
    if mesh is not None:
        all_reduce_axes(per, mesh, layout.expert_hidden_axes())
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
