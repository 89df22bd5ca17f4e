"""Apply an expert placement to live params and optimizer state.

A migration is a permutation of the expert dim: physical slot ``p`` holds
logical expert ``plan.physical_to_logical[p]``.  The router is not
rewritten: the plan's ``logical_to_physical`` table remaps the gate's
expert ids (``core/fmoe``), so routing, and checkpoints in logical order
(:func:`to_logical`), are unchanged.

Works on any tree of dicts, lists and tuples whose expert leaves sit under
an ``experts`` key: a layer's params, the model's (``params["layers"]`` is
a list of per-layer dicts, so a leaf's layer is its index there), and the
AdamW state, whose moments mirror the params.  A per-layer plan permutes
layer ``l``'s expert leaves with its row ``l``; a shared plan every layer
alike.

Memory: the trees are permuted in place, one leaf at a time, through one
scratch leaf (a 10-layer full-width fastmoe-gpt training state fills most
of the card); no second tree is built.  The given tree is returned, its
containers updated.

Across ranks (``mesh``): a rank holds only its own expert slots, its owned
block ``p2l[m * E_ns / mp : (m + 1) * E_ns / mp]`` (``m`` its index over
the expert axes, ``E_ns = E - num_shadow``) and then the shadowed experts
``p2l[E_ns:]``, replicated.  A leaf is all-gathered over the expert axes
into its whole physical order, and the rank takes its rows of the new
layout from it (``core.comm.all_gather_rows``); where the rank's row count
changes (another shadow count) the leaf is replaced in its container.
"""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from repro_torch.core import comm
from repro_torch.core.sync import layer_of
from repro_torch.placement.plan import (ExpertPlacement, PerLayerPlacement,
                                        identity_placement)

Plan = Union[ExpertPlacement, PerLayerPlacement]


def _tables(plan: Plan, to_physical: bool) -> np.ndarray:
    """Index table(s) of a plan: (E,) for shared, (L, E) for per-layer."""
    if isinstance(plan, PerLayerPlacement):
        return (plan.physical_to_logical if to_physical
                else plan.logical_to_physical)
    if to_physical:
        return np.asarray(plan.physical_to_logical, np.int32)
    return plan.logical_to_physical


def is_expert_leaf(path: str) -> bool:
    return "experts" in path.split("/")


def _row(table: np.ndarray, layer, path: str) -> np.ndarray:
    if table.ndim == 1:
        return table
    if layer is None or layer >= table.shape[0]:
        raise ValueError(f"a per-layer plan ({table.shape[0]} layers) needs "
                         f"the leaf's layer; {path!r} has none in range")
    return table[layer]


def _walk(tree, fn, path: str = ""):
    """Call ``fn(path, leaf)`` on every tensor leaf, replacing the leaf in
    its dict or list by the result (a tuple's leaves must come back as
    they are)."""
    if isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return
    for k, v in items:
        p = f"{path}/{k}" if path else str(k)
        if isinstance(v, torch.Tensor):
            new = fn(p, v)
            if new is not v:
                if isinstance(tree, tuple):
                    raise TypeError(f"cannot replace the leaf {p!r} of a "
                                    f"tuple")
                tree[k] = new
        else:
            _walk(v, fn, p)


def _geometry(plan: Plan):
    g = plan.geometry if isinstance(plan, PerLayerPlacement) else plan
    return g.num_experts, g.num_ranks, g.num_owned


def migrate(tree: Any, old: Plan, new: Plan, *, mesh=None) -> Any:
    """Re-lay ``tree`` from ``old``'s physical order into ``new``'s, in
    place: ``new_phys[p] = old_phys[old.l2p[new.p2l[p]]]``.  Shared and
    per-layer plans mix freely (a shared plan applies to every layer).
    ``mesh`` (a ``launch.mesh.Mesh``): the tree is this rank's shard and
    the plans' ``num_ranks`` its expert parallelism."""
    E, ranks, own_old = _geometry(old)
    E_new, ranks_new, own_new = _geometry(new)
    if E != E_new:
        raise ValueError((E, E_new))
    mp = 1 if mesh is None else mesh.axes_size(mesh.expert_axes)
    if mp > 1 and not ranks == ranks_new == mp:
        raise ValueError(f"plans for {ranks} and {ranks_new} ranks on a "
                         f"mesh of expert parallelism {mp}")
    l2p_old = _tables(old, to_physical=False).astype(np.int64)
    p2l_new = _tables(new, to_physical=True).astype(np.int64)
    if mp > 1:
        group = mesh.group(mesh.expert_axes)
        m = mesh.axis_index(mesh.expert_axes)
        # the new layout's physical slots this rank holds
        en = own_new // mp
        held = np.concatenate([np.arange(m * en, (m + 1) * en),
                               np.arange(own_new, E)])
        eo = own_old // mp

    def leaf(path, x):
        if not is_expert_leaf(path):
            return x
        layer = layer_of(path)
        idx = _row(l2p_old, layer, path)[_row(p2l_new, layer, path)]
        with torch.no_grad():
            if mp == 1:
                if x.shape[0] != E:
                    raise ValueError(f"{path}: {x.shape[0]} expert rows, "
                                     f"the plans have {E}")
                if np.array_equal(idx, np.arange(E)):
                    return x
                scratch = x.index_select(0, torch.as_tensor(idx,
                                                            device=x.device))
                x.copy_(scratch)
                return x
            if x.shape[0] != eo + E - own_old:
                raise ValueError(f"{path}: {x.shape[0]} expert rows, the old "
                                 f"plan puts {eo + E - own_old} on a rank")
            full = torch.cat([comm.all_gather_rows(x[:eo], group),
                              x[eo:]])  # (E, ...) in old physical order
            rows = full.index_select(0, torch.as_tensor(idx[held],
                                                        device=x.device))
            del full
            if rows.shape == x.shape:
                x.copy_(rows)
                return x
            return rows.requires_grad_(x.requires_grad)

    _walk(tree, leaf)
    return tree


def to_logical(tree: Any, plan: Plan, *, mesh=None) -> Any:
    """Physical -> logical order (the checkpoint layout; on a mesh, the
    identity layout's contiguous expert blocks), in place."""
    E, ranks, _ = _geometry(plan)
    return migrate(tree, plan, identity_placement(E, ranks), mesh=mesh)


def from_logical(tree: Any, plan: Plan, *, mesh=None) -> Any:
    """Logical -> physical order (what the placed layer consumes), in
    place."""
    E, ranks, _ = _geometry(plan)
    return migrate(tree, identity_placement(E, ranks), plan, mesh=mesh)


def router_index_table(plan: Plan) -> np.ndarray:
    """The logical -> physical table(s) the gate's ids go through: (E,)
    for a shared plan, (L, E) for a per-layer plan."""
    return _tables(plan, to_physical=False)
