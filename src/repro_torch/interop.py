"""Move model params between the JAX package and the port through numpy.

The JAX tree is taken as numpy arrays (``jax.tree.map(np.asarray, params)``
on the JAX side); this module imports no JAX.  Layouts stay as JAX has them:
experts ``wi`` (E, d, h) and ``wo`` (E, h, d), linear ``w`` (d_in, d_out).
``params["layers"]`` (and whisper's ``params["enc_layers"]``) is stacked
on a leading L dim in JAX and a list of per-layer dicts here.  Every
parity test builds its torch params through :func:`from_jax`.

With a ``layout`` (``launch.sharding.Layout``: the train layout, which
training on a mesh holds) every leaf is cut by its spec, as the
reference's ``tree_shardings(..., "train")`` lays it out.  With a mesh
alone a rank keeps serving's expert-parallel shard: the routed expert
stacks sliced on their expert dim, rank ``m`` of the model axis holding
experts ``[m * E_local, (m + 1) * E_local)`` (``P("model", None, None)``
in the reference; on a node mesh index ``n * model + m`` over ``("node",
"model")``, node-major), everything else whole; :func:`shard_params` with
``expert_tp`` cuts their hidden dim over the data axis too (``wi*`` dim
2, ``wo`` dim 1: the reference's ``P("model", None, "data")`` and
``P("model", "data", None)``).  ``models.lm.init_params(mesh=...)``
draws the same shards without the whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sync import is_expert_path, tagged_leaves
from repro_torch.device import resolve
from repro_torch.optim.adamw import tree_leaves, tree_map


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no torch counterpart
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def shard_params(params: dict, mesh, rank: int | None = None, *,
                 expert_tp: bool = False, layout=None) -> dict:
    """The rank's shard of whole params (``rank`` defaults to the mesh's
    own): each routed expert stack sliced on dim 0 to the rank's experts,
    and with ``expert_tp`` on its hidden dim to the rank's hidden units
    (``launch.mesh.Mesh.expert_shard``); every other leaf as it is.  A
    slice is a copy, so the whole stack can be freed.  ``layout``: every
    leaf cut by its spec (``launch.sharding.shard_tree``)."""
    if layout is not None:
        from repro_torch.launch.sharding import shard_tree
        return shard_tree(params, layout, rank)
    if (mesh.axes_size(mesh.expert_axes) == 1
            and not (expert_tp and mesh.shape["data"] > 1)):
        return params

    def shard(path, t):
        if not is_expert_path(path):
            return t
        dim = 1 if path.split("/")[-1] == "wo" else 2
        experts, hidden = mesh.expert_shard(t.shape[0], t.shape[dim],
                                            tp=expert_tp, rank=rank)
        return t[experts].narrow(dim, hidden.start,
                                 hidden.stop - hidden.start).clone()

    shards = iter([shard(path, t) for path, t in tagged_leaves(params)])
    return tree_map(lambda _: next(shards), params)


STACKED = ("layers", "enc_layers")  # stacked on L there, lists here


def _unstack(tree, dev) -> list:
    n = len(tree_leaves(tree)[0])
    return [_map(lambda a, i=i: _to_torch(np.asarray(a)[i], dev), tree)
            for i in range(n)]


def from_jax(params_np: dict, cfg: ModelConfig, *, device="cuda", mesh=None,
             rank: int | None = None, layout=None) -> dict:
    """JAX param tree (numpy leaves, stacked layers) -> port params, in the
    dtypes JAX has them (f32 masters; ``repro_torch.models.lm`` casts the
    layers to ``cfg.dtype`` at use).  With ``mesh``, the shard of ``rank``
    (default: the mesh's own; :func:`shard_params` and ``layout`` as
    there; a layout brings its mesh)."""
    dev = resolve(device)
    out = {k: (_unstack(v, dev) if k in STACKED
               else _map(lambda a: _to_torch(a, dev), v))
           for k, v in params_np.items()}
    if layout is not None:
        return shard_params(out, layout.mesh, rank, layout=layout)
    return out if mesh is None else shard_params(out, mesh, rank)


def to_jax(params: dict) -> dict:
    """Port params -> JAX tree of numpy arrays with stacked layers.  bf16
    tensors come back as float32 arrays (numpy has no bf16)."""
    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    return {k: (stack([_map(to_np, p) for p in v]) if k in STACKED
                else _map(to_np, v)) for k, v in params.items()}
