"""Move model params between the JAX package and the port through numpy.

The JAX tree is taken as numpy arrays (``jax.tree.map(np.asarray, params)``
on the JAX side); this module imports no JAX.  Layouts stay as JAX has them:
experts ``wi`` (E, d, h) and ``wo`` (E, h, d), linear ``w`` (d_in, d_out).
``params["layers"]`` (and whisper's ``params["enc_layers"]``) is stacked
on a leading L dim in JAX and a list of per-layer dicts here.  Every
parity test builds its torch params through :func:`from_jax`.

With a ``layout`` (``launch.sharding.Layout``: the train layout, which
training on a mesh holds, or serving's, ``launch.sharding.serve_layout``)
every leaf is cut to a rank's block by its spec, as the reference's
``tree_shardings`` lays it out; ``models.lm.init_params(layout=...)``
draws the same shards without the whole.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.optim.adamw import tree_leaves


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no torch counterpart
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def shard_params(params: dict, layout, rank: int | None = None) -> dict:
    """The rank's shard of whole params (``rank`` defaults to the layout's
    mesh's own): every leaf cut by its spec under ``layout``
    (``launch.sharding.shard_tree``).  A cut is a copy, so the whole can be
    freed."""
    from repro_torch.launch.sharding import shard_tree
    return shard_tree(params, layout, rank)


STACKED = ("layers", "enc_layers")  # stacked on L there, lists here


def _unstack(tree, dev) -> list:
    n = len(tree_leaves(tree)[0])
    return [_map(lambda a, i=i: _to_torch(np.asarray(a)[i], dev), tree)
            for i in range(n)]


def from_jax(params_np: dict, cfg: ModelConfig, *, device="cuda",
             layout=None, rank: int | None = None) -> dict:
    """JAX param tree (numpy leaves, stacked layers) -> port params, in the
    dtypes JAX has them (f32 masters; ``repro_torch.models.lm`` casts the
    layers to ``cfg.dtype`` at use).  With ``layout``, the shard of
    ``rank`` (default: the layout's mesh's own) by :func:`shard_params`."""
    dev = resolve(device)
    out = {k: (_unstack(v, dev) if k in STACKED
               else _map(lambda a: _to_torch(a, dev), v))
           for k, v in params_np.items()}
    return out if layout is None else shard_params(out, layout, rank)


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
