"""Move model params between the JAX package and the port through numpy.

The JAX tree is taken as numpy arrays (``jax.tree.map(np.asarray, params)``
on the JAX side); this module imports no JAX.  Layouts stay as JAX has them:
experts ``wi`` (E, d, h) and ``wo`` (E, h, d), linear ``w`` (d_in, d_out).
``params["layers"]`` is stacked on a leading L dim in JAX and a list of
per-layer dicts here.  Every parity test builds its torch params through
:func:`from_jax`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no torch counterpart
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax(params_np: dict, cfg: ModelConfig, *, device="cuda") -> dict:
    """JAX param tree (numpy leaves, stacked layers) -> port params, in the
    dtypes JAX has them (f32 masters; ``repro_torch.models.lm`` casts the
    layers to ``cfg.dtype`` at use)."""
    dev = resolve(device)
    out = {k: _map(lambda a: _to_torch(a, dev), v)
           for k, v in params_np.items() if k != "layers"}
    out["layers"] = [_map(lambda a, i=i: _to_torch(np.asarray(a)[i], dev),
                          params_np["layers"]) for i in range(cfg.num_layers)]
    return out


def to_jax(params: dict) -> dict:
    """Port params -> JAX tree of numpy arrays with stacked layers.  bf16
    tensors come back as float32 arrays (numpy has no bf16)."""
    def to_np(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out = {k: _map(to_np, v) for k, v in params.items() if k != "layers"}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    out["layers"] = stack([_map(to_np, p) for p in params["layers"]])
    return out
