"""AdamW with decoupled weight decay and global-norm clipping, written out
as the JAX package's ``repro/optim/adamw.py`` has it (not
``torch.optim.AdamW``): every leaf decays, the update math runs in f32, and
the moments may be kept in bf16 (``moment_dtype``).

Params, grads and moments are trees (dicts and lists) of tensors.  Where
JAX returns new arrays, the port updates params and moments in place (the
f32 masters and moments of a full-width model fill most of the card) and
returns the same trees.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.sync import sharded_sq_norms


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


class AdamWState(NamedTuple):
    step: int
    mu: dict
    nu: dict


def global_norm(tree, dist=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32, an expert leaf's
    summed expert by expert in logical order (``core.sync.
    sharded_sq_norms``).  With ``dist`` (a ``core.fmoe.DistConfig``) over a
    mesh, the norm of the whole gradient: each rank holds only its shard of
    an expert leaf, so its experts' squares are gathered from the ranks
    that hold them, and every rank clips alike; under a placement, its
    tables put the experts in logical order, so a placed step clips as the
    unplaced one does."""
    return torch.sqrt(sum(sharded_sq_norms(tree, dist)))


class AdamW(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves the optimizer's memory

    def init(self, params) -> AdamWState:
        dt = getattr(torch, self.moment_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, *,
               lr_scale: float = 1.0, dist=None):
        """Returns (params, state, grad_norm); params and the moments are
        updated in place, and ``grads`` is used as scratch.  ``dist``: the
        grads are a rank's synced shards (``global_norm``)."""
        gnorm = global_norm(grads, dist)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
        step = state.step + 1
        f32 = torch.float32
        b1c = 1 - torch.tensor(self.b1, dtype=f32) ** step
        b2c = 1 - torch.tensor(self.b2, dtype=f32) ** step
        lr = torch.tensor(self.lr, dtype=f32) * lr_scale
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                              tree_leaves(state.nu), tree_leaves(params)):
            g = g.float()
            if scale is not None:
                g.mul_(scale)
            mf = m if m.dtype == f32 else m.float()
            vf = v if v.dtype == f32 else v.float()
            mf.mul_(self.b1).add_((1 - self.b1) * g)
            vf.mul_(self.b2).add_((1 - self.b2) * g * g)
            denom = (vf / b2c.to(vf.device)).sqrt_().add_(self.eps)
            delta = (mf / b1c.to(mf.device)).div_(denom)
            del denom
            pf = p.float()
            delta.add_(self.weight_decay * pf)
            p.copy_(pf - lr.to(p.device) * delta)
            if mf is not m:
                m.copy_(mf)
            if vf is not v:
                v.copy_(vf)
        return params, AdamWState(step, state.mu, state.nu), gnorm
