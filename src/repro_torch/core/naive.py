"""Naive MoE baselines the paper compares against (§5.2, Fig 5), over the
port's gate.

The Rau (2019) baseline computes experts without batching tokens per
expert.  Two plain PyTorch renditions of that inefficiency, numerically
the counterparts of the reference's ``repro/core/naive.py`` (and of
:func:`repro_torch.core.fmoe.fmoe_apply` without drops):

* :func:`moe_loop_masked` — a Python loop over experts; every expert
  processes ALL tokens densely, its output masked by the gate: E full-batch
  products.
* :func:`moe_per_sample` — each token gathers its k experts' weights and
  runs matrix-vector products (the degenerate GeMM of the paper's Fig 3):
  the gather holds T * k copies of an expert's weights at once.

No kernel of the port runs in them: they are the yardsticks the kernels
are measured against.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.fmoe import _act
from repro_torch.core.gate import gate_forward


def _ffn(w: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The expert FFN on x (..., d) with weights w (one expert's, or
    per-token stacks whose leading dims match x's); batched products."""
    def mm(a, b):
        return a @ b if b.dim() == 2 else (a[..., None, :] @ b)[..., 0, :]
    if act == "swiglu":
        h = torch.nn.functional.silu(mm(x, w["wi_gate"])) * mm(x, w["wi_up"])
    else:
        h = _act(mm(x, w["wi"]), act)
    return mm(h, w["wo"])


def moe_loop_masked(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                    act: str = "swiglu") -> torch.Tensor:
    """Every expert computes every token; the gate's mask zeroes the rest."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    g = gate_forward(params["router"], xf, cfg)
    y = torch.zeros_like(xf)
    for e in range(cfg.num_experts):
        out = _ffn({k: v[e] for k, v in params["experts"].items()}, xf, act)
        w = torch.where(g.expert_ids == e, g.combine_weights, 0.0).sum(-1)
        y = y + out * w[:, None].to(out.dtype)
    return y.reshape(shape)


def moe_per_sample(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                   act: str = "swiglu") -> torch.Tensor:
    """Per-token expert gather + matrix-vector products: the batch-size-1
    regime of Fig 3."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    g = gate_forward(params["router"], xf, cfg)
    T, k = g.expert_ids.shape
    w = {name: v[g.expert_ids] for name, v in params["experts"].items()}
    tok = xf[:, None, :].expand(T, k, shape[-1])
    out = _ffn(w, tok, act)  # (T, k, d)
    y = (g.combine_weights.to(out.dtype)[..., None] * out).sum(1)
    return y.reshape(shape)
