"""Top-k gate networks (paper §2.1, Algorithm 1) — the ``topk`` router.

The gate scores every expert for every token and selects the top-k in f32.
Ties break toward the lower expert index, as ``jax.lax.top_k`` does:
``torch.topk`` gives no such order, so selection is a stable descending sort.
Slot order decides capacity priority (``dispatch.make_capacity_plan``).

The other routers of the JAX package (noisy_topk, gumbel, expert_choice,
frozen) are not ported yet (ROADMAP.md) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import MoEConfig


class GateOutput(NamedTuple):
    """Routing decision for a flat batch of T tokens."""

    expert_ids: torch.Tensor  # (T, k) int64 — selected expert per slot
    combine_weights: torch.Tensor  # (T, k) float32 — mixing weight per slot
    probs: torch.Tensor  # (T, E) float32 — full router distribution
    logits: torch.Tensor  # (T, E) float32 (for z-loss)


def _not_ported(router: str) -> NotImplementedError:
    return NotImplementedError(
        f"router {router!r} is not ported to repro_torch yet; only 'topk' "
        f"is (see ROADMAP.md, routing zoo)")


def gate_init(gen: torch.Generator, d_model: int, num_experts: int, *, device,
              dtype=torch.float32) -> dict:
    w = torch.randn(d_model, num_experts, generator=gen, device=device)
    return {"w": (w * d_model ** -0.5).to(dtype)}


def router_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *, device,
                dtype=torch.float32) -> dict:
    """Router params for ``cfg.router`` (``topk`` only: a single ``w``)."""
    if cfg.router != "topk":
        raise _not_ported(cfg.router)
    return gate_init(gen, d_model, cfg.num_experts, device=device, dtype=dtype)


def topk_lower_index(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries per row; ties go to the
    lower index (a stable descending sort), matching ``jax.lax.top_k``."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gate_forward(params: dict, x: torch.Tensor, cfg: MoEConfig) -> GateOutput:
    """Score and select experts for flat tokens ``x`` of shape (T, d)."""
    router_dtype = getattr(torch, cfg.router_dtype)
    logits = x.to(router_dtype) @ params["w"].to(router_dtype)
    probs = torch.softmax(logits, dim=-1)

    k = cfg.top_k
    if cfg.gate_policy == "softmax_topk":
        weights, expert_ids = topk_lower_index(probs, k)
    elif cfg.gate_policy == "topk_softmax":
        top_logits, expert_ids = topk_lower_index(logits, k)
        weights = torch.softmax(top_logits, dim=-1)
    else:
        raise ValueError(f"unknown gate_policy {cfg.gate_policy!r}")

    if cfg.renormalize:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return GateOutput(expert_ids, weights.to(router_dtype), probs, logits)


def route_tokens(params: dict, x: torch.Tensor, cfg: MoEConfig) -> GateOutput:
    """Dispatch to the token-choice router selected by ``cfg.router``."""
    if cfg.router == "topk":
        return gate_forward(params, x, cfg)
    if cfg.router in ("noisy_topk", "gumbel", "frozen", "expert_choice"):
        raise _not_ported(cfg.router)
    raise ValueError(f"unknown router {cfg.router!r}")
