"""Gate networks (paper §2.1, Algorithm 1, and §3.1: the gate is
user-swappable) — the routing zoo of the JAX package:

* ``topk`` — score every expert, select the top-k (``gate_forward``);
* ``noisy_topk`` — Shazeer et al. 2017: top-k over x.W + eps *
  softplus(x.W_noise) (``noisy_topk_forward``);
* ``gumbel`` — selection on Gumbel-perturbed logits, weights from the clean
  probabilities (``gumbel_topk_forward``);
* ``frozen`` — StableMoE stage 2: route through the distilled ``w_frozen``,
  detached (``frozen_forward``);
* ``expert_choice`` — each expert picks its top-C tokens
  (``expert_choice_forward``; the MoE paths branch on it before
  ``route_tokens``, since it emits an (E, C) token grid).

Selection is in f32 and ties break toward the lower index, as
``jax.lax.top_k`` does: ``torch.topk`` gives no such order, so selection is
a stable descending sort.  Slot order decides capacity priority
(``dispatch.make_capacity_plan``).

Exploration noise: torch cannot reproduce ``jax.random``'s bits, so each
noisy forward takes its drawn tensor as an argument (``noise``: eps ~ N(0,
1) for the jitter and noisy_topk, u ~ U(tiny, 1) for gumbel) and the
arithmetic after the draw is the reference's; ``route_tokens`` draws it
with :func:`gate_noise` from an integer seed, so a recompute under remat
draws the same.  No noise routes every variant deterministically.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig

ROUTERS = ("topk", "noisy_topk", "gumbel", "expert_choice", "frozen")
EXPLORING = ("noisy_topk", "gumbel")  # routers that take train-time noise
DISTILLING = ("noisy_topk", "gumbel", "frozen")  # routers carrying w_frozen


class GateOutput(NamedTuple):
    """Routing decision for a flat batch of T tokens."""

    expert_ids: torch.Tensor  # (T, k) int64 — selected expert per slot
    combine_weights: torch.Tensor  # (T, k) float32 — mixing weight per slot
    probs: torch.Tensor  # (T, E) float32 — full router distribution
    logits: torch.Tensor  # (T, E) float32 (for z-loss)


def _randn(gen: torch.Generator, d: int, e: int, device) -> torch.Tensor:
    return torch.randn(d, e, generator=gen, device=device) * d ** -0.5


def gate_init(gen: torch.Generator, d_model: int, num_experts: int, *, device,
              dtype=torch.float32) -> dict:
    return {"w": _randn(gen, d_model, num_experts, device).to(dtype)}


def router_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *, device,
                dtype=torch.float32) -> dict:
    """Router params for ``cfg.router``.

    Every variant carries ``w`` (the live gate).  ``noisy_topk`` adds
    ``w_noise`` (scale 0.1 of ``w``'s); ``noisy_topk``, ``gumbel`` and
    ``frozen`` add ``w_frozen``, the StableMoE router the live gate distills
    into, so that switching to ``frozen`` mid-run is a config change.  The
    extra leaves are drawn after ``w`` from the same generator: ``topk`` and
    ``expert_choice`` draw exactly what they drew before the zoo."""
    if cfg.router not in ROUTERS:
        raise ValueError(f"unknown router {cfg.router!r}")
    E = cfg.num_experts
    p = gate_init(gen, d_model, E, device=device)
    if cfg.router == "noisy_topk":
        p["w_noise"] = _randn(gen, d_model, E, device) * 0.1
    if cfg.router in DISTILLING:
        p["w_frozen"] = _randn(gen, d_model, E, device)
    return {k: v.to(dtype) for k, v in p.items()}


def topk_lower_index(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries per row; ties go to the
    lower index (a stable descending sort), matching ``jax.lax.top_k``."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def gate_noise(kind: str, shape, seed: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """The exploration draw from an integer seed on a fresh generator:
    ``"normal"`` eps ~ N(0, 1), ``"uniform"`` u ~ U(tiny, 1) (the
    reference's ``minval=finfo.tiny``)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if kind == "normal":
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if kind == "uniform":
        u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
        return u.clamp_min(torch.finfo(dtype).tiny)
    raise ValueError(f"unknown noise kind {kind!r}")


def noise_kind(cfg: MoEConfig) -> Optional[str]:
    """The draw ``cfg.router`` takes at train time (None: no noise)."""
    if cfg.router == "noisy_topk":
        return "normal"
    if cfg.router == "gumbel" and cfg.router_temperature > 0:
        return "uniform"
    return None


def _softmax_topk(logits: torch.Tensor, k: int):
    top_logits, expert_ids = topk_lower_index(logits, k)
    return torch.softmax(top_logits, dim=-1), expert_ids


def gate_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                 noise: Optional[torch.Tensor] = None) -> GateOutput:
    """Score and select experts for flat tokens ``x`` of shape (T, d).
    ``noise`` (T, E), eps ~ N(0, 1): the optional exploration jitter, 0.01
    eps added to the logits."""
    router_dtype = getattr(torch, cfg.router_dtype)
    logits = x.to(router_dtype) @ params["w"].to(router_dtype)
    if noise is not None:
        logits = logits + noise.to(router_dtype) * 0.01
    probs = torch.softmax(logits, dim=-1)

    k = cfg.top_k
    if cfg.gate_policy == "softmax_topk":
        weights, expert_ids = topk_lower_index(probs, k)
    elif cfg.gate_policy == "topk_softmax":
        weights, expert_ids = _softmax_topk(logits, k)
    else:
        raise ValueError(f"unknown gate_policy {cfg.gate_policy!r}")

    if cfg.renormalize:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return GateOutput(expert_ids, weights.to(router_dtype), probs, logits)


def noisy_topk_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                       noise: Optional[torch.Tensor] = None) -> GateOutput:
    """H(x) = x.W + eps * softplus(x.W_noise), top-k over H, weights the
    softmax of the selected H.  ``noise`` (T, E) is eps; None routes on the
    clean logits."""
    xf = x.float()
    logits = xf @ params["w"].float()
    if noise is not None:
        scale = F.softplus(xf @ params["w_noise"].float())
        logits = logits + noise.float() * scale
    probs = torch.softmax(logits, dim=-1)
    weights, expert_ids = _softmax_topk(logits, cfg.top_k)
    return GateOutput(expert_ids, weights, probs, logits)


def gumbel_topk_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                        noise: Optional[torch.Tensor] = None) -> GateOutput:
    """Selection on logits + temperature * Gumbel(0, 1); the weights are the
    clean softmax probabilities at the selected ids, renormalized: the noise
    explores the assignment, not the mixture.  ``noise`` (T, E) is u ~
    U(tiny, 1), the Gumbel draw -log(-log u); None, or temperature 0, is the
    deterministic softmax top-k."""
    router_dtype = getattr(torch, cfg.router_dtype)
    logits = x.to(router_dtype) @ params["w"].to(router_dtype)
    probs = torch.softmax(logits, dim=-1)
    sel = logits
    if noise is not None and cfg.router_temperature > 0:
        u = noise.to(router_dtype)
        sel = logits + cfg.router_temperature * -torch.log(-torch.log(u))
    _, expert_ids = topk_lower_index(sel, cfg.top_k)
    weights = torch.gather(probs, -1, expert_ids)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return GateOutput(expert_ids, weights.to(router_dtype), probs, logits)


def frozen_forward(params: dict, x: torch.Tensor, cfg: MoEConfig) -> GateOutput:
    """StableMoE stage 2: score through ``w_frozen``, detached, so the
    routing never moves again; the weights (softmax over the selected k)
    still carry the gradient to the token representations."""
    logits = x.float() @ params["w_frozen"].detach().float()
    probs = torch.softmax(logits, dim=-1)
    weights, expert_ids = _softmax_topk(logits, cfg.top_k)
    return GateOutput(expert_ids, weights, probs, logits)


def route_tokens(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                 noise_seed: Optional[int] = None,
                 noise_rows: Optional[tuple] = None) -> GateOutput:
    """The token-choice router ``cfg.router`` on flat tokens (T, d).

    ``noise_seed`` arms exploration (noisy_topk, gumbel): the draw is
    ``gate_noise`` over (T_all, E) from that seed, and the rows
    ``noise_rows = (start, T_all)`` of it are this call's (default (0,
    T)), so that ranks holding blocks of one token set draw the noise a
    single rank would.  topk's jitter is ``gate_forward(noise=)``'s alone:
    as in the reference's train step, no path arms it.  Expert-choice is
    not a token-choice gate: the MoE paths branch on it before calling
    here."""
    noise = None
    kind = noise_kind(cfg)
    if noise_seed is not None and kind is not None:
        T, E = x.shape[0], cfg.num_experts
        start, total = noise_rows or (0, T)
        noise = gate_noise(kind, (total, E), noise_seed, x.device)[
            start:start + T]
    if cfg.router == "topk":
        return gate_forward(params, x, cfg, noise=noise)
    if cfg.router == "noisy_topk":
        return noisy_topk_forward(params, x, cfg, noise=noise)
    if cfg.router == "gumbel":
        return gumbel_topk_forward(params, x, cfg, noise=noise)
    if cfg.router == "frozen":
        return frozen_forward(params, x, cfg)
    raise ValueError(f"unknown router {cfg.router!r}")


def router_distill_loss(params: dict, x: torch.Tensor,
                        g: GateOutput) -> torch.Tensor:
    """StableMoE stage-1 distillation: the cross-entropy of the frozen
    router-to-be against the live gate's top-1 choice.  Inputs and targets
    are detached, so the gradient reaches only ``w_frozen``."""
    logits = x.detach().float() @ params["w_frozen"].float()
    target = g.expert_ids[:, 0].detach()
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, target[:, None]).mean()


def expert_choice_forward(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                          capacity: int):
    """Expert-choice routing (Zhou et al. 2022): each expert picks its
    top-``capacity`` tokens (ties to the lower token index, as
    ``jax.lax.top_k(probs.T, C)``), so every expert takes exactly C rows.
    Returns (token_idx (E, C) int64, weights (E, C) f32, probs (T, E),
    logits (T, E))."""
    logits = x.float() @ params["w"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, token_idx = topk_lower_index(probs.T, capacity)
    return token_idx, weights, probs, logits


def expert_choice_moe(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
                      act: str = "swiglu", capacity_factor: float = 2.0):
    """The single-worker expert-choice layer (gather by expert choice, the
    batched expert FFN, the weighted scatter-add back): the reference the
    dispatched expert-choice paths of ``core.fmoe`` are held to."""
    from repro_torch.core import dispatch as D
    from repro_torch.core.fmoe import expert_ffn

    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    T = xf.shape[0]
    C = D.ec_capacity(T, cfg.num_experts, capacity_factor)
    token_idx, weights, probs, _ = expert_choice_forward(
        params["router"], xf, cfg, capacity=C)
    bufs = D.gather_ec(xf, token_idx)  # (E, C, d)
    out = expert_ffn(params["experts"], bufs, act)
    y = D.combine_ec(out, token_idx, weights, T).to(xf.dtype)
    return y.reshape(shape), probs
