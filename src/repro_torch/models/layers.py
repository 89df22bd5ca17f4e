"""Shared layer primitives: norms, RoPE, embeddings, linear.

Numerics follow the JAX reference exactly: norms compute in f32 with
eps 1e-6 and the population variance, RoPE is the half-split form with
angles in f32, and the unembedding runs in f32.
"""
from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(d: int, kind: str, *, device, dtype=torch.float32) -> dict:
    p = {"scale": torch.ones(d, device=device, dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, device=device, dtype=dtype)
    return p


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = params["scale"].float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale + params["bias"].float()
    else:  # rmsnorm
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by per-position angles.

    positions: broadcastable to (..., seq) — absolute token positions.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings and linear layers
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device,
               dtype=torch.float32) -> dict:
    t = torch.randn(vocab, d, generator=gen, device=device) * 0.02
    return {"table": t.to(dtype)}


def embed_lookup(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["table"][tokens].to(dtype)


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32 (numerically-sensitive softmax upstream)."""
    return x.float() @ params["table"].float().T


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
                dtype=torch.float32, bias: bool = False) -> dict:
    w = torch.randn(d_in, d_out, generator=gen, device=device) * d_in ** -0.5
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device, dtype=dtype)
    return p


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b); w keeps the JAX layout (d_in, d_out)."""
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
