"""Mamba selective SSM head (Hymba's parallel attention + mamba layers).

h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * u_t ;  y_t = C_t . h_t + D * u_t
with input-dependent (selective) B, C and dt.  The JAX package runs a step
in a ``lax.scan``; here the projections, the causal depthwise conv, the
softplus and the discretised ``exp(dt A)`` and ``dt B u`` run over all
positions at once, and only the f32 state h (B, d_in, N) and its read-out
loop over time (:func:`ssm_scan`).  The cast points are the reference's:
the activations stay in the input's dtype, the discretisation and the
state are f32, and the read-out is cast back before the skip term.
Decode is the same function at S = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import linear_init
from repro_torch.models.rwkv6 import mm


class MambaState(NamedTuple):
    h: torch.Tensor  # (B, d_in, N) f32 ssm state
    conv: torch.Tensor  # (B, conv_width - 1, d_in) causal-conv tail


def dt_rank_of(d_model: int, cfg: SSMConfig) -> int:
    return cfg.dt_rank or max(1, (d_model + 15) // 16)


def mamba_init(gen: torch.Generator, d_model: int, cfg: SSMConfig, *, device,
               dtype=torch.float32) -> dict:
    """The reference's leaves, shapes and scales; ``A_log`` and ``D`` in
    f32 (the model casts them to its dtype at use, as every float leaf)."""
    d_in = cfg.expand * d_model
    dt_rank = dt_rank_of(d_model, cfg)
    kw = dict(device=device, dtype=dtype)
    A = torch.arange(1, cfg.state_size + 1, dtype=torch.float32,
                     device=device).repeat(d_in, 1)
    conv_w = torch.randn(cfg.conv_width, d_in, generator=gen, device=device)
    return {
        "in_proj": linear_init(gen, d_model, 2 * d_in, **kw),
        "conv_w": (conv_w * cfg.conv_width ** -0.5).to(dtype),
        "conv_b": torch.zeros(d_in, **kw),
        "x_proj": linear_init(gen, d_in, dt_rank + 2 * cfg.state_size, **kw),
        "dt_proj": linear_init(gen, dt_rank, d_in, bias=True, **kw),
        "A_log": torch.log(A),
        "D": torch.ones(d_in, dtype=torch.float32, device=device),
        "out_proj": linear_init(gen, d_in, d_model, **kw),
    }


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
             h0: torch.Tensor):
    """The recurrence, f32: dA, dBx (B, S, d_in, N), C (B, S, N), h0 (B,
    d_in, N) -> (y (B, S, d_in) with y_t = h_t C_t, h_S), where h_t = dA_t
    h_{t-1} + dBx_t."""
    h, ys = h0, []
    for t in range(dA.shape[1]):
        h = torch.addcmul(dBx[:, t], dA[:, t], h)
        ys.append((h @ C[:, t, :, None])[..., 0])
    return torch.stack(ys, dim=1), h


def mamba_apply(p: dict, x: torch.Tensor, state: MambaState, cfg: SSMConfig):
    """x (B, S, d_model) -> (y, new state)."""
    B, S, d_model = x.shape
    dt_rank = dt_rank_of(d_model, cfg)
    N = cfg.state_size

    xi, z = mm(x, p["in_proj"]["w"]).chunk(2, dim=-1)  # (B, S, d_in) each
    # causal depthwise conv over time, seeded by the cached tail
    pad = torch.cat([state.conv.to(xi.dtype), xi], dim=1)
    cw = cfg.conv_width
    xc = sum(pad[:, i:i + S] * p["conv_w"][i] for i in range(cw)) + p["conv_b"]
    xc = F.silu(xc)

    dt_low, Bc, Cc = mm(xc, p["x_proj"]["w"]).split([dt_rank, N, N], dim=-1)
    dt = F.softplus(mm(dt_low, p["dt_proj"]["w"]) + p["dt_proj"]["b"])
    A = -torch.exp(p["A_log"])  # (d_in, N)
    dA = torch.exp(dt[..., None].float() * A)  # (B, S, d_in, N)
    dBx = (dt * xc)[..., None].float() * Bc[:, :, None, :]
    ys, h_fin = ssm_scan(dA, dBx, Cc.float(), state.h)
    y = ys.to(x.dtype) + xc * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = mm(y, p["out_proj"]["w"])
    new_conv = pad[:, pad.shape[1] - (cw - 1):] if cw > 1 else state.conv
    return out, MambaState(h_fin, new_conv.to(state.conv.dtype, copy=True))


def mamba_init_state(batch: int, d_model: int, cfg: SSMConfig,
                     dtype=torch.float32, *, device) -> MambaState:
    d_in = cfg.expand * d_model
    return MambaState(
        torch.zeros(batch, d_in, cfg.state_size, dtype=torch.float32,
                    device=device),
        torch.zeros(batch, cfg.conv_width - 1, d_in, dtype=dtype,
                    device=device))
