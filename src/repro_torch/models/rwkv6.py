"""RWKV6 "Finch" time-mix + channel-mix (arXiv:2404.05892).

Attention-free linear recurrence with *data-dependent* per-channel decay:
w_t = exp(-exp(w0 + lora(x_t))), state S_t = diag(w_t) S_{t-1} + k_t v_t^T
per 64-wide head, read out as y_t = r_t (S_{t-1} + diag(u) k_t v_t^T).

The JAX package computes everything of a step inside its ``lax.scan``.
Here the token shift (``_ddlerp``), the five projections and the decay,
which read no state, run over all (B, S) positions at once, and so does
the bonus term ``(r_t . u k_t) v_t``; only the f32 state update and its
read-out ``r_t S_{t-1}`` loop over time (:func:`wkv_scan`).  The cast
points are the reference's: r, k, v and ``w_log`` are made in the input's
dtype and cast to f32; the group norm runs in f32, so the time mix returns
f32 (as JAX promotes an f32 activation against bf16 weights), and so does
the channel mix once its input is f32.  Decode is the same function at
S = 1.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear_init

TSHIFT_RANK = 32


class RWKVState(NamedTuple):
    S: torch.Tensor  # (B, n_heads, dk, dv) f32 wkv state
    sx_tm: torch.Tensor  # (B, d) previous token (time-mix shift)
    sx_cm: torch.Tensor  # (B, d) previous token (channel-mix shift)


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, *, device,
              dtype=torch.float32) -> dict:
    """The reference's leaves, shapes and scales, drawn from ``gen``."""
    d, r = cfg.d_model, cfg.ssm.lora_rank
    kw = dict(device=device, dtype=dtype)

    def n01(shape, s):
        return (torch.randn(*shape, generator=gen, device=device) * s).to(dtype)

    def full(shape, v):
        return torch.full(shape, v, **kw)

    return {
        # ddlerp token-shift mixers
        "mu_x": full((d,), 0.0),
        "mu": full((5, d), 0.0),
        "ts_w1": n01((d, 5 * TSHIFT_RANK), d ** -0.5),
        "ts_w2": n01((5, TSHIFT_RANK, d), TSHIFT_RANK ** -0.5),
        # projections
        "wr": linear_init(gen, d, d, **kw),
        "wk": linear_init(gen, d, d, **kw),
        "wv": linear_init(gen, d, d, **kw),
        "wg": linear_init(gen, d, d, **kw),
        "wo": linear_init(gen, d, d, **kw),
        # data-dependent decay (Finch)
        "w0": full((d,), -6.0),
        "decay_w1": n01((d, r), d ** -0.5),
        "decay_w2": n01((r, d), r ** -0.5),
        "u": n01((d,), 0.5),  # per-channel bonus ("first")
        "ln_x_scale": full((d,), 1.0),  # per-head group norm
        # channel mix
        "mu_ck": full((d,), 0.0),
        "mu_cr": full((d,), 0.0),
        "cm_k": linear_init(gen, d, cfg.d_ff, **kw),
        "cm_v": linear_init(gen, cfg.d_ff, d, **kw),
        "cm_r": linear_init(gen, d, d, **kw),
    }


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two, as JAX computes a matmul of
    an f32 activation against bf16 weights."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def shifted(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) shifted one token later, ``prev`` (B, d) in front."""
    dt = torch.promote_types(x.dtype, prev.dtype)
    return torch.cat([prev[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def _ddlerp(p: dict, x: torch.Tensor, sx: torch.Tensor):
    """Data-dependent lerp between current and shifted token (5 targets)."""
    dx = sx - x
    xm = x + dx * p["mu_x"]
    low = torch.tanh(mm(xm, p["ts_w1"])).reshape(*x.shape[:-1], 5, TSHIFT_RANK)
    dyn = torch.einsum("...ct,ctd->...cd", low, p["ts_w2"])  # (..., 5, d)
    mix = p["mu"] + dyn
    return tuple(x + dx * mix[..., i, :] for i in range(5))


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, S0: torch.Tensor):
    """The recurrence, f32: r, k, v, w (B, S, n, hd), S0 (B, n, hd, hd) ->
    (r_t S_{t-1} for every t as (B, S, n, hd), S_S), with S_t = diag(w_t)
    S_{t-1} + k_t v_t^T."""
    state, ys = S0, []
    for t in range(r.shape[1]):
        ys.append((r[:, t, :, None, :] @ state)[:, :, 0])
        state = torch.addcmul(k[:, t, :, :, None] * v[:, t, :, None, :],
                              w[:, t, :, :, None], state)
    return torch.stack(ys, dim=1), state


def _groupnorm(y: torch.Tensor, scale: torch.Tensor, n: int,
               hd: int) -> torch.Tensor:
    shp = y.shape
    yh = y.reshape(*shp[:-1], n, hd).float()
    yh = yh * torch.rsqrt((yh * yh).mean(-1, keepdim=True) + 1e-5)
    return (yh.reshape(shp) * scale).to(y.dtype)


def time_mix(p: dict, x: torch.Tensor, state: RWKVState, cfg: ModelConfig):
    """Sequence time-mix: x (B, S, d) -> (y (B, S, d) f32, new state)."""
    B, S, d = x.shape
    hd = cfg.ssm.head_dim
    n = d // hd
    xr, xk, xv, xw, xg = _ddlerp(p, x, shifted(x, state.sx_tm))
    shp = (B, S, n, hd)
    r = mm(xr, p["wr"]["w"]).reshape(shp).float()
    k = mm(xk, p["wk"]["w"]).reshape(shp).float()
    v = mm(xv, p["wv"]["w"]).reshape(shp).float()
    g = mm(xg, p["wg"]["w"])
    w_log = p["w0"] + mm(torch.tanh(mm(xw, p["decay_w1"])), p["decay_w2"])
    w = torch.exp(-torch.exp(w_log.float())).reshape(shp)  # decay in (0, 1)
    u = p["u"].reshape(n, hd).float()
    y, S_fin = wkv_scan(r, k, v, w, state.S)
    y = y + (r * u * k).sum(-1, keepdim=True) * v  # the bonus term
    yo = _groupnorm(y.reshape(B, S, d), p["ln_x_scale"], n, hd)
    y = mm(yo * F.silu(g), p["wo"]["w"])
    return y, state._replace(S=S_fin, sx_tm=x[:, -1].clone())


def channel_mix(p: dict, x: torch.Tensor, state: RWKVState):
    """x (B, S, d) -> (y, state with the channel-mix shift updated)."""
    sx = shifted(x, state.sx_cm)
    dx = sx - x
    xk = x + dx * p["mu_ck"]
    xr = x + dx * p["mu_cr"]
    k = torch.square(torch.relu(mm(xk, p["cm_k"]["w"])))
    y = torch.sigmoid(mm(xr, p["cm_r"]["w"])) * mm(k, p["cm_v"]["w"])
    return y, state._replace(sx_cm=x[:, -1].clone())


def rwkv_init_state(batch: int, cfg: ModelConfig, dtype=torch.float32, *,
                    device) -> RWKVState:
    d = cfg.d_model
    hd = cfg.ssm.head_dim
    n = d // hd
    return RWKVState(
        torch.zeros(batch, n, hd, hd, dtype=torch.float32, device=device),
        torch.zeros(batch, d, dtype=dtype, device=device),
        torch.zeros(batch, d, dtype=dtype, device=device))
