"""GQA attention: full-sequence (prefill) and one-token decode against a
ring-buffer KV cache.

In the JAX package's ``(B, S, H, d)`` layout.  ``blockwise_attention``
computes what the JAX blockwise online-softmax scan computes through the
flash-attention kernels (``kernels/flash_attention.py``: the (S, S) scores
never reach device memory on the card; on the CPU their plain version, one
masked softmax in f32).  Decode is plain PyTorch matmuls and a masked
softmax in f32 over the ring.  The cache keeps each
entry's absolute position beside it (-1 = empty, masked); RoPE is applied
at write time.  Decode writes the cache in place — the JAX version returns
a new cache; the port updates the tensors it was given and returns them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, linear, linear_init

_NEG = -1e30


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int, q_offset: int = 0,
                        causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(dk)) v over keys with 0 <= i - j < window
    (causal) or i - j < window (not causal).

    q: (B, Sq, H, dk); k: (B, Skv, KV, dk); v: (B, Skv, KV, dv); i is the
    absolute query position ``q_offset + row``.  The flash-attention
    kernels on the card, forward and backward; the plain masked softmax on
    the CPU.
    """
    return ops.flash_attention(q, k, v, window=window, q_offset=q_offset,
                               causal=causal)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_positions: torch.Tensor,
                     pos: torch.Tensor, window: int) -> torch.Tensor:
    """One-token attention against a ring-buffer cache.

    q: (B, 1, H, dk); caches (B, W, KV, d*); kv_positions (B, W) absolute
    positions of cached entries (-1 = empty); pos (B, 1) current positions.
    """
    B, _, H, dk = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, dk).float()
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k_cache.float()) * dk ** -0.5
    dist = pos - kv_positions  # (B, W)
    valid = (kv_positions >= 0) & (dist >= 0) & (dist < window)
    s = s.masked_fill(~valid[:, None, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", p, v_cache.float())
    return out.reshape(B, 1, H, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, W, KV, dk)
    v: torch.Tensor  # (B, W, KV, dv)
    positions: torch.Tensor  # (B, W) absolute positions, -1 empty


def gqa_init(gen: torch.Generator, d_model: int, cfg: AttentionConfig, *,
             device, dtype=torch.float32) -> dict:
    kw = dict(device=device, dtype=dtype)
    return {
        "wq": linear_init(gen, d_model, cfg.num_heads * cfg.head_dim,
                          bias=cfg.qkv_bias, **kw),
        "wk": linear_init(gen, d_model, cfg.num_kv_heads * cfg.head_dim,
                          bias=cfg.qkv_bias, **kw),
        "wv": linear_init(gen, d_model, cfg.num_kv_heads * cfg.head_dim,
                          bias=cfg.qkv_bias, **kw),
        "wo": linear_init(gen, cfg.num_heads * cfg.head_dim, d_model, **kw),
    }


def gqa_apply(params: dict, x: torch.Tensor, cfg: AttentionConfig, *,
              window: int, return_kv: bool = False):
    """Full-sequence causal GQA on x (B, S, d).  ``return_kv`` also returns
    the (post-RoPE) k, v for prefill cache population."""
    B, S, _ = x.shape
    q = linear(params["wq"], x).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = linear(params["wk"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = linear(params["wv"], x).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    out = blockwise_attention(q, k, v, window=window)
    y = linear(params["wo"], out.reshape(B, S, -1))
    if return_kv:
        return y, (k, v)
    return y


def _per_seq_pos(pos, B: int, device) -> torch.Tensor:
    """Normalize pos to (B,) int64: scalars broadcast."""
    pos = torch.as_tensor(pos, device=device).long()
    return pos.expand(B) if pos.dim() == 0 else pos


def gqa_decode(params: dict, x: torch.Tensor, cache: KVCache, pos,
               cfg: AttentionConfig, *, window: int):
    """One-token decode; writes (k, v, pos) into each sequence's ring slot
    pos[b] % W of ``cache`` in place and returns (y, cache)."""
    B = x.shape[0]
    W = cache.k.shape[1]
    posb = _per_seq_pos(pos, B, x.device)
    q = linear(params["wq"], x).reshape(B, 1, cfg.num_heads, cfg.head_dim)
    k = linear(params["wk"], x).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    v = linear(params["wv"], x).reshape(B, 1, cfg.num_kv_heads, cfg.head_dim)
    q = apply_rope(q, posb[:, None], cfg.rope_theta)
    k = apply_rope(k, posb[:, None], cfg.rope_theta)
    slots = posb % W
    bidx = torch.arange(B, device=x.device)
    cache.k[bidx, slots] = k[:, 0].to(cache.k.dtype)
    cache.v[bidx, slots] = v[:, 0].to(cache.v.dtype)
    cache.positions[bidx, slots] = posb.to(cache.positions.dtype)
    out = decode_attention(q, cache.k, cache.v, cache.positions,
                           posb[:, None], window)
    return linear(params["wo"], out.reshape(B, 1, -1)), cache


def fill_kv_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor, *,
                  start: int = 0) -> KVCache:
    """Prefill: write S (post-RoPE) rows into the ring in place, starting at
    absolute position ``start``; only the last W survive if S exceeds it."""
    B, S = k.shape[:2]
    W = cache.k.shape[1]
    tail = max(0, S - W)
    pos_abs = start + torch.arange(tail, S, device=k.device)
    slots = pos_abs % W
    cache.k[:, slots] = k[:, tail:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, tail:].to(cache.v.dtype)
    cache.positions[:, slots] = pos_abs.to(cache.positions.dtype).expand(B, -1)
    return cache


def gqa_init_cache(batch: int, max_len: int, cfg: AttentionConfig, dtype, *,
                   device) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device))
