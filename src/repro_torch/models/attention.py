"""Attention blocks: GQA and MLA (DeepSeek-V2), full-sequence (prefill)
and one-token decode against a ring-buffer cache or a paged block pool.

In the JAX package's ``(B, S, H, d)`` layout.  ``blockwise_attention``
computes what the JAX blockwise online-softmax scan computes through the
flash-attention kernels (``kernels/flash_attention.py``: the (S, S) scores
never reach device memory on the card; on the CPU their plain version, one
masked softmax in f32).  Decode is plain PyTorch matmuls and a masked
softmax in f32 over the ring.  The cache keeps each
entry's absolute position beside it (-1 = empty, masked); RoPE is applied
at write time.  Decode writes the cache in place — the JAX version returns
a new cache; the port updates the tensors it was given and returns them.
The paged decodes (continuous batching) read and write one pool of blocks
shared by every slot through per-slot block tables (see "Paged KV cache"
below).

Under tensor parallelism (serving on a mesh, ``launch/sharding``) a
rank's GQA weights hold its heads; every function here reads the head
counts from the weights, and its cache holds the rank's own KV heads
(:func:`rank_attention` sizes it).  The reference's ``cache_specs`` splits
the trailing ``head_dim`` over ``model`` instead; where both split, a rank
holds the same bytes either way.  MLA's latent cache stays whole on each
rank (the reference splits the latent over ``model``).

MLA caches only the compressed latent (kv_lora) and the shared rope key;
prefill materialises per-head keys (dk = nope + rope) and values (dv) from
the latent and runs the flash kernels with dv != dk, and decode uses the
*absorbed* form (W_uk folded into the query, W_uv into the output), in f32
einsums against the cached latents, as the reference does.
"""
from __future__ import annotations

import dataclasses
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


def rank_attention(cfg: AttentionConfig, mp: int) -> AttentionConfig:
    """``cfg`` at one rank's heads when its GQA attention is tensor-parallel
    over ``mp`` model ranks (its caches' size)."""
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // mp,
                               num_kv_heads=cfg.num_kv_heads // mp)


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
              window: int, positions=None, kv_x: torch.Tensor | None = None,
              causal: bool = True, return_kv: bool = False):
    """Full-sequence GQA on x (B, S, d).  The head counts come from the
    weights given (``wq``'s and ``wk``'s widths over ``head_dim``): under
    tensor parallelism a rank's heads, and the output is then its partial
    of ``wo``'s product, which the caller sums over ``model``.  ``kv_x``
    (B, Skv, d), the cross-attention source, defaults to x.  Causal self-attention ropes q
    at ``positions`` (default arange(S)) and k at arange(Skv); the
    non-causal encoder and cross-attention skip RoPE, as the reference.
    ``return_kv`` also returns the (post-RoPE) k, v for prefill cache
    population."""
    B, S, _ = x.shape
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = linear(params["wq"], x).reshape(B, S, -1, cfg.head_dim)
    k = linear(params["wk"], src).reshape(B, Skv, -1, cfg.head_dim)
    v = linear(params["wv"], src).reshape(B, Skv, -1, cfg.head_dim)
    if causal:
        pos = torch.arange(S, device=x.device) if positions is None \
            else positions
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, torch.arange(Skv, device=x.device), cfg.rope_theta)
    out = blockwise_attention(q, k, v, window=window, causal=causal)
    y = linear(params["wo"], out.reshape(B, S, -1))
    if return_kv:
        return y, (k, v)
    return y


def _per_seq_pos(pos, B: int, device) -> torch.Tensor:
    """Normalize pos to (B,) int64: scalars broadcast."""
    pos = torch.as_tensor(pos, device=device).long()
    return pos.expand(B) if pos.dim() == 0 else pos


def _write_slots(cache, rows: tuple, posb: torch.Tensor):
    """Decode: write each sequence's new row of every cached tensor (all
    but ``positions``, in order) and its position into ring slot
    posb[b] % W, in place."""
    slots = posb % cache.positions.shape[1]
    bidx = torch.arange(posb.shape[0], device=posb.device)
    for buf, row in zip(cache[:-1], rows):
        buf[bidx, slots] = row.to(buf.dtype)
    cache.positions[bidx, slots] = posb.to(cache.positions.dtype)
    return cache


def _fill_ring(cache, rows: tuple, start: int):
    """Prefill: write S rows of every cached tensor (all but
    ``positions``, in order) into the ring from absolute position
    ``start``, in place; only the last W survive if S exceeds it."""
    B, S = rows[0].shape[:2]
    W = cache.positions.shape[1]
    tail = max(0, S - W)
    pos_abs = start + torch.arange(tail, S, device=rows[0].device)
    slots = pos_abs % W
    for buf, new in zip(cache[:-1], rows):
        buf[:, slots] = new[:, tail:].to(buf.dtype)
    cache.positions[:, slots] = pos_abs.to(cache.positions.dtype).expand(B, -1)
    return cache


def _gqa_decode_qkv(params: dict, x: torch.Tensor, posb: torch.Tensor,
                    cfg: AttentionConfig):
    """q (B, 1, H, dk), k and v (B, 1, KV, d) of one decode token a
    sequence, q and k roped at its position posb (B,)."""
    B = x.shape[0]
    q = linear(params["wq"], x).reshape(B, 1, -1, cfg.head_dim)
    k = linear(params["wk"], x).reshape(B, 1, -1, cfg.head_dim)
    v = linear(params["wv"], x).reshape(B, 1, -1, cfg.head_dim)
    q = apply_rope(q, posb[:, None], cfg.rope_theta)
    k = apply_rope(k, posb[:, None], cfg.rope_theta)
    return q, k, v


def gqa_decode(params: dict, x: torch.Tensor, cache: KVCache, pos,
               cfg: AttentionConfig, *, window: int):
    """One-token decode; writes (k, v, pos) into each sequence's ring slot
    pos[b] % W of ``cache`` in place and returns (y, cache)."""
    B = x.shape[0]
    posb = _per_seq_pos(pos, B, x.device)
    q, k, v = _gqa_decode_qkv(params, x, posb, cfg)
    cache = _write_slots(cache, (k[:, 0], v[:, 0]), posb)
    out = decode_attention(q, cache.k, cache.v, cache.positions,
                           posb[:, None], window)
    return linear(params["wo"], out.reshape(B, 1, -1)), cache


# ---------------------------------------------------------------------------
# Paged KV cache (continuous batching)
# ---------------------------------------------------------------------------
#
# The pool replaces the per-slot ring with shared physical blocks of
# ``block_size`` rows; each decode slot owns a block *table* mapping its
# logical block j (positions [j*bs, (j+1)*bs)) to a pool row.  Entry order
# in the gathered per-slot view equals the absolute position, and empty or
# stale entries carry position -1, so decode_attention gives them an exact
# zero softmax weight: the paged read equals a ring of length
# blocks_per_slot * block_size bit for bit.
#
# Pool row 0 is the null block (never written; positions -1) that
# unallocated table entries point at; row 1 is the scratch block that takes
# the writes of idle slots (table rows all null).  Idle slots write the
# scratch block at the same offsets, and a CUDA index_put_ with duplicate
# indices keeps an arbitrary one: harmless, as no table holds the scratch
# block.

NULL_BLOCK = 0
SCRATCH_BLOCK = 1
RESERVED_BLOCKS = 2


class PagedKVCache(NamedTuple):
    k: torch.Tensor  # (P, bs, KV, dk) shared block pool
    v: torch.Tensor  # (P, bs, KV, dv)
    positions: torch.Tensor  # (P, bs) absolute positions, -1 empty


class PagedMLACache(NamedTuple):
    ckv: torch.Tensor  # (P, bs, kv_lora)
    kr: torch.Tensor  # (P, bs, qk_rope)
    positions: torch.Tensor  # (P, bs)


def gqa_init_paged(num_blocks: int, block_size: int, cfg: AttentionConfig,
                   dtype, *, device) -> PagedKVCache:
    shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        torch.full((num_blocks, block_size), -1,
                                   dtype=torch.int32, device=device))


def mla_init_paged(num_blocks: int, block_size: int, cfg: AttentionConfig,
                   dtype, *, device) -> PagedMLACache:
    return PagedMLACache(
        torch.zeros(num_blocks, block_size, cfg.kv_lora_rank, dtype=dtype,
                    device=device),
        torch.zeros(num_blocks, block_size, cfg.qk_rope_head_dim, dtype=dtype,
                    device=device),
        torch.full((num_blocks, block_size), -1, dtype=torch.int32,
                   device=device))


def _paged_target(tables: torch.Tensor, posb: torch.Tensor, bs: int):
    """(pb, off): each slot's write target.  Null-block entries (idle slots,
    positions past the table) go to the scratch block."""
    nb = tables.shape[1]
    blk = torch.clamp(torch.div(posb, bs, rounding_mode="floor"), 0, nb - 1)
    pb = tables[torch.arange(posb.shape[0], device=posb.device), blk].long()
    pb = torch.where(pb == NULL_BLOCK, SCRATCH_BLOCK, pb)
    return pb, posb % bs


def _paged_view(pool_leaf: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Each slot's contiguous view: (P, bs, ...) x (B, nb) -> (B, nb*bs, ...).
    Entry index == absolute position."""
    g = pool_leaf[tables.long()]  # (B, nb, bs, ...)
    B, nb, bs = g.shape[:3]
    return g.reshape(B, nb * bs, *g.shape[3:])


def _write_paged(cache, rows: tuple, tables: torch.Tensor, posb: torch.Tensor):
    """Decode: write each slot's new row of every pooled tensor (all but
    ``positions``, in order) and its position at its paged target, in
    place."""
    pb, off = _paged_target(tables, posb, cache.positions.shape[1])
    for buf, row in zip(cache[:-1], rows):
        buf[pb, off] = row.to(buf.dtype)
    cache.positions[pb, off] = posb.to(cache.positions.dtype)
    return cache


def gqa_decode_paged(params: dict, x: torch.Tensor, cache: PagedKVCache,
                     tables: torch.Tensor, pos, cfg: AttentionConfig, *,
                     window: int):
    """One-token decode against the shared block pool.  ``tables`` (B, nb)
    maps each slot's logical blocks to pool rows (0 = unallocated).
    Writes the pool in place and returns (y, cache)."""
    B = x.shape[0]
    posb = _per_seq_pos(pos, B, x.device)
    q, k, v = _gqa_decode_qkv(params, x, posb, cfg)
    cache = _write_paged(cache, (k[:, 0], v[:, 0]), tables, posb)
    out = decode_attention(q, _paged_view(cache.k, tables),
                           _paged_view(cache.v, tables),
                           _paged_view(cache.positions, tables),
                           posb[:, None], window)
    return linear(params["wo"], out.reshape(B, 1, -1)), cache


def fill_kv_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor, *,
                  start: int = 0) -> KVCache:
    """Prefill: write S (post-RoPE) rows into the ring in place, starting at
    absolute position ``start``; only the last W survive if S exceeds it."""
    return _fill_ring(cache, (k, v), start)


def gqa_init_cache(batch: int, max_len: int, cfg: AttentionConfig, dtype, *,
                   device) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device))


# ---------------------------------------------------------------------------
# MLA block (DeepSeek-V2)
# ---------------------------------------------------------------------------


class MLACache(NamedTuple):
    ckv: torch.Tensor  # (B, W, kv_lora) compressed latent
    kr: torch.Tensor  # (B, W, qk_rope) decoupled rope key (shared by heads)
    positions: torch.Tensor  # (B, W) absolute positions, -1 empty


def mla_init(gen: torch.Generator, d_model: int, cfg: AttentionConfig, *,
             device, dtype=torch.float32) -> dict:
    """The reference's leaves and layouts: ``w_uk`` (H, kv_lora, nope) and
    ``w_uv`` (H, kv_lora, v) up-project the latent per head; ``w_q`` stands
    in for ``w_dq`` and ``w_uq`` when ``q_lora_rank`` is 0."""
    kw = dict(device=device, dtype=dtype)
    H, r = cfg.num_heads, cfg.kv_lora_rank
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim

    def up(d):
        t = torch.randn(H, r, d, generator=gen, device=device) * r ** -0.5
        return t.to(dtype)

    p = {"w_dkv": linear_init(gen, d_model, r, **kw),
         "w_kr": linear_init(gen, d_model, cfg.qk_rope_head_dim, **kw),
         "w_uk": up(cfg.qk_nope_head_dim),
         "w_uv": up(cfg.v_head_dim),
         "wo": linear_init(gen, H * cfg.v_head_dim, d_model, **kw)}
    if cfg.q_lora_rank:
        p["w_dq"] = linear_init(gen, d_model, cfg.q_lora_rank, **kw)
        p["w_uq"] = linear_init(gen, cfg.q_lora_rank, H * qd, **kw)
    else:
        p["w_q"] = linear_init(gen, d_model, H * qd, **kw)
    return p


def _mla_q(params: dict, x: torch.Tensor, cfg: AttentionConfig):
    """(q_nope, q_rope), each (B, S, H, *)."""
    B, S, _ = x.shape
    if "w_dq" in params:
        q = linear(params["w_uq"], linear(params["w_dq"], x))
    else:
        q = linear(params["w_q"], x)
    q = q.reshape(B, S, cfg.num_heads,
                  cfg.qk_nope_head_dim + cfg.qk_rope_head_dim)
    return q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)


def mla_apply(params: dict, x: torch.Tensor, cfg: AttentionConfig, *,
              window: int, positions=None, return_kv: bool = False):
    """Training/prefill MLA on x (B, S, d): per-head keys concat(nope, rope)
    (dk = nope + rope) and values (dv) from the latent, through the flash
    kernels.  As the reference: q is roped at ``positions`` (default
    arange(S)), the shared rope key at arange(S).  ``return_kv`` also
    returns the latents (ckv (B, S, kv_lora), kr (B, S, rope)) for the
    decode cache."""
    B, S, _ = x.shape
    H, rope = cfg.num_heads, cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q(params, x, cfg)
    ar = torch.arange(S, device=x.device)
    q_rope = apply_rope(q_rope, ar if positions is None else positions,
                        cfg.rope_theta)
    ckv = linear(params["w_dkv"], x)
    kr = linear(params["w_kr"], x).reshape(B, S, 1, rope)
    kr = apply_rope(kr, ar, cfg.rope_theta)
    k_nope = torch.einsum("bsr,hrd->bshd", ckv, params["w_uk"])
    v = torch.einsum("bsr,hrd->bshd", ckv, params["w_uv"]).contiguous()
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(B, S, H, rope)], dim=-1)
    out = blockwise_attention(q, k, v, window=window)
    y = linear(params["wo"], out.reshape(B, S, -1))
    if return_kv:
        return y, (ckv, kr[:, :, 0, :])
    return y


def fill_mla_cache(cache: MLACache, ckv: torch.Tensor, kr: torch.Tensor, *,
                   start: int = 0) -> MLACache:
    """Prefill the latent cache in place (ckv (B, S, kv_lora), kr (B, S,
    rope)) from absolute position ``start``; only the last W survive if S
    exceeds the ring."""
    return _fill_ring(cache, (ckv, kr), start)


def _mla_decode_inputs(params: dict, x: torch.Tensor, posb: torch.Tensor,
                       cfg: AttentionConfig):
    """(q_nope, q_rope (B, 1, H, *), ckv (B, kv_lora), kr (B, rope)) of one
    decode token a sequence, roped at its position posb (B,)."""
    B, rope = x.shape[0], cfg.qk_rope_head_dim
    q_nope, q_rope = _mla_q(params, x, cfg)
    q_rope = apply_rope(q_rope, posb[:, None], cfg.rope_theta)
    ckv = linear(params["w_dkv"], x)[:, 0]
    kr = linear(params["w_kr"], x).reshape(B, 1, 1, rope)
    kr = apply_rope(kr, posb[:, None], cfg.rope_theta)[:, 0, 0]
    return q_nope, q_rope, ckv, kr


def mla_decode(params: dict, x: torch.Tensor, cache: MLACache, pos,
               cfg: AttentionConfig, *, window: int):
    """Absorbed-form one-token decode: writes (ckv, kr, pos) into each
    sequence's ring slot pos[b] % W in place, scores the query against the
    cached latents (W_uk absorbed into q) and maps the attended latent
    through W_uv, in f32 einsums; scale (nope + rope)^-1/2.  ``pos``:
    scalar or (B,).  Returns (y, cache)."""
    posb = _per_seq_pos(pos, x.shape[0], x.device)
    q_nope, q_rope, ckv, kr = _mla_decode_inputs(params, x, posb, cfg)
    cache = _write_slots(cache, (ckv, kr), posb)
    out = _mla_absorbed(params, q_nope, q_rope, cache.ckv, cache.kr,
                        cache.positions, posb, cfg, window)
    return linear(params["wo"], out.to(x.dtype)), cache


def _mla_absorbed(params: dict, q_nope, q_rope, ckv, kr, positions, posb,
                  cfg: AttentionConfig, window: int) -> torch.Tensor:
    """The absorbed-form attention of one query a sequence against cached
    latents ckv (B, W, kv_lora), kr (B, W, rope) at ``positions`` (B, W),
    in f32 einsums; returns (B, 1, H * v) f32."""
    B, H = q_nope.shape[0], cfg.num_heads
    q_eff = torch.einsum("bhd,hrd->bhr", q_nope[:, 0].float(),
                         params["w_uk"].float())
    s = torch.einsum("bhr,bwr->bhw", q_eff, ckv.float())
    s = s + torch.einsum("bhd,bwd->bhw", q_rope[:, 0].float(), kr.float())
    s = s * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    dist = posb[:, None] - positions
    valid = (positions >= 0) & (dist >= 0) & (dist < window)
    s = s.masked_fill(~valid[:, None, :], _NEG)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhw,bwr->bhr", p, ckv.float())
    out = torch.einsum("bhr,hrd->bhd", o_lat, params["w_uv"].float())
    return out.reshape(B, 1, H * cfg.v_head_dim)


def mla_decode_paged(params: dict, x: torch.Tensor, cache: PagedMLACache,
                     tables: torch.Tensor, pos, cfg: AttentionConfig, *,
                     window: int):
    """Absorbed-form MLA decode against the shared latent block pool:
    ``mla_decode`` with the slot's latents read through its block table.
    Writes the pool in place and returns (y, cache)."""
    posb = _per_seq_pos(pos, x.shape[0], x.device)
    q_nope, q_rope, ckv, kr = _mla_decode_inputs(params, x, posb, cfg)
    cache = _write_paged(cache, (ckv, kr), tables, posb)
    out = _mla_absorbed(params, q_nope, q_rope, _paged_view(cache.ckv, tables),
                        _paged_view(cache.kr, tables),
                        _paged_view(cache.positions, tables), posb, cfg, window)
    return linear(params["wo"], out.to(x.dtype)), cache


def mla_init_cache(batch: int, max_len: int, cfg: AttentionConfig, dtype, *,
                   device) -> MLACache:
    return MLACache(
        torch.zeros(batch, max_len, cfg.kv_lora_rank, dtype=dtype, device=device),
        torch.zeros(batch, max_len, cfg.qk_rope_head_dim, dtype=dtype,
                    device=device),
        torch.full((batch, max_len), -1, dtype=torch.int32, device=device))
