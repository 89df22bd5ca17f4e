"""Per-layer blocks of the ``dense`` and ``moe`` families:
[norm -> attention (GQA or MLA) -> norm -> FFN | MoE], as full-sequence,
prefill (fills the decode cache) and one-token decode.  The other families
of the JAX package (ssm, hybrid, audio, vlm) are later slices (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fmoe import _ffn_init, dense_ffn, fmoe_apply, fmoe_init
from repro_torch.models import attention as A
from repro_torch.models.layers import apply_norm, norm_init

FULL_WINDOW = 1 << 30  # "no window" sentinel (larger than any seq len)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe") or cfg.attention is None \
            or cfg.attention.kind not in ("gqa", "mla"):
        raise NotImplementedError(
            f"repro_torch serves the dense/moe families with GQA or MLA so "
            f"far; {cfg.name!r} is family {cfg.family!r} (see ROADMAP.md)")


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention.kind == "mla"


def layer_windows(cfg: ModelConfig) -> list:
    """Per-layer attention window (FULL_WINDOW for global layers)."""
    a = cfg.attention
    L = cfg.num_layers
    if a is None or a.sliding_window is None:
        return [FULL_WINDOW] * L
    return [FULL_WINDOW if i in a.global_layers else a.sliding_window
            for i in range(L)]


def layer_init(gen: torch.Generator, cfg: ModelConfig, *, device,
               dtype=torch.float32, expert_key: int | None = None,
               shard: tuple = (slice(None), slice(None))) -> dict:
    """One decoder layer.  Norm and router params are f32; the rest
    ``dtype``.  ``expert_key`` and ``shard``: the routed experts'
    (``core.fmoe.fmoe_init``)."""
    _check_family(cfg)
    d = cfg.d_model
    p = {"norm1": norm_init(d, cfg.norm, device=device),
         "norm2": norm_init(d, cfg.norm, device=device),
         "attn": (A.mla_init if _is_mla(cfg) else A.gqa_init)(
             gen, d, cfg.attention, device=device, dtype=dtype)}
    if cfg.moe is not None:
        p["ffn"] = fmoe_init(gen, d, cfg.moe, act=cfg.act, d_ff_dense=cfg.d_ff,
                             device=device, dtype=dtype, expert_key=expert_key,
                             shard=shard)
    else:
        p["ffn"] = _ffn_init(gen, d, cfg.d_ff, cfg.act, device=device,
                             dtype=dtype)
    return p


def _apply_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, impl: str,
               dist=None, noise_seed=None, l2p=None):
    if cfg.moe is not None:
        return fmoe_apply(p, x, cfg.moe, act=cfg.act, impl=impl, dist=dist,
                          noise_seed=noise_seed, l2p=l2p)
    return dense_ffn(p, x, cfg.act), None


def layer_apply_seq(p: dict, cfg: ModelConfig, x: torch.Tensor, *, window: int,
                    impl: str = "einsum", dist=None, noise_seed=None,
                    l2p=None):
    """x (B, S, d) -> (x, MoEMetrics | None).  ``dist``: the MoE layer's
    ``core.fmoe.DistConfig`` (x is then this rank's batch rows);
    ``noise_seed``: the layer's exploration seed; ``l2p``: the layer's
    gate-id table under a per-layer placement (``fmoe_apply``)."""
    attn = A.mla_apply if _is_mla(cfg) else A.gqa_apply
    h = attn(p["attn"], apply_norm(p["norm1"], x, cfg.norm), cfg.attention,
             window=window)
    x = x + h
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, noise_seed, l2p)
    return x + h, metrics


def layer_apply_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache, *, window: int, start: int = 0,
                        impl: str = "einsum", dist=None, l2p=None):
    """x (B, S, d), this layer's cache -> (x, filled cache, MoEMetrics|None).
    One full-sequence pass writes every position's K/V (MLA: latents) into
    the cache so decoding can continue at position S.  ``l2p``: as
    :func:`layer_apply_seq`'s."""
    xn = apply_norm(p["norm1"], x, cfg.norm)
    if _is_mla(cfg):
        h, (ckv, kr) = A.mla_apply(p["attn"], xn, cfg.attention,
                                   window=window, return_kv=True)
        cache = A.fill_mla_cache(cache, ckv, kr, start=start)
    else:
        h, (k, v) = A.gqa_apply(p["attn"], xn, cfg.attention, window=window,
                                return_kv=True)
        cache = A.fill_kv_cache(cache, k, v, start=start)
    x = x + h
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, l2p=l2p)
    return x + h, cache, metrics


def layer_apply_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache, pos, *, window: int, impl: str = "einsum",
                       dist=None, block_tables=None, l2p=None):
    """x (B, 1, d), this layer's cache -> (x, cache, MoEMetrics | None).
    ``block_tables`` (B, nb) reads and writes the cache as the paged block
    pool (``layer_paged_cache``) instead of per-slot rings.  ``l2p``: as
    :func:`layer_apply_seq`'s."""
    xn = apply_norm(p["norm1"], x, cfg.norm)
    if block_tables is not None:
        decode = A.mla_decode_paged if _is_mla(cfg) else A.gqa_decode_paged
        h, cache = decode(p["attn"], xn, cache, block_tables, pos,
                          cfg.attention, window=window)
    else:
        decode = A.mla_decode if _is_mla(cfg) else A.gqa_decode
        h, cache = decode(p["attn"], xn, cache, pos, cfg.attention,
                          window=window)
    x = x + h
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, l2p=l2p)
    return x + h, cache, metrics


def layer_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                device):
    """A KVCache, or for MLA an MLACache of latents."""
    _check_family(cfg)
    init = A.mla_init_cache if _is_mla(cfg) else A.gqa_init_cache
    return init(batch, cache_len, cfg.attention, dtype, device=device)


def layer_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                      dtype, *, device):
    """A PagedKVCache, or for MLA a PagedMLACache of latents: the layer's
    block pool shared by every decode slot."""
    _check_family(cfg)
    init = A.mla_init_paged if _is_mla(cfg) else A.gqa_init_paged
    return init(num_blocks, block_size, cfg.attention, dtype, device=device)
