"""Per-layer blocks for every family, as full-sequence, prefill (fills the
decode cache) and one-token decode:

  dense / moe / vlm / audio decoder : [norm -> attn -> norm -> ffn | moe]
  ssm (rwkv6)                       : [norm -> time_mix -> norm -> channel_mix | moe]
  hybrid (hymba)                    : [norm -> (attn || mamba) fused -> norm -> ffn | moe]

Attention is GQA or MLA; the audio decoder (whisper) adds cross-attention
to the encoder's output after its self-attention.  The hybrid fuses its
two heads as ``0.5 * (norm_a(attn) + norm_m(mamba))``.  An fmoefy'd rwkv
replaces the channel mix by the MoE.  The MoE takes its input in the
model's compute dtype (the expert kernels take one dtype): only the ssm
family's f32 residual (its time mix returns f32, as the reference's) is
cast for it, where the JAX package would promote the experts to f32.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fmoe import _ffn_init, dense_ffn, fmoe_apply, fmoe_init
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models.layers import apply_norm, norm_init

FULL_WINDOW = 1 << 30  # "no window" sentinel (larger than any seq len)
NO_PAGED = ("ssm", "hybrid", "audio")  # recurrent-state / enc-out caches


def _is_mla(cfg: ModelConfig) -> bool:
    return cfg.attention is not None and cfg.attention.kind == "mla"


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
               shard: tuple = (slice(None), slice(None)),
               cross: bool = False) -> dict:
    """One layer.  Norm and router params are f32; the rest ``dtype``.
    ``expert_key`` and ``shard``: the routed experts' (``core.fmoe.
    fmoe_init``).  ``cross=True`` adds cross-attention (whisper's
    decoder)."""
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {"norm1": norm_init(d, cfg.norm, device=device),
         "norm2": norm_init(d, cfg.norm, device=device)}

    def ffn():
        if cfg.moe is not None:
            return fmoe_init(gen, d, cfg.moe, act=cfg.act, d_ff_dense=cfg.d_ff,
                             expert_key=expert_key, shard=shard, **kw)
        return _ffn_init(gen, d, cfg.d_ff, cfg.act, **kw)

    if cfg.family == "ssm":
        p["rwkv"] = R.rwkv_init(gen, cfg, **kw)
        if cfg.moe is not None:  # fmoefy'd rwkv: the MoE replaces channel-mix
            p["ffn"] = ffn()
        return p
    a = cfg.attention
    p["attn"] = (A.mla_init if _is_mla(cfg) else A.gqa_init)(gen, d, a, **kw)
    if cfg.family == "hybrid":
        p["mamba"] = M.mamba_init(gen, d, cfg.ssm, **kw)
        p["norm_a"] = norm_init(d, cfg.norm, device=device)
        p["norm_m"] = norm_init(d, cfg.norm, device=device)
    if cross:
        p["norm_cross"] = norm_init(d, cfg.norm, device=device)
        p["cross_attn"] = A.gqa_init(gen, d, a, **kw)
    p["ffn"] = ffn()
    return p


def _apply_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, impl: str,
               dist=None, noise_seed=None, l2p=None):
    if cfg.moe is not None:
        return fmoe_apply(p, x.to(getattr(torch, cfg.dtype)), cfg.moe,
                          act=cfg.act, impl=impl, dist=dist,
                          noise_seed=noise_seed, l2p=l2p)
    return dense_ffn(p, x, cfg.act), None


def _fuse(p: dict, cfg: ModelConfig, y_a, y_m):
    """Hymba's fusion of its parallel heads."""
    return 0.5 * (apply_norm(p["norm_a"], y_a, cfg.norm)
                  + apply_norm(p["norm_m"], y_m, cfg.norm))


def _cross(p: dict, cfg: ModelConfig, x: torch.Tensor, enc_out):
    """Whisper's decoder cross-attention to the encoder output: non-causal,
    no RoPE, every frame visible."""
    return A.gqa_apply(p["cross_attn"], apply_norm(p["norm_cross"], x, cfg.norm),
                       cfg.attention, window=FULL_WINDOW, kv_x=enc_out,
                       causal=False)


def _ssm_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, state, impl: str,
             dist=None, noise_seed=None, l2p=None):
    """The ssm layer's second half: channel mix (updating the state's
    shift), or the MoE of an fmoefy'd rwkv.  Returns (x, state, metrics)."""
    xn = apply_norm(p["norm2"], x, cfg.norm)
    if cfg.moe is None:
        h, state = R.channel_mix(p["rwkv"], xn, state)
        return x + h, state, None
    h, metrics = _apply_ffn(p["ffn"], cfg, xn, impl, dist, noise_seed, l2p)
    return x + h, state, metrics


def layer_apply_seq(p: dict, cfg: ModelConfig, x: torch.Tensor, *, window: int,
                    impl: str = "einsum", dist=None, noise_seed=None,
                    l2p=None, enc_out=None, mixer_state=None):
    """x (B, S, d) -> (x, MoEMetrics | None).  ``dist``: the MoE layer's
    ``core.fmoe.DistConfig`` (x is then this rank's batch rows);
    ``noise_seed``: the layer's exploration seed; ``l2p``: the layer's
    gate-id table under a per-layer placement (``fmoe_apply``);
    ``enc_out``: the encoder output the audio decoder cross-attends to;
    ``mixer_state``: the ssm or hybrid family's zero initial state
    (:func:`mixer_state`)."""
    xn = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.family == "ssm":
        h, _ = R.time_mix(p["rwkv"], xn, mixer_state, cfg)
        x, _, metrics = _ssm_ffn(p, cfg, x + h, mixer_state, impl, dist,
                                 noise_seed, l2p)
        return x, metrics
    a = cfg.attention
    if cfg.family == "hybrid":
        y_m, _ = M.mamba_apply(p["mamba"], xn, mixer_state, cfg.ssm)
        h = _fuse(p, cfg, A.gqa_apply(p["attn"], xn, a, window=window), y_m)
    else:
        attn = A.mla_apply if _is_mla(cfg) else A.gqa_apply
        h = attn(p["attn"], xn, a, window=window)
    x = x + h
    if enc_out is not None:
        x = x + _cross(p, cfg, x, enc_out)
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, noise_seed, l2p)
    return x + h, metrics


def layer_apply_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache, *, window: int, start: int = 0,
                        impl: str = "einsum", dist=None, l2p=None):
    """x (B, S, d), this layer's cache -> (x, filled cache, MoEMetrics|None).
    One full-sequence pass writes every position's K/V (MLA: latents; ssm
    and hybrid: the recurrent state) into the cache so decoding can
    continue at position S.  ``l2p``: as :func:`layer_apply_seq`'s."""
    xn = apply_norm(p["norm1"], x, cfg.norm)
    a = cfg.attention
    if cfg.family == "ssm":
        h, c1 = R.time_mix(p["rwkv"], xn, cache, cfg)
        return _ssm_ffn(p, cfg, x + h, c1, impl, dist, l2p=l2p)
    if cfg.family == "hybrid":
        y_a, (k, v) = A.gqa_apply(p["attn"], xn, a, window=window,
                                  return_kv=True)
        kv = A.fill_kv_cache(cache["attn"], k, v, start=start)
        y_m, ms = M.mamba_apply(p["mamba"], xn, cache["mamba"], cfg.ssm)
        x = x + _fuse(p, cfg, y_a, y_m)
        cache = {"attn": kv, "mamba": ms}
    elif cfg.family == "audio":
        h, (k, v) = A.gqa_apply(p["attn"], xn, a, window=window,
                                return_kv=True)
        x = x + h
        x = x + _cross(p, cfg, x, cache["enc_out"])
        cache = {"self": A.fill_kv_cache(cache["self"], k, v, start=start),
                 "enc_out": cache["enc_out"]}
    elif _is_mla(cfg):
        h, (ckv, kr) = A.mla_apply(p["attn"], xn, a, window=window,
                                   return_kv=True)
        cache = A.fill_mla_cache(cache, ckv, kr, start=start)
        x = x + h
    else:
        h, (k, v) = A.gqa_apply(p["attn"], xn, a, window=window,
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
    pool (``layer_paged_cache``) instead of per-slot rings: plain attention
    families only.  The ssm state ignores ``pos``.  ``l2p``: as
    :func:`layer_apply_seq`'s."""
    if block_tables is not None and cfg.family in NO_PAGED:
        raise NotImplementedError(
            f"paged KV cache is not supported for family {cfg.family!r}")
    xn = apply_norm(p["norm1"], x, cfg.norm)
    a = cfg.attention
    if cfg.family == "ssm":
        h, c1 = R.time_mix(p["rwkv"], xn, cache, cfg)
        return _ssm_ffn(p, cfg, x + h, c1, impl, dist, l2p=l2p)
    if cfg.family == "hybrid":
        y_a, kv = A.gqa_decode(p["attn"], xn, cache["attn"], pos, a,
                               window=window)
        y_m, ms = M.mamba_apply(p["mamba"], xn, cache["mamba"], cfg.ssm)
        x = x + _fuse(p, cfg, y_a, y_m)
        cache = {"attn": kv, "mamba": ms}
    elif cfg.family == "audio":
        h, kv = A.gqa_decode(p["attn"], xn, cache["self"], pos, a,
                             window=window)
        x = x + h
        x = x + _cross(p, cfg, x, cache["enc_out"])
        cache = {"self": kv, "enc_out": cache["enc_out"]}
    else:
        if block_tables is not None:
            decode = A.mla_decode_paged if _is_mla(cfg) else A.gqa_decode_paged
            h, cache = decode(p["attn"], xn, cache, block_tables, pos, a,
                              window=window)
        else:
            decode = A.mla_decode if _is_mla(cfg) else A.gqa_decode
            h, cache = decode(p["attn"], xn, cache, pos, a, window=window)
        x = x + h
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, l2p=l2p)
    return x + h, cache, metrics


def layer_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                device, enc_out: torch.Tensor | None = None):
    """A KVCache (MLA: an MLACache of latents); ssm: an RWKVState; hybrid:
    {"attn": KVCache, "mamba": MambaState}; audio: {"self": KVCache,
    "enc_out": the encoder output (zeros until prefill sets it)}."""
    a = cfg.attention
    if cfg.family == "ssm":
        return R.rwkv_init_state(batch, cfg, dtype, device=device)
    if cfg.family == "hybrid":
        return {"attn": A.gqa_init_cache(batch, cache_len, a, dtype,
                                         device=device),
                "mamba": M.mamba_init_state(batch, cfg.d_model, cfg.ssm,
                                            dtype, device=device)}
    if cfg.family == "audio":
        return {"self": A.gqa_init_cache(batch, cache_len, a, dtype,
                                         device=device),
                "enc_out": enc_out if enc_out is not None else torch.zeros(
                    batch, cfg.encoder.num_frames, cfg.d_model, dtype=dtype,
                    device=device)}
    init = A.mla_init_cache if _is_mla(cfg) else A.gqa_init_cache
    return init(batch, cache_len, a, dtype, device=device)


def layer_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                      dtype, *, device):
    """A PagedKVCache, or for MLA a PagedMLACache of latents: the layer's
    block pool shared by every decode slot (plain attention families
    only)."""
    if cfg.family in NO_PAGED or cfg.attention is None:
        raise NotImplementedError(
            f"paged KV cache is not supported for family {cfg.family!r}")
    init = A.mla_init_paged if _is_mla(cfg) else A.gqa_init_paged
    return init(num_blocks, block_size, cfg.attention, dtype, device=device)


def mixer_state(cfg: ModelConfig, batch: int, dtype, *, device) -> Any:
    """Zero recurrent state for full-sequence processing (ssm / hybrid),
    else None."""
    if cfg.family == "ssm":
        return R.rwkv_init_state(batch, cfg, dtype, device=device)
    if cfg.family == "hybrid":
        return M.mamba_init_state(batch, cfg.d_model, cfg.ssm, dtype,
                                  device=device)
    return None
