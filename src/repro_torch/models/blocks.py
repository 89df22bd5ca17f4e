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

Serving on a mesh computes some blocks tensor-parallel over ``model``
(``tp``, a ``models.layers.TP``): GQA attention on the rank's heads and
the dense, shared-expert and dense-residual FFNs on its columns of
``wi*`` and rows of ``wo``.  Each is a local part (:func:`attn_part_
prefill`, :func:`attn_part_decode`, the FFN in :func:`_apply_ffn`), then
one sum over ``model`` before the residual add, so norms and residuals
stay replicated over ``model``.  Prefill and decode hold each sum in one
place: the attention's in :func:`layer_apply_prefill` /
:func:`layer_apply_decode`, the FFN's in :func:`_apply_ffn` (and the
decoder's cross-attention's in :func:`_cross`).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fmoe import _ffn_init, dense_ffn, fmoe_apply, fmoe_init
from repro_torch.models import attention as A
from repro_torch.models import mamba as M
from repro_torch.models import rwkv6 as R
from repro_torch.models.layers import NO_TP, TP, apply_norm, norm_init

FULL_WINDOW = 1 << 30  # "no window" sentinel (larger than any seq len)
NO_PAGED = ("ssm", "hybrid", "audio")  # recurrent-state / enc-out caches
# the self-attention ring's key in a family's dict-shaped cache
RING_KEY = {"hybrid": "attn", "audio": "self"}


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
               dist=None, noise_seed=None, l2p=None, tp: TP = NO_TP):
    """The layer's FFN: dense, or the MoE (its shared and dense-residual
    FFNs inside ``fmoe_apply``).  A dense, shared or dense-residual FFN
    that ``tp`` computes tensor-parallel gives this rank's partial, summed
    over ``model`` here, once (the MoE's routed part is already its psum
    mode's sum)."""
    if cfg.moe is None:
        return tp.sum(dense_ffn(p, x, cfg.act), "ffn"), None
    x = x.to(getattr(torch, cfg.dtype))
    split = [k for k in ("shared", "dense") if k in p and tp.on(f"ffn/{k}")]
    y, metrics = fmoe_apply({k: v for k, v in p.items() if k not in split},
                            x, cfg.moe, act=cfg.act, impl=impl, dist=dist,
                            noise_seed=noise_seed, l2p=l2p)
    if split:
        part = sum(dense_ffn(p[k], x, cfg.act) for k in split)
        y = y + tp.sum(part, f"ffn/{split[0]}")
    return y, metrics


def _fuse(p: dict, cfg: ModelConfig, y_a, y_m):
    """Hymba's fusion of its parallel heads."""
    return 0.5 * (apply_norm(p["norm_a"], y_a, cfg.norm)
                  + apply_norm(p["norm_m"], y_m, cfg.norm))


def _cross(p: dict, cfg: ModelConfig, x: torch.Tensor, enc_out,
           tp: TP = NO_TP):
    """Whisper's decoder cross-attention to the encoder output: non-causal,
    no RoPE, every frame visible; summed over ``model`` where ``tp``
    computes it tensor-parallel."""
    h = A.gqa_apply(p["cross_attn"], apply_norm(p["norm_cross"], x, cfg.norm),
                    cfg.attention, window=FULL_WINDOW, kv_x=enc_out,
                    causal=False)
    return tp.sum(h, "cross_attn")


def _ssm_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, state, impl: str,
             dist=None, noise_seed=None, l2p=None, tp: TP = NO_TP):
    """The ssm layer's second half: channel mix (updating the state's
    shift), or the MoE of an fmoefy'd rwkv.  Returns (x, state, metrics)."""
    xn = apply_norm(p["norm2"], x, cfg.norm)
    if cfg.moe is None:
        h, state = R.channel_mix(p["rwkv"], xn, state)
        return x + h, state, None
    h, metrics = _apply_ffn(p["ffn"], cfg, xn, impl, dist, noise_seed, l2p,
                            tp)
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


def _ring(cfg: ModelConfig, cache):
    key = RING_KEY.get(cfg.family)
    return cache if key is None else cache[key]


def _with_ring(cfg: ModelConfig, cache, ring):
    key = RING_KEY.get(cfg.family)
    return ring if key is None else {**cache, key: ring}


def attn_part_prefill(p: dict, cfg: ModelConfig, xn: torch.Tensor, cache, *,
                      window: int, start: int = 0):
    """This rank's part of the layer's self-attention over the normed xn
    (B, S, d), and the layer's cache with its ring (MLA: latents) filled
    from ``start``: the whole output where the weights are whole, the
    rank's heads' partial of ``wo``'s product where they are its
    tensor-parallel shard.  Returns (part, cache)."""
    a = cfg.attention
    if _is_mla(cfg):
        h, (ckv, kr) = A.mla_apply(p["attn"], xn, a, window=window,
                                   return_kv=True)
        return h, A.fill_mla_cache(cache, ckv, kr, start=start)
    h, (k, v) = A.gqa_apply(p["attn"], xn, a, window=window, return_kv=True)
    return h, _with_ring(cfg, cache, A.fill_kv_cache(_ring(cfg, cache), k, v,
                                                     start=start))


def attn_part_decode(p: dict, cfg: ModelConfig, xn: torch.Tensor, cache, pos,
                     *, window: int, block_tables=None):
    """:func:`attn_part_prefill` for one token a sequence at ``pos``,
    against the ring or (``block_tables``) the paged pool, written in
    place.  Returns (part, cache)."""
    a = cfg.attention
    if block_tables is not None:
        decode = A.mla_decode_paged if _is_mla(cfg) else A.gqa_decode_paged
        return decode(p["attn"], xn, cache, block_tables, pos, a,
                      window=window)
    decode = A.mla_decode if _is_mla(cfg) else A.gqa_decode
    h, ring = decode(p["attn"], xn, _ring(cfg, cache), pos, a, window=window)
    return h, _with_ring(cfg, cache, ring)


def _after_attn(p: dict, cfg: ModelConfig, x, xn, h, cache, tp: TP):
    """The attention output h added to the residual: hymba fuses it with
    its mamba head (the state updated in ``cache``); whisper's decoder
    then cross-attends.  Returns (x, cache)."""
    if cfg.family == "hybrid":
        y_m, ms = M.mamba_apply(p["mamba"], xn, cache["mamba"], cfg.ssm)
        return x + _fuse(p, cfg, h, y_m), {**cache, "mamba": ms}
    x = x + h
    if cfg.family == "audio":
        x = x + _cross(p, cfg, x, cache["enc_out"], tp)
    return x, cache


def layer_apply_prefill(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache, *, window: int, start: int = 0,
                        impl: str = "einsum", dist=None, l2p=None,
                        tp: TP = NO_TP):
    """x (B, S, d), this layer's cache -> (x, filled cache, MoEMetrics|None).
    One full-sequence pass writes every position's K/V (MLA: latents; ssm
    and hybrid: the recurrent state) into the cache so decoding can
    continue at position S.  ``l2p``: as :func:`layer_apply_seq`'s.
    ``tp``: the blocks computed tensor-parallel (serving on a mesh)."""
    xn = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.family == "ssm":
        h, c1 = R.time_mix(p["rwkv"], xn, cache, cfg)
        return _ssm_ffn(p, cfg, x + h, c1, impl, dist, l2p=l2p, tp=tp)
    h, cache = attn_part_prefill(p, cfg, xn, cache, window=window,
                                 start=start)
    x, cache = _after_attn(p, cfg, x, xn, tp.sum(h, "attn"), cache, tp)
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, l2p=l2p, tp=tp)
    return x + h, cache, metrics


def layer_apply_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache, pos, *, window: int, impl: str = "einsum",
                       dist=None, block_tables=None, l2p=None,
                       tp: TP = NO_TP):
    """x (B, 1, d), this layer's cache -> (x, cache, MoEMetrics | None).
    ``block_tables`` (B, nb) reads and writes the cache as the paged block
    pool (``layer_paged_cache``) instead of per-slot rings: plain attention
    families only.  The ssm state ignores ``pos``.  ``l2p``: as
    :func:`layer_apply_seq`'s; ``tp``: as :func:`layer_apply_prefill`'s."""
    if block_tables is not None and cfg.family in NO_PAGED:
        raise NotImplementedError(
            f"paged KV cache is not supported for family {cfg.family!r}")
    xn = apply_norm(p["norm1"], x, cfg.norm)
    if cfg.family == "ssm":
        h, c1 = R.time_mix(p["rwkv"], xn, cache, cfg)
        return _ssm_ffn(p, cfg, x + h, c1, impl, dist, l2p=l2p, tp=tp)
    h, cache = attn_part_decode(p, cfg, xn, cache, pos, window=window,
                                block_tables=block_tables)
    x, cache = _after_attn(p, cfg, x, xn, tp.sum(h, "attn"), cache, tp)
    h, metrics = _apply_ffn(p["ffn"], cfg, apply_norm(p["norm2"], x, cfg.norm),
                            impl, dist, l2p=l2p, tp=tp)
    return x + h, cache, metrics


def _cache_attention(cfg: ModelConfig, tp: TP):
    """The attention config a rank's cache is sized by: its own KV heads
    where ``tp`` computes the attention tensor-parallel."""
    a = cfg.attention
    return A.rank_attention(a, tp.size) if tp.on("attn") else a


def layer_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype, *,
                device, enc_out: torch.Tensor | None = None,
                tp: TP = NO_TP):
    """A KVCache (MLA: an MLACache of latents); ssm: an RWKVState; hybrid:
    {"attn": KVCache, "mamba": MambaState}; audio: {"self": KVCache,
    "enc_out": the encoder output (zeros until prefill sets it)}.  A ring
    holds the rank's KV heads where ``tp`` computes attention
    tensor-parallel."""
    a = _cache_attention(cfg, tp)
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
                      dtype, *, device, tp: TP = NO_TP):
    """A PagedKVCache, or for MLA a PagedMLACache of latents: the layer's
    block pool shared by every decode slot (plain attention families
    only), of the rank's KV heads as :func:`layer_cache`'s ring."""
    if cfg.family in NO_PAGED or cfg.attention is None:
        raise NotImplementedError(
            f"paged KV cache is not supported for family {cfg.family!r}")
    init = A.mla_init_paged if _is_mla(cfg) else A.gqa_init_paged
    return init(num_blocks, block_size, _cache_attention(cfg, tp), dtype,
                device=device)


def mixer_state(cfg: ModelConfig, batch: int, dtype, *, device) -> Any:
    """Zero recurrent state for full-sequence processing (ssm / hybrid),
    else None."""
    if cfg.family == "ssm":
        return R.rwkv_init_state(batch, cfg, dtype, device=device)
    if cfg.family == "hybrid":
        return M.mamba_init_state(batch, cfg.d_model, cfg.ssm, dtype,
                                  device=device)
    return None
