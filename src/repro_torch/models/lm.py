"""The language model assembled from a config (dense / moe GQA families).

Public API:
  init_params(cfg, seed=, device=)                 -> params
  forward(params, cfg, tokens, impl=, device=)     -> (logits, MoEMetrics)
  prefill(params, cfg, tokens, cache, ...)         -> (logits, cache, metrics)
  init_cache(cfg, batch, cache_len, device=)       -> list of per-layer KVCache
  decode_step(params, cfg, tokens, pos, cache,...) -> (logits, cache, metrics)

Params mirror the JAX tree, except that ``params["layers"]`` is a list of
per-layer dicts (JAX stacks them on a leading L dim and scans; here a Python
loop runs the layers).  Numerics: JAX casts the *layer* params to
``cfg.dtype`` at every use and keeps ``embed``, ``final_norm`` and ``lm_head``
in f32, with f32 logits.  The port casts the layer params once, when they
are made or loaded (same values, no cast traffic per step), and keeps the
other three in f32.  The decode cache is updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.balance import MoEMetrics
from repro_torch.device import resolve
from repro_torch.models import blocks as B
from repro_torch.models.layers import (apply_norm, embed_init, embed_lookup,
                                       linear, linear_init, norm_init, unembed)


def cast_params(p, dtype):
    """Cast every floating tensor of a param tree to ``dtype``."""
    if isinstance(p, dict):
        return {k: cast_params(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> dict:
    """Random params from ``seed`` (the JAX package's distributions and
    scales; a torch generator, so not its numbers).  Layers come out in
    ``cfg.dtype``, made one layer at a time in f32 and cast."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)
    p = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev),
        "layers": [cast_params(B.layer_init(gen, cfg, device=dev), dtype)
                   for _ in range(cfg.num_layers)],
        "final_norm": norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size, device=dev)
    return p


def _inputs(params: dict, tokens, device) -> torch.Tensor:
    dev = resolve(device)
    where = params["embed"]["table"].device
    if where.type != dev.type:
        raise ValueError(f"params live on {where}, but device={dev}")
    return torch.as_tensor(tokens, device=where)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return linear(params["lm_head"], x.float())


def _accumulate(metrics, m):
    return metrics if m is None else metrics + m


def _n_experts(cfg: ModelConfig) -> int:
    return cfg.moe.num_experts if cfg.moe is not None else 1


def forward(params: dict, cfg: ModelConfig, tokens, *, impl: str = "einsum",
            device="cuda"):
    """tokens (B, S) -> (logits (B, S, V) f32, MoEMetrics summed over layers)."""
    tokens = _inputs(params, tokens, device)
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    for p_l, window in zip(params["layers"], B.layer_windows(cfg)):
        x, m = B.layer_apply_seq(p_l, cfg, x, window=window, impl=impl)
        metrics = _accumulate(metrics, m)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), metrics


def prefill(params: dict, cfg: ModelConfig, tokens, cache: list, *,
            impl: str = "einsum", device="cuda"):
    """tokens (B, S) + empty cache -> (logits (B, S, V), filled cache,
    metrics).  Decoding then continues at position S with decode_step."""
    tokens = _inputs(params, tokens, device)
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    new_cache = []
    for p_l, window, c_l in zip(params["layers"], B.layer_windows(cfg), cache):
        x, c_l, m = B.layer_apply_prefill(p_l, cfg, x, c_l, window=window,
                                          impl=impl)
        new_cache.append(c_l)
        metrics = _accumulate(metrics, m)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), new_cache, metrics


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device="cuda") -> list:
    """One ring-buffer KV cache per layer, in ``cfg.dtype``."""
    dev = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    return [B.layer_cache(cfg, batch, cache_len, dtype, device=dev)
            for _ in range(cfg.num_layers)]


def decode_step(params: dict, cfg: ModelConfig, tokens, pos, cache: list, *,
                impl: str = "einsum", device="cuda"):
    """tokens (B, 1) at absolute position ``pos`` (scalar or (B,)) ->
    (logits (B, 1, V), cache updated in place, metrics)."""
    tokens = _inputs(params, tokens, device)
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    cache_len = cache[0].positions.shape[-1]
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    new_cache = []
    for p_l, window, c_l in zip(params["layers"], B.layer_windows(cfg), cache):
        x, c_l, m = B.layer_apply_decode(p_l, cfg, x, c_l, pos,
                                         window=min(window, cache_len),
                                         impl=impl)
        new_cache.append(c_l)
        metrics = _accumulate(metrics, m)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), new_cache, metrics
