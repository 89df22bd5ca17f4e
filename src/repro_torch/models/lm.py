"""The language model assembled from a config (dense / moe families, GQA
or MLA attention).

Public API:
  init_params(cfg, seed=, device=, param_dtype=, mesh=, expert_tp=) -> params
  forward(params, cfg, tokens, impl=, device=, dist=, router_seed=,
          layer_loads=)                            -> (logits, MoEMetrics[,
                                                       (L, E) loads])
  loss_fn(params, cfg, batch, impl=, device=, dist=, router_seed=)
                                                   -> (loss, aux dict)
  prefill(params, cfg, tokens, cache, ...)         -> (logits, cache, metrics)
  init_cache(cfg, batch, cache_len, device=)       -> list of per-layer caches
  init_paged_cache(cfg, num_blocks, block_size, device=) -> list of pools
  decode_step(params, cfg, tokens, pos, cache,..., layer_loads=)
                                                   -> (logits, cache, metrics[,
                                                       (L, E) loads])

Params mirror the JAX tree, except that ``params["layers"]`` is a list of
per-layer dicts (JAX stacks them on a leading L dim and scans; here a Python
loop runs the layers).  Numerics: JAX keeps f32 master params, casts the
*layer* params to ``cfg.dtype`` at every use and keeps ``embed``,
``final_norm`` and ``lm_head`` in f32, with f32 logits.  The port does the
same — every forward casts the layer params at use, so gradients reach f32
leaves through the cast — and for serving makes or loads the layers
already in ``cfg.dtype`` (``init_params`` default), where that cast is a
no-op.  ``cfg.remat == "full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.remat`` does; the
cast sits inside the recomputed region, so no bf16 copy of the weights
outlives its layer.  The decode cache is updated in place.

With ``dist`` (a ``core.fmoe.DistConfig`` over a mesh) ``forward`` and
``loss_fn`` run this rank's batch rows, and every MoE layer exchanges its
tokens with the other ranks; under remat each layer's exchange runs again
in the backward, on every rank in the same order.  ``prefill`` and
``decode_step`` take the psum mode (serving): every rank holds all of the
tokens and computes its own experts, and the layer sums over the ranks.

A placement on ``dist`` (``repro_torch.placement``) needs the params in
its physical order (``placement.migrate``); a ``PerLayerPlacement`` is
split into its shared geometry, which rides on the layers' ``dist``, and
each layer's gate-id table (``_layer_tables``), in ``forward``,
``prefill`` and ``decode_step`` alike.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dispatch as D
from repro_torch.core.balance import MoEMetrics
from repro_torch.core.fmoe import expert_seed
from repro_torch.device import resolve
from repro_torch.models import blocks as B
from repro_torch.models.layers import (apply_norm, embed_init, embed_lookup,
                                       linear, linear_init, norm_init, unembed)
from repro_torch.placement.plan import PerLayerPlacement


def cast_params(p, dtype):
    """Cast every floating tensor of a param tree to ``dtype``."""
    if isinstance(p, dict):
        return {k: cast_params(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                param_dtype: str | None = None, mesh=None,
                expert_tp: bool = False) -> dict:
    """Random params from ``seed`` (the JAX package's distributions and
    scales; torch generators, so not its numbers).  Layers are made one at
    a time, each weight drawn in f32 and stored in ``param_dtype`` (a routed
    expert as it is drawn, so a layer never exists whole in f32: one of
    arctic-480b's is ~54 GB so): by default ``cfg.dtype``, the serving
    layout; training passes ``cfg.param_dtype`` (f32 masters).

    Every leaf but the routed expert stacks comes from one generator seeded
    by ``seed``; expert ``e`` of leaf ``i`` of layer ``l``'s stacks from a
    generator seeded by (seed, l, i, e) alone.  So with ``mesh`` (a
    ``launch.mesh.Mesh``; shape and rank suffice, no process group) a rank
    makes only its shard, its experts one at a time, and that shard equals
    ``interop.shard_params(init_params(...), mesh, expert_tp=expert_tp)``
    of the whole bit for bit."""
    dev = resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = getattr(torch, param_dtype or cfg.dtype)
    shard = (slice(None), slice(None))
    if mesh is not None and cfg.moe is not None:
        shard = mesh.expert_shard(cfg.moe.num_experts, cfg.moe.d_expert_hidden,
                                  tp=expert_tp)
    p = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev),
        "layers": [cast_params(B.layer_init(
            gen, cfg, device=dev, dtype=dtype,
            expert_key=expert_seed(seed, layer), shard=shard), dtype)
            for layer in range(cfg.num_layers)],
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


def _layer_seq(p_l: dict, cfg: ModelConfig, x: torch.Tensor, window: int,
               impl: str, dist, noise_seed=None, l2p=None):
    dtype = getattr(torch, cfg.dtype)
    x, m = B.layer_apply_seq(cast_params(p_l, dtype), cfg, x, window=window,
                             impl=impl, dist=dist, noise_seed=noise_seed,
                             l2p=l2p)
    return x.to(dtype), m


def _layer_tables(cfg: ModelConfig, dist, device):
    """Split a per-layer placement riding on ``dist``: returns (``dist``
    with the plan's shared geometry, the (L, E) logical -> physical tables
    on ``device``), or (``dist``, None) for no plan or a shared one."""
    place = None if dist is None else dist.placement
    if not isinstance(place, PerLayerPlacement):
        return dist, None
    place.validate()
    if place.num_layers != cfg.num_layers:
        raise ValueError(f"per-layer placement has {place.num_layers} "
                         f"layers, config has {cfg.num_layers}")
    return dist._replace(placement=place.geometry), D.device_index_table(
        place, device)


def forward(params: dict, cfg: ModelConfig, tokens, *, impl: str = "einsum",
            device="cuda", dist=None, router_seed: int | None = None,
            layer_loads: bool = False):
    """tokens (B, S) -> (logits (B, S, V) f32, MoEMetrics summed over
    layers), and with ``layer_loads`` the (L, E) stack of the layers' loads
    (logical expert order) as well.

    ``router_seed`` arms the exploration of the noisy_topk and gumbel
    routers: layer ``l`` draws its noise from ``expert_seed(router_seed,
    l)`` inside the layer, so the remat recompute draws the same (an
    integer, never a stateful generator, enters the checkpoint).  None
    routes deterministically, the eval and serving stance."""
    tokens = _inputs(params, tokens, device)
    x = embed_lookup(params["embed"], tokens, getattr(torch, cfg.dtype))
    dist, tables = _layer_tables(cfg, dist, x.device)
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    loads = []
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for layer, (p_l, window) in enumerate(zip(params["layers"],
                                              B.layer_windows(cfg))):
        seed = None if router_seed is None else expert_seed(router_seed, layer)
        l2p = None if tables is None else tables[layer]
        if remat:
            x, m = checkpoint(_layer_seq, p_l, cfg, x, window, impl, dist,
                              seed, l2p, use_reentrant=False)
        else:
            x, m = _layer_seq(p_l, cfg, x, window, impl, dist, seed, l2p)
        metrics = _accumulate(metrics, m)
        if m is not None:
            loads.append(m.load.detach())
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = _logits(params, cfg, x)
    if not layer_loads:
        return logits, metrics
    if not loads:
        return logits, metrics, x.new_zeros(cfg.num_layers, _n_experts(cfg),
                                            dtype=torch.float32)
    return logits, metrics, torch.stack(loads)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            impl: str = "einsum", device="cuda", dist=None,
            router_seed: int | None = None):
    """Next-token cross-entropy in f32 + the MoE aux losses, as the JAX
    ``loss_fn``: ``ce + (balance * aux + z * z_loss) / L``.  batch:
    {"tokens": (B, S)}.  Returns (loss, {ce, aux_loss, z_loss, drop_frac,
    load, load_layers} and the telemetry counters of :func:`obs_aux`),
    drop_frac and load averaged over layers.  With ``dist``, the
    batch is this rank's rows and ``ce`` their mean; the MoE metrics are
    already the means over every rank (``fmoe_apply``).  ``aux`` also holds
    ``load_layers``, the (L, E) stack of the layers' loads in logical
    order (the per-layer planner's input).  ``router_seed``: see
    :func:`forward`."""
    tokens = _inputs(params, batch["tokens"], device)
    logits, metrics, loads = forward(params, cfg, tokens, impl=impl,
                                     device=device, dist=dist,
                                     router_seed=router_seed, layer_loads=True)
    V = logits.shape[-1]
    ce = F.cross_entropy(logits[:, :-1].float().reshape(-1, V),
                         tokens[:, 1:].reshape(-1).long())
    loss = ce
    L = max(cfg.num_layers, 1)
    if cfg.moe is not None:
        loss = loss + (cfg.moe.balance_loss_weight * metrics.aux_loss
                       + cfg.moe.z_loss_weight * metrics.z_loss) / L
    aux = {"ce": ce, "aux_loss": metrics.aux_loss, "z_loss": metrics.z_loss,
           "drop_frac": metrics.drop_frac / L, "load": metrics.load / L,
           "load_layers": loads}
    aux.update(obs_aux(metrics, L, logits.device))
    return loss, aux


COUNTER_KEYS = ("wire_elems", "wire_bytes", "wire_bytes_intra",
                "wire_bytes_inter", "dropped", "shadow_hits", "imbalance")


def obs_aux(metrics: MoEMetrics, L: int, device) -> dict:
    """The telemetry counters (``repro_torch.obs.counters``) summed over the
    layers as 0-d f32 tensors on ``device``, ``imbalance`` averaged over
    them: the keys :func:`loss_fn` adds to its aux and the serving
    metrics carry, as the reference packs them.  They ride the metrics to
    the host with the loss; computing them syncs nothing."""
    if metrics.obs is None:
        return {}
    obs = metrics.obs.tensors(device)
    return {k: getattr(obs, k) / L if k == "imbalance" else getattr(obs, k)
            for k in COUNTER_KEYS}


def prefill(params: dict, cfg: ModelConfig, tokens, cache: list, *,
            impl: str = "einsum", device="cuda", dist=None):
    """tokens (B, S) + empty cache -> (logits (B, S, V), filled cache,
    metrics).  Decoding then continues at position S with decode_step.
    ``dist``: the MoE layers' ``DistConfig`` (serving takes the psum mode,
    ``launch.serve.decode_dist``), a per-layer placement on it split into
    the layers' tables as in :func:`forward`."""
    tokens = _inputs(params, tokens, device)
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    dist, tables = _layer_tables(cfg, dist, x.device)
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    new_cache = []
    for layer, (p_l, window, c_l) in enumerate(zip(
            params["layers"], B.layer_windows(cfg), cache)):
        x, c_l, m = B.layer_apply_prefill(
            cast_params(p_l, dtype), cfg, x, c_l, window=window, impl=impl,
            dist=dist, l2p=None if tables is None else tables[layer])
        new_cache.append(c_l)
        metrics = _accumulate(metrics, m)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x), new_cache, metrics


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device="cuda") -> list:
    """One ring-buffer cache per layer (KVCache; MLACache of latents for
    MLA), in ``cfg.dtype``."""
    dev = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    return [B.layer_cache(cfg, batch, cache_len, dtype, device=dev)
            for _ in range(cfg.num_layers)]


def supports_paged(cfg: ModelConfig) -> bool:
    """Whether the config's decode cache pages: every family the port
    serves (dense and moe, GQA or MLA) does."""
    return cfg.attention is not None and cfg.family in ("dense", "moe")


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device="cuda") -> list:
    """One block pool per layer (PagedKVCache; PagedMLACache for MLA), in
    ``cfg.dtype``, shared by every decode slot through the block tables
    given to ``decode_step(block_tables=...)``.  Rows 0 and 1 are the
    reserved null and scratch blocks (``models/attention``)."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV cache is not supported for family {cfg.family!r}")
    dev = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    return [B.layer_paged_cache(cfg, num_blocks, block_size, dtype, device=dev)
            for _ in range(cfg.num_layers)]


def decode_step(params: dict, cfg: ModelConfig, tokens, pos, cache: list, *,
                impl: str = "einsum", device="cuda", dist=None,
                block_tables=None, layer_loads: bool = False):
    """tokens (B, 1) at absolute position ``pos`` (scalar or (B,)) ->
    (logits (B, 1, V), cache updated in place, metrics), and with
    ``layer_loads`` the (L, E) stack of the layers' loads (logical expert
    order) as a fourth output: the serve-time replan's feed, as
    :func:`forward`'s.

    ``dist``: the MoE layers' ``DistConfig`` (serving takes the psum mode,
    ``launch.serve.decode_dist``; a per-layer placement on it is split
    into the layers' tables).  ``block_tables`` (B, nb) reads and writes
    the cache as the paged block pools of ``init_paged_cache`` instead of
    per-slot rings."""
    tokens = _inputs(params, tokens, device)
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype)
    dist, tables = _layer_tables(cfg, dist, x.device)
    cache_len = cache[0].positions.shape[-1]
    if block_tables is not None:
        cache_len *= block_tables.shape[1]  # the view: table width x block
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    new_cache, loads = [], []
    for layer, (p_l, window, c_l) in enumerate(zip(
            params["layers"], B.layer_windows(cfg), cache)):
        x, c_l, m = B.layer_apply_decode(
            cast_params(p_l, dtype), cfg, x, c_l, pos,
            window=min(window, cache_len), impl=impl, dist=dist,
            block_tables=block_tables,
            l2p=None if tables is None else tables[layer])
        new_cache.append(c_l)
        metrics = _accumulate(metrics, m)
        if m is not None:
            loads.append(m.load)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = _logits(params, cfg, x)
    if not layer_loads:
        return logits, new_cache, metrics
    if not loads:
        return logits, new_cache, metrics, x.new_zeros(
            cfg.num_layers, _n_experts(cfg), dtype=torch.float32)
    return logits, new_cache, metrics, torch.stack(loads)
