"""The language model assembled from a config: every family of the JAX
package (dense and moe with GQA or MLA attention, ssm (rwkv6), hybrid
(hymba), audio (whisper: an encoder and a cross-attending decoder) and
vlm (internvl2: patch embeddings prepended to the text)).

Public API:
  init_params(cfg, seed=, device=, param_dtype=, layout=)  -> params
  encode(params, cfg, frames)                      -> encoder output (audio)
  forward(params, cfg, tokens, impl=, device=, dist=, router_seed=,
          layer_loads=, frames=, patches=)         -> (logits, MoEMetrics[,
                                                       (L, E) loads])
  loss_fn(params, cfg, batch, impl=, device=, dist=, router_seed=)
                                                   -> (loss, aux dict)
  prefill(params, cfg, tokens, cache, ..., frames=, patches=)
                                                   -> (logits, cache, metrics)
  init_cache(cfg, batch, cache_len, device=, enc_out=, layout=)
                                                   -> list of per-layer caches
  init_paged_cache(cfg, num_blocks, block_size, device=, layout=)
                                                   -> list of pools
  decode_step(params, cfg, tokens, pos, cache,..., layer_loads=)
                                                   -> (logits, cache, metrics[,
                                                       (L, E) loads])

Params mirror the JAX tree, except that ``params["layers"]`` (and the
audio encoder's ``params["enc_layers"]``) is a list of per-layer dicts
(JAX stacks them on a leading L dim and scans; here a Python loop runs
the layers).  The stubbed frontends are inputs, as in the reference:
whisper's frame embeddings (B, F, d) go through ``encode`` and every
decoder layer cross-attends to them; internvl2's patch embeddings (B, P,
d) are prepended to the token embeddings, the logits cover both, and the
loss reads the text positions only.  Numerics: JAX keeps f32 master params, casts the
*layer* params to ``cfg.dtype`` at every use and keeps ``embed``,
``final_norm`` and ``lm_head`` in f32, with f32 logits.  The port does the
same — every forward casts the layer params at use, so gradients reach f32
leaves through the cast — and for serving makes or loads the layers
already in ``cfg.dtype`` (``init_params`` default), where that cast is a
no-op.  ``cfg.remat == "full"`` recomputes each layer in the backward
(``torch.utils.checkpoint``), as the reference's ``jax.remat`` does; the
cast sits inside the recomputed region, so no bf16 copy of the weights
outlives its layer.  The decode cache is updated in place (the attention rings); the recurrent
states of the ssm and hybrid families are new tensors each step.

With ``dist`` (a ``core.fmoe.DistConfig`` over a mesh) ``forward`` and
``loss_fn`` run this rank's batch rows, and every MoE layer exchanges its
tokens with the other ranks; under remat each layer's exchange runs again
in the backward, on every rank in the same order.  ``prefill`` and
``decode_step`` take the psum mode (serving): every rank holds all of the
tokens and computes its own experts, and the layer sums over the ranks.

Serving on a mesh holds the params in a ``launch.sharding`` layout (the
reference's train- or serve-mode specs, ``launch.sharding.serve_layout``)
carried by ``dist.layout``; ``prefill`` and ``decode_step`` take each
layer's params through :func:`use_params` with ``serve=True``: FSDP
splits gathered, the model splits of the tensor-parallel blocks kept
local (GQA attention, the dense and shared FFNs, the vocab-parallel
embedding and head: ``models.layers.TP``), every other split gathered.
Their caches (``init_cache(layout=)``) hold a rank's own KV heads where
attention is tensor-parallel.

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
from repro_torch.core import comm
from repro_torch.core import dispatch as D
from repro_torch.core.balance import MoEMetrics
from repro_torch.core.fmoe import dense_ffn, expert_seed
from repro_torch.device import resolve
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.layers import (NO_TP, TP, apply_norm, embed_init,
                                       embed_lookup, linear, linear_init,
                                       norm_init, unembed)
from repro_torch.placement.plan import PerLayerPlacement


def cast_params(p, dtype):
    """Cast every floating tensor of a param tree to ``dtype``."""
    if isinstance(p, dict):
        return {k: cast_params(v, dtype) for k, v in p.items()}
    return p.to(dtype) if p.is_floating_point() else p


def use_params(p, dtype, dist, prefix: str, serve: bool = False):
    """The params of one use (a layer, the embedding, the head) as the
    computation takes them: without a layout, ``p`` cast to ``dtype``
    (None: as it is); under a layout (``dist.layout``) each leaf's shard
    cast, then all-gathered over the axes of the splits its use gathers
    (``launch.sharding.Layout.gather_dims``: training every split;
    ``serve`` keeps the model splits of the tensor-parallel blocks) by
    ``core.comm.gather_shard``.  The routed expert stacks stay shards
    (expert parallelism); under ``fsdp_axis`` they pass uncast, since the
    MoE layer casts and gathers their hidden dim itself.  ``prefix``: the
    tree path of ``p`` (``layers/3``), which names each leaf's spec."""
    layout = None if dist is None else dist.layout
    if layout is None:
        return p if dtype is None else cast_params(p, dtype)
    fsdp = bool(dist.fsdp_axis) and not dist.tp_axis

    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, f"{path}/{k}") for k, v in t.items()}
        if not t.is_floating_point():
            return t
        if "experts" in path.split("/"):
            return t if fsdp or dtype is None else t.to(dtype)
        return comm.gather_shard(t, layout.gather_dims(path, serve),
                                 layout.mesh, dtype)
    return go(p, prefix)


def tp_view(layout, prefix: str) -> TP:
    """The ``models.layers.TP`` of the use at ``prefix`` (``layers/3``;
    ``""`` the embedding and head) under ``layout``: the blocks serving
    computes tensor-parallel there.  ``NO_TP`` without a layout."""
    if layout is None:
        return NO_TP
    return TP(layout.mesh, layout.blocks_under(prefix))


def _tp(dist, prefix: str) -> TP:
    return tp_view(None if dist is None else dist.layout, prefix)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cuda",
                param_dtype: str | None = None, layout=None) -> dict:
    """Random params from ``seed`` (the JAX package's distributions and
    scales; torch generators, so not its numbers).  Layers are made one at
    a time, each weight drawn in f32 and stored in ``param_dtype`` (a routed
    expert as it is drawn, so a layer never exists whole in f32: one of
    arctic-480b's is ~54 GB so): by default ``cfg.dtype``, the serving
    layout; training passes ``cfg.param_dtype`` (f32 masters).

    Every leaf but the routed expert stacks comes from one generator seeded
    by ``seed``; expert ``e`` of leaf ``i`` of layer ``l``'s stacks from a
    generator seeded by (seed, l, i, e) alone.  So under ``layout`` (a
    ``launch.sharding.Layout`` over a mesh with a rank; shape and rank
    suffice, no process group) a rank makes only its shard: its experts
    one at a time (their hidden dim over ``data`` where the spec says so),
    every other leaf drawn whole, one at a time, and cut by its spec.  The
    result equals ``launch.sharding.shard_tree`` of the whole draw bit for
    bit; this is the only sharded draw (training's and serving's layouts
    alike)."""
    dev = resolve(device)
    # the meta device (the dry run) draws nothing: a CPU generator stands in
    gen = torch.Generator(device=dev if dev.type != "meta" else "cpu"
                          ).manual_seed(seed)
    dtype = getattr(torch, param_dtype or cfg.dtype)
    shard = (slice(None), slice(None))
    if layout is not None and cfg.moe is not None:
        shard = layout.mesh.expert_shard(
            cfg.moe.num_experts, cfg.moe.d_expert_hidden,
            tp="data" in layout.expert_hidden_axes())

    def cut(tree, path):  # a layer at a time: no whole layer outlives it
        return tree if layout is None else _cut(tree, layout, path)

    p = {
        "embed": cut(embed_init(gen, cfg.vocab_size, cfg.d_model, device=dev),
                     "embed"),
        "layers": [cut(cast_params(B.layer_init(
            gen, cfg, device=dev, dtype=dtype,
            expert_key=expert_seed(seed, layer), shard=shard,
            cross=cfg.family == "audio"), dtype), f"layers/{layer}")
            for layer in range(cfg.num_layers)],
        "final_norm": norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = cut(linear_init(gen, cfg.d_model, cfg.vocab_size,
                                       device=dev), "lm_head")
    if cfg.encoder is not None:
        L = cfg.num_layers
        p["enc_layers"] = [cut(cast_params(B.layer_init(
            gen, cfg, device=dev, dtype=dtype,
            expert_key=expert_seed(seed, L + layer), shard=shard), dtype),
            f"enc_layers/{layer}")
            for layer in range(cfg.encoder.num_layers)]
        p["enc_norm"] = norm_init(cfg.d_model, cfg.norm, device=dev)
    return p


def _cut(tree, layout, path: str):
    """Every leaf but the (already sharded) expert stacks cut to the
    layout's rank's block by its spec."""
    from repro_torch.launch.sharding import shard_leaf
    if isinstance(tree, dict):
        return {k: _cut(v, layout, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cut(v, layout, f"{path}/{i}") for i, v in enumerate(tree)]
    if "experts" in path.split("/"):
        return tree
    return shard_leaf(tree, layout.spec(path), layout.mesh, layout.mesh.rank)


def _inputs(params: dict, tokens, device) -> torch.Tensor:
    dev = resolve(device)
    where = params["embed"]["table"].device
    if where.type != dev.type:
        raise ValueError(f"params live on {where}, but device={dev}")
    return torch.as_tensor(tokens, device=where)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor,
            dist=None, serve: bool = False) -> torch.Tensor:
    """f32 logits (B, S, V); ``params["embed"]`` is the use's table (tied
    head).  ``serve``: a vocab-parallel head computes the rank's slice and
    gathers it over ``model``."""
    tp = _tp(dist, "") if serve else NO_TP
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, tp)
    return tp.gather(linear(use_params(params["lm_head"], None, dist,
                                       "lm_head", serve), x.float()),
                     "lm_head")


def _accumulate(metrics, m):
    return metrics if m is None else metrics + m


def _n_experts(cfg: ModelConfig) -> int:
    return cfg.moe.num_experts if cfg.moe is not None else 1


def _layer_seq(p_l: dict, cfg: ModelConfig, x: torch.Tensor, window: int,
               impl: str, dist, noise_seed=None, l2p=None, enc_out=None,
               state0=None, layer: int = 0):
    dtype = getattr(torch, cfg.dtype)
    p_l = use_params(p_l, dtype, dist, f"layers/{layer}")
    x, m = B.layer_apply_seq(p_l, cfg, x, window=window,
                             impl=impl, dist=dist, noise_seed=noise_seed,
                             l2p=l2p, enc_out=enc_out, mixer_state=state0)
    return x.to(dtype), m


def _enc_layer(p_l: dict, cfg: ModelConfig, x: torch.Tensor, dist=None,
               layer: int = 0, serve: bool = False) -> torch.Tensor:
    dtype = getattr(torch, cfg.dtype)
    prefix = f"enc_layers/{layer}"
    p_l = use_params(p_l, dtype, dist, prefix, serve)
    tp = _tp(dist, prefix) if serve else NO_TP
    h = A.gqa_apply(p_l["attn"], apply_norm(p_l["norm1"], x, cfg.norm),
                    cfg.attention, window=B.FULL_WINDOW, causal=False)
    x = x + tp.sum(h, "attn")
    h = dense_ffn(p_l["ffn"], apply_norm(p_l["norm2"], x, cfg.norm), cfg.act)
    return (x + tp.sum(h, "ffn")).to(dtype)


def encode(params: dict, cfg: ModelConfig, frames, dist=None,
           serve: bool = False) -> torch.Tensor:
    """frames (B, F, d_model): the stubbed conv frontend's embeddings ->
    the encoder output (B, F, d_model) in ``cfg.dtype``: the
    bidirectional stack (non-causal attention without RoPE, dense FFN)
    and its final norm.  Under remat each layer is recomputed in the
    backward, as :func:`forward`'s; under a layout (``dist``) each layer
    gathers its leaves inside that region (``serve``: as
    :func:`prefill` takes them, tensor-parallel blocks local)."""
    dtype = getattr(torch, cfg.dtype)
    x = torch.as_tensor(frames, device=params["embed"]["table"].device
                        ).to(dtype)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    for i, p_l in enumerate(params["enc_layers"]):
        x = (checkpoint(_enc_layer, p_l, cfg, x, dist, i, serve,
                        use_reentrant=False)
             if remat else _enc_layer(p_l, cfg, x, dist, i, serve))
    return apply_norm(params["enc_norm"], x, cfg.norm)


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
           patches, tp: TP = NO_TP) -> torch.Tensor:
    """Token embeddings in ``cfg.dtype`` (vocab-parallel where ``tp`` says
    so); vlm: the patch embeddings (B, P, d) in front of them."""
    dtype = getattr(torch, cfg.dtype)
    x = embed_lookup(params["embed"], tokens, dtype, tp)
    if cfg.frontend == "vision" and patches is not None:
        x = torch.cat([torch.as_tensor(patches, device=x.device).to(dtype),
                       x], dim=1)
    return x


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
            layer_loads: bool = False, frames=None, patches=None):
    """tokens (B, S) -> (logits (B, S', V) f32, MoEMetrics summed over
    layers), and with ``layer_loads`` the (L, E) stack of the layers' loads
    (logical expert order) as well.  vlm: ``patches`` (B, P, d) are
    prepended, S' = P + S; audio: ``frames`` (B, F, d) go through the
    encoder and every decoder layer cross-attends to its output.

    ``router_seed`` arms the exploration of the noisy_topk and gumbel
    routers: layer ``l`` draws its noise from ``expert_seed(router_seed,
    l)`` inside the layer, so the remat recompute draws the same (an
    integer, never a stateful generator, enters the checkpoint).  None
    routes deterministically, the eval and serving stance."""
    tokens = _inputs(params, tokens, device)
    if dist is not None and dist.layout is not None:
        # the train layout: the embedding gathered once, for the lookup
        # and (tied) the head
        params = {**params, "embed": use_params(params["embed"], None, dist,
                                                "embed")}
    x = _embed(params, cfg, tokens, patches)
    enc_out = (encode(params, cfg, frames, dist) if cfg.family == "audio"
               else None)
    state0 = B.mixer_state(cfg, x.shape[0], x.dtype, device=x.device)
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
                              seed, l2p, enc_out, state0, layer,
                              use_reentrant=False)
        else:
            x, m = _layer_seq(p_l, cfg, x, window, impl, dist, seed, l2p,
                              enc_out, state0, layer)
        metrics = _accumulate(metrics, m)
        if m is not None:
            loads.append(m.load.detach())
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = _logits(params, cfg, x, dist)
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
    {"tokens": (B, S)}, and "frames" (audio) or "patches" (vlm: the loss
    reads the text positions only).  Returns (loss, {ce, aux_loss, z_loss, drop_frac,
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
                                     router_seed=router_seed, layer_loads=True,
                                     frames=batch.get("frames"),
                                     patches=batch.get("patches"))
    if cfg.frontend == "vision" and batch.get("patches") is not None:
        logits = logits[:, batch["patches"].shape[1]:]  # text positions only
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
            impl: str = "einsum", device="cuda", dist=None, frames=None,
            patches=None):
    """tokens (B, S) + empty cache -> (logits (B, S', V), filled cache,
    metrics).  Decoding then continues at position S' with decode_step.
    vlm: ``patches`` (B, P, d) are prepended (S' = P + S); audio:
    ``frames`` (B, F, d) are encoded once and the output stored in every
    layer's cache for the cross-attention.
    ``dist``: the MoE layers' ``DistConfig`` (serving takes the psum mode,
    ``launch.serve.decode_dist``), a per-layer placement on it split into
    the layers' tables as in :func:`forward`."""
    tokens = _inputs(params, tokens, device)
    dtype = getattr(torch, cfg.dtype)
    params = _serve_ends(params, dist)
    x = _embed(params, cfg, tokens, patches, _tp(dist, ""))
    if cfg.family == "audio":
        enc_out = encode(params, cfg, frames, dist, serve=True).to(dtype)
        cache = [{**c, "enc_out": enc_out} for c in cache]
    dist, tables = _layer_tables(cfg, dist, x.device)
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    new_cache = []
    for layer, (p_l, window, c_l) in enumerate(zip(
            params["layers"], B.layer_windows(cfg), cache)):
        prefix = f"layers/{layer}"
        x, c_l, m = B.layer_apply_prefill(
            use_params(p_l, dtype, dist, prefix, serve=True), cfg, x, c_l,
            window=window, impl=impl, dist=dist,
            l2p=None if tables is None else tables[layer],
            tp=_tp(dist, prefix))
        new_cache.append(c_l)
        metrics = _accumulate(metrics, m)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, cfg, x, dist, serve=True), new_cache, metrics


def _serve_ends(params: dict, dist) -> dict:
    """``params`` with the embedding table as serving takes it (its FSDP
    split gathered; a vocab-parallel table kept local), used by the lookup
    and the tied head."""
    if dist is None or dist.layout is None:
        return params
    return {**params, "embed": use_params(params["embed"], None, dist,
                                          "embed", serve=True)}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, *,
               device="cuda", enc_out: torch.Tensor | None = None,
               layout=None) -> list:
    """One decode cache per layer, in ``cfg.dtype``: a ring (KVCache;
    MLACache of latents for MLA); ssm: an RWKVState; hybrid: a ring and
    a MambaState; audio: a ring and the encoder output ``enc_out`` (B, F,
    d), shared by the layers (zeros until ``prefill`` sets it).  Under a
    serving ``layout`` a ring holds the rank's KV heads where the layer's
    attention is tensor-parallel."""
    dev = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    return [B.layer_cache(cfg, batch, cache_len, dtype, device=dev,
                          enc_out=enc_out, tp=tp_view(layout, f"layers/{i}"))
            for i in range(cfg.num_layers)]


def check_tokens_only(cfg: ModelConfig) -> None:
    """Refuse the audio family where an entry point feeds tokens alone
    (``serve.generate`` and the serve and train CLIs, as the reference's):
    its decoder cross-attends to frame embeddings, the stubbed frontend's
    output, which only ``forward``, ``prefill`` and ``loss_fn(frames=...)``
    take."""
    if cfg.family == "audio":
        raise ValueError(
            f"{cfg.name}: the audio family needs the stubbed frontend's "
            f"frame embeddings (B, {cfg.encoder.num_frames}, {cfg.d_model}), "
            f"which have no CLI input; call lm.prefill / lm.forward / "
            f"lm.loss_fn with frames=...")


def supports_paged(cfg: ModelConfig) -> bool:
    """Whether the family's decode cache can be paged (plain attention
    rings; the recurrent, hybrid and audio caches cannot)."""
    return cfg.attention is not None and cfg.family not in B.NO_PAGED


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int, *,
                     device="cuda", layout=None) -> list:
    """One block pool per layer (PagedKVCache; PagedMLACache for MLA), in
    ``cfg.dtype``, shared by every decode slot through the block tables
    given to ``decode_step(block_tables=...)``.  Rows 0 and 1 are the
    reserved null and scratch blocks (``models/attention``).  ``layout``:
    as :func:`init_cache`'s."""
    if not supports_paged(cfg):
        raise NotImplementedError(
            f"paged KV cache is not supported for family {cfg.family!r}")
    dev = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    return [B.layer_paged_cache(cfg, num_blocks, block_size, dtype, device=dev,
                                tp=tp_view(layout, f"layers/{i}"))
            for i in range(cfg.num_layers)]


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
    params = _serve_ends(params, dist)
    x = embed_lookup(params["embed"], tokens, dtype, _tp(dist, ""))
    dist, tables = _layer_tables(cfg, dist, x.device)
    cache_len = _cache_len(cfg, cache, block_tables)
    metrics = MoEMetrics.zero(_n_experts(cfg), x.device)
    new_cache, loads = [], []
    for layer, (p_l, window, c_l) in enumerate(zip(
            params["layers"], B.layer_windows(cfg), cache)):
        prefix = f"layers/{layer}"
        x, c_l, m = B.layer_apply_decode(
            use_params(p_l, dtype, dist, prefix, serve=True), cfg, x, c_l,
            pos, window=min(window, cache_len) if cache_len else window,
            impl=impl, dist=dist, block_tables=block_tables,
            l2p=None if tables is None else tables[layer],
            tp=_tp(dist, prefix))
        new_cache.append(c_l)
        metrics = _accumulate(metrics, m)
        if m is not None:
            loads.append(m.load)
        x = x.to(dtype)
    x = apply_norm(params["final_norm"], x, cfg.norm)
    logits = _logits(params, cfg, x, dist, serve=True)
    if not layer_loads:
        return logits, new_cache, metrics
    if not loads:
        return logits, new_cache, metrics, x.new_zeros(
            cfg.num_layers, _n_experts(cfg), dtype=torch.float32)
    return logits, new_cache, metrics, torch.stack(loads)


def _cache_len(cfg: ModelConfig, cache: list, block_tables=None) -> int:
    """Ring length (0 for the ssm family's pure state).  With a paged pool
    the visible length is the gathered per-slot view: table width x block
    size."""
    if cfg.family == "ssm":
        return 0
    ring = cache[0]
    if cfg.family == "hybrid":
        ring = ring["attn"]
    elif cfg.family == "audio":
        ring = ring["self"]
    n = ring.positions.shape[-1]
    return n * block_tables.shape[1] if block_tables is not None else n
