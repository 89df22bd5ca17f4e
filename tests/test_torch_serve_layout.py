"""Serving under the reference's layouts: the tensor-parallel layer
compositions of the port against the JAX package, in one process.

A serving rank of a ``1xM`` mesh holds its block of every leaf under the
layout (``launch.sharding.make_layout``, the serve-mode specs) and computes
GQA attention on its heads, the dense and shared-expert FFNs on its
columns, the lookup and the head on its vocab rows: a local part each
(``models.blocks.attn_part_prefill`` / ``attn_part_decode``,
``core.fmoe.dense_ffn`` on the shards, ``models.layers.embed_part``, the
head's slice), which the mesh sums (or, the head, gathers) over
``model``.  Here the M ranks' parts are computed in turn on the CPU at
reduced widths with f32 params (reduced qwen2-72b at d 128 with 8 query
and 4 kv heads of 16, so a rank of M = 4 holds 2 query heads over 1 kv
head, the GQA group of 2 unchanged), summed in rank order, and held to
the JAX package's whole layer (``repro.models.attention`` / ``layers`` /
``lm``, ``repro.core.fmoe.dense_ffn``) on the same numpy inputs: within
1e-5 a layer and 1e-4 on the logits, for M in {2, 4}.  Also: the use
rule (which splits a leaf's use gathers) on the reference's train- and
serve-mode specs, the split that does not fall on a head boundary among
them; and the cache bytes a rank holds against ``cache_specs``'.  The
gloo runs of whole models ride ``tests/test_torch_ep.py``'s spawns.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core.fmoe import dense_ffn  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402

MPS = (2, 4)
LAYER_TOL, LOGIT_TOL = 1e-5, 1e-4
BATCH, SEQ, RING = 2, 12, 16
FULL = B.FULL_WINDOW


def _cfg(package, arch="qwen2-72b", **attn):
    """Reduced ``arch`` of ``package`` (``repro_torch`` or ``repro``) at d
    128; qwen2-72b with 8 query and 4 kv heads of 16 (``attn`` overrides
    them)."""
    import importlib
    configs = importlib.import_module(f"{package}.configs")
    cfg = configs.reduced(configs.get_config(arch), num_layers=1, d_model=128)
    if arch == "qwen2-72b":
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, **{"num_heads": 8, "num_kv_heads": 4,
                              "head_dim": 16, **attn}))
    return cfg


@pytest.fixture(scope="module")
def models():
    """{arch: (port cfg, JAX cfg, JAX params, the port's whole params)}."""
    from repro.models import lm as jlm
    out = {}
    for i, arch in enumerate(("qwen2-72b", "smollm-360m", "deepseek-v2-236b")):
        jcfg = _cfg("repro", arch)
        jp = jlm.init_params(jax.random.PRNGKey(i), jcfg)
        np_tree = jax.tree.map(np.asarray, jp)
        cfg = _cfg("repro_torch", arch)
        out[arch] = (cfg, jcfg, jp, interop.from_jax(np_tree, cfg,
                                                     device="cpu"))
    return out


def _ranks(cfg, whole, mp):
    """[(layout, shard)] of the M ranks of a 1xM mesh, serve-mode specs."""
    out = []
    for m in range(mp):
        layout = S.make_layout(cfg, Mesh(1, mp, m), "serve")
        out.append((layout, interop.shard_params(whole, layout)))
    return out


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _sum(parts):
    """The sum over model of the ranks' partials: f32, rank order."""
    out = parts[0].float().clone()
    for p in parts[1:]:
        out += p.float()
    return out


def _close(got, ref, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=tol,
                               atol=tol, err_msg=msg)


@pytest.mark.parametrize("mp", MPS)
def test_tensor_parallel_blocks_of_the_serve_layout(models, mp):
    """Under the serve-mode specs on 1xM every rank computes GQA attention,
    the FFN, the embedding and the head tensor-parallel, and holds its
    blocks: its heads' columns of wq, wk, wv (and their biases), its rows
    of wo, its FFN columns and vocab rows."""
    cfg, _, _, whole = models["qwen2-72b"]
    for layout, shard in _ranks(cfg, whole, mp):
        assert layout.tp == {"embed", "lm_head", "layers/0/attn",
                             "layers/0/ffn"}
        p = shard["layers"][0]
        assert p["attn"]["wq"]["w"].shape == (128, 8 * 16 // mp)
        assert p["attn"]["wk"]["w"].shape == (128, 4 * 16 // mp)
        assert p["attn"]["wk"]["b"].shape == (4 * 16 // mp,)
        assert p["attn"]["wo"]["w"].shape == (8 * 16 // mp, 128)
        assert p["ffn"]["wi_up"].shape == (128, cfg.d_ff // mp)
        assert shard["embed"]["table"].shape == (cfg.vocab_size // mp, 128)


@pytest.mark.parametrize("mp", MPS)
def test_attention_parts_sum_to_the_jax_layer(models, mp):
    """GQA prefill over a 12-token prompt into a 16-slot ring, then three
    ring decode steps: the sum of the M ranks' parts (each on its heads
    through ``attn_part_prefill`` / ``attn_part_decode``) equals JAX's
    ``gqa_apply`` / ``gqa_decode`` on the whole weights within 1e-5, and
    the ranks' rings, their kv heads side by side, are JAX's ring."""
    from repro.models import attention as JA
    cfg, jcfg, jp, whole = models["qwen2-72b"]
    jl = _layer0(jp)
    ranks = _ranks(cfg, whole, mp)
    x = _x((BATCH, SEQ, cfg.d_model), 1)
    jy, (jk, jv) = JA.gqa_apply(jl["attn"], jnp.asarray(x), jcfg.attention,
                                window=FULL, return_kv=True)
    jcache = JA.fill_kv_cache(JA.gqa_init_cache(BATCH, RING, jcfg.attention,
                                                jnp.float32), jk, jv)
    caches = [B.layer_cache(cfg, BATCH, RING, torch.float32, device="cpu",
                            tp=lm.tp_view(layout, "layers/0"))
              for layout, _ in ranks]
    parts = []
    for i, (_, shard) in enumerate(ranks):
        h, caches[i] = B.attn_part_prefill(shard["layers"][0], cfg,
                                           torch.from_numpy(x), caches[i],
                                           window=FULL)
        parts.append(h)
    _close(_sum(parts), jy, LAYER_TOL, "prefill")
    _close(torch.cat([c.k for c in caches], 2), jcache.k, LAYER_TOL, "ring k")
    for step in range(3):
        x1 = _x((BATCH, 1, cfg.d_model), 10 + step)
        jy, jcache = JA.gqa_decode(jl["attn"], jnp.asarray(x1), jcache,
                                   SEQ + step, jcfg.attention, window=FULL)
        parts = []
        for i, (_, shard) in enumerate(ranks):
            h, caches[i] = B.attn_part_decode(shard["layers"][0], cfg,
                                              torch.from_numpy(x1), caches[i],
                                              SEQ + step, window=FULL)
            parts.append(h)
        _close(_sum(parts), jy, LAYER_TOL, f"decode step {step}")


@pytest.mark.parametrize("mp", MPS)
def test_paged_decode_parts_sum_to_the_jax_layer(models, mp):
    """Paged decode (2 slots at their own positions, blocks of 4 rows):
    five steps, each the sum of the ranks' parts against a pool of their
    kv heads equal to JAX's ``gqa_decode_paged`` on the whole pool within
    1e-5."""
    from repro.models import attention as JA
    cfg, jcfg, jp, whole = models["qwen2-72b"]
    jl = _layer0(jp)
    ranks = _ranks(cfg, whole, mp)
    blocks, bs = 8, 4
    tables = np.array([[2, 3, 0], [4, 5, 6]], np.int32)
    jpool = JA.gqa_init_paged(blocks, bs, jcfg.attention, jnp.float32)
    pools = [B.layer_paged_cache(cfg, blocks, bs, torch.float32, device="cpu",
                                 tp=lm.tp_view(layout, "layers/0"))
             for layout, _ in ranks]
    for step in range(5):
        pos = np.array([step, 3 + step], np.int32)
        x1 = _x((2, 1, cfg.d_model), 20 + step)
        jy, jpool = JA.gqa_decode_paged(jl["attn"], jnp.asarray(x1), jpool,
                                        jnp.asarray(tables), jnp.asarray(pos),
                                        jcfg.attention, window=FULL)
        parts = []
        for i, (_, shard) in enumerate(ranks):
            h, pools[i] = B.attn_part_decode(
                shard["layers"][0], cfg, torch.from_numpy(x1), pools[i],
                torch.from_numpy(pos).long(), window=FULL,
                block_tables=torch.from_numpy(tables).long())
            parts.append(h)
        _close(_sum(parts), jy, LAYER_TOL, f"paged step {step}")


@pytest.mark.parametrize("mp", MPS)
def test_ffn_parts_sum_to_the_jax_layer(models, mp):
    """The dense SwiGLU FFN (qwen2-72b) and a shared expert (deepseek-v2,
    whose MLA stays gathered): the sum of the ranks' column-parallel
    ``wi*`` / row-parallel ``wo`` parts equals JAX's ``dense_ffn`` on the
    whole weights within 1e-5."""
    from repro.core.fmoe import dense_ffn as jdense
    for arch, path in (("qwen2-72b", ("ffn",)),
                       ("deepseek-v2-236b", ("ffn", "shared"))):
        cfg, jcfg, jp, whole = models[arch]
        ranks = _ranks(cfg, whole, mp)
        block = "layers/0/" + "/".join(path)
        assert all(block in layout.tp for layout, _ in ranks), arch
        jw = _layer0(jp)
        for k in path:
            jw = jw[k]
        x = _x((BATCH, SEQ, cfg.d_model), 2)
        parts = []
        for _, shard in ranks:
            w = shard["layers"][0]
            for k in path:
                w = w[k]
            parts.append(dense_ffn(w, torch.from_numpy(x), cfg.act))
        _close(_sum(parts), jdense(jw, jnp.asarray(x), jcfg.act), LAYER_TOL,
               arch)


@pytest.mark.parametrize("mp", MPS)
def test_vocab_parallel_lookup_and_head(models, mp):
    """The lookup: each rank's rows of the ids in its vocab block, zeros for
    the rest, summed over model, equal JAX's ``embed_lookup`` exactly (one
    part is nonzero).  The head: the ranks' logits slices, joined in rank
    order, equal JAX's logits within 1e-4 — an untied head (qwen2-72b's
    ``lm_head``) and a tied one (smollm-360m's table)."""
    from repro.models import layers as JL
    from repro.models import lm as jlm
    for arch in ("qwen2-72b", "smollm-360m"):
        cfg, jcfg, jp, whole = models[arch]
        ranks = _ranks(cfg, whole, mp)
        tokens = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int64)
        parts = [L.embed_part(shard["embed"]["table"],
                              torch.from_numpy(tokens), m)
                 for m, (_, shard) in enumerate(ranks)]
        want = JL.embed_lookup(jp["embed"], jnp.asarray(tokens), jnp.float32)
        np.testing.assert_array_equal(_sum(parts).numpy(), np.asarray(want))
        x = _x((BATCH, SEQ, cfg.d_model), 4)
        xt = torch.from_numpy(x)
        if cfg.tie_embeddings:
            local = [xt @ shard["embed"]["table"].T for _, shard in ranks]
        else:
            local = [L.linear(shard["lm_head"], xt) for _, shard in ranks]
        _close(torch.cat(local, -1), jlm._logits(jp, jcfg, jnp.asarray(x)),
               LOGIT_TOL, arch)


def _gathers(layout, path, serve):
    return [(d, axes) for d, axes in layout.gather_dims(path, serve)]


def test_use_rule_on_the_reference_specs():
    """``Layout.gather_dims``: training gathers every split; serving keeps
    the model split of a tensor-parallel block's leaf and gathers its FSDP
    split over data (train-mode specs) — attention, FFN, table and head —
    while MLA's up-projections, RWKV6's and Mamba's projections keep
    gathering theirs, and the routed experts keep their expert dim
    (gathering their hidden dim over data under the train-mode specs
    only)."""
    m22 = Mesh(2, 2, 0)
    qwen = _cfg("repro_torch")
    train = S.make_layout(qwen, m22, "train")
    serve = S.make_layout(qwen, m22, "serve")
    D, M = ("data",), ("model",)
    for path, tdim, mdim in (("layers/0/attn/wq/w", 0, 1),
                             ("layers/0/attn/wo/w", 1, 0),
                             ("layers/0/ffn/wi_gate", 0, 1),
                             ("layers/0/ffn/wo", 1, 0),
                             ("embed/table", 1, 0), ("lm_head/w", 0, 1)):
        assert _gathers(train, path, False) == sorted(
            [(tdim, D), (mdim, M)]), path
        assert _gathers(train, path, True) == [(tdim, D)], path
        assert _gathers(serve, path, True) == [], path
        assert _gathers(serve, path, False) == [(mdim, M)], path
    assert _gathers(train, "layers/0/attn/wq/b", True) == []
    assert _gathers(train, "layers/0/norm1/scale", True) == []
    ds = _cfg("repro_torch", "deepseek-v2-236b")
    for mode in ("train", "serve"):
        lay = S.make_layout(ds, m22, mode)
        assert "layers/0/attn" not in lay.tp and "layers/0/ffn/shared" in lay.tp
        assert (0, M) in _gathers(lay, "layers/0/attn/w_uk", True)
        assert (1, M) in _gathers(lay, "layers/0/attn/w_uq/w", True)
        assert (0, M) in _gathers(lay, "layers/0/attn/wo/w", True)
        hidden = [(2, D)] if mode == "train" else []
        assert _gathers(lay, "layers/0/ffn/experts/wi_gate", True) == hidden
    for arch, path in (("rwkv6-7b", "layers/0/rwkv/wr/w"),
                       ("hymba-1.5b", "layers/0/mamba/in_proj/w")):
        lay = S.make_layout(_cfg("repro_torch", arch), m22, "serve")
        assert (1, M) in _gathers(lay, path, True), arch


def test_split_off_a_head_boundary_is_gathered():
    """6 heads of 16 on a model axis of 4: the specs split the 96-wide
    projections (96 % 4 == 0), but not on a head boundary, so attention is
    not tensor-parallel and serving gathers those splits (the FFN stays
    tensor-parallel); the head-aware rules replicate them instead."""
    cfg = _cfg("repro_torch", num_heads=6, num_kv_heads=6, head_dim=16)
    mesh = Mesh(1, 4, 1)
    lay = S.make_layout(cfg, mesh, "serve")
    assert lay.spec("layers/0/attn/wq/w") == (None, "model")
    assert "layers/0/attn" not in lay.tp and "layers/0/ffn" in lay.tp
    assert _gathers(lay, "layers/0/attn/wq/w", True) == [(1, ("model",))]
    assert _gathers(lay, "layers/0/attn/wo/w", True) == [(0, ("model",))]
    aware = S.make_layout(cfg, mesh, "serve", head_aware=True)
    assert aware.spec("layers/0/attn/wq/w") == (None, None)
    assert _gathers(aware, "layers/0/attn/wq/w", True) == []


def test_serve_layout_tiny_batch_policy():
    """As the reference's jit_serve_step: a dense config's batch below the
    model axis drops serve_tp (the train-mode specs, FSDP over data); an
    MoE config keeps it."""
    mesh = Mesh(2, 4, 0)
    dense = _cfg("repro_torch")
    assert S.serve_layout(dense, mesh, 8, {"serve_tp": True}).spec(
        "layers/0/ffn/wo") == ("model", None)
    assert S.serve_layout(dense, mesh, 2, {"serve_tp": True}).spec(
        "layers/0/ffn/wo") == ("model", "data")
    moe = _cfg("repro_torch", "fastmoe-gpt")
    assert S.serve_layout(moe, mesh, 2, {"serve_tp": True}).spec(
        "layers/0/attn/wo/w") == ("model", None)


@pytest.mark.parametrize("mp", MPS)
def test_rank_cache_bytes_equal_cache_specs(models, mp):
    """Where attention is tensor-parallel a rank's ring and paged pool hold
    its KV heads; the reference's ``cache_specs`` splits the trailing
    head_dim over model instead.  Both split here, and a rank holds the
    same bytes either way."""
    cfg, _, _, whole = models["qwen2-72b"]
    (layout, _), = _ranks(cfg, whole, mp)[:1]
    mesh = S.ShapeMesh.of(data=1, model=mp)

    def spec_bytes(tree, specs):
        return sum(math.prod(S.shard_shape(t.shape, sp, mesh))
                   * t.element_size() for (_, t), (_, sp) in
                   zip(S.flat_paths(tree), S.flat_paths(specs)))

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for _, t in S.flat_paths(tree))
    whole_ring = lm.init_cache(cfg, BATCH, RING, device="cpu")
    rank_ring = lm.init_cache(cfg, BATCH, RING, device="cpu", layout=layout)
    assert rank_ring[0].k.shape == (BATCH, RING, 4 // mp, 16)
    assert nbytes(rank_ring) == spec_bytes(
        whole_ring, S.cache_specs(whole_ring, mesh, BATCH))
    whole_pool = lm.init_paged_cache(cfg, 6, 4, device="cpu")
    rank_pool = lm.init_paged_cache(cfg, 6, 4, device="cpu", layout=layout)
    assert nbytes(rank_pool) == spec_bytes(
        whole_pool, S.cache_specs(whole_pool, mesh, BATCH, paged=True))
    assert nbytes(rank_pool) < nbytes(whole_pool)
