"""Parity of the port's MLA (DeepSeek-V2 multi-head latent attention) and
of serving ``deepseek-v2-236b`` with the JAX package, at the reduced
config: d_model 256, 4 heads, dk 48 (32 nope + 16 rope), dv 32, kv_lora
64, q_lora 32 (and 0: the full-rank ``w_q``), 4 experts top-2 with one
shared expert, SwiGLU, RMSNorm, f32.

The JAX params move through ``interop.from_jax``; inputs are numpy from a
seed.  Tolerances:
* one MLA call (``mla_apply``, ``mla_decode``): rtol/atol 1e-5 — f32
  reassociation only (attention over <= 37 keys, the latent projections);
* the latent cache: equal (a copy);
* logits: rtol/atol 1e-4 (f32 reassociation compounded over two layers
  and the vocab projection, as ``test_torch_serve.py``);
* step-0 gradients per leaf: rtol 1e-4, atol 1e-4 x the leaf's largest
  magnitude (as ``test_torch_train.py``);
* greedy tokens: equal.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.attention as JA  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.blocks import FULL_WINDOW  # noqa: E402

ARCH = "deepseek-v2-236b"
CALL_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_REL = 1e-4
B, S, GEN, CACHE = 2, 12, 4, 24
Q_LORA = [32, 0]


def _cfg(get, red, q_lora=32, dispatch="capacity"):
    cfg = red(get(ARCH), num_layers=2, d_model=256)
    return dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, q_lora_rank=q_lora),
        moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


def _cfgs(q_lora=32, dispatch="capacity"):
    return (_cfg(jget_config, jreduced, q_lora, dispatch),
            _cfg(get_config, reduced, q_lora, dispatch))


@pytest.fixture(scope="module", params=Q_LORA, ids=lambda r: f"q_lora{r}")
def models(request):
    """(q_lora, JAX params as numpy) for the 2-layer reduced model."""
    jcfg, _ = _cfgs(request.param)
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    return request.param, jp


def _attn_params(q_lora: int, seed: int = 1):
    """One layer's MLA params from JAX's mla_init: (numpy tree, torch)."""
    jcfg, _ = _cfgs(q_lora)
    jp = jax.tree.map(np.asarray, JA.mla_init(jax.random.PRNGKey(seed),
                                              jcfg.d_model, jcfg.attention,
                                              jnp.float32))
    return jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_config_copy_matches_jax():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    for q_lora in Q_LORA:
        jcfg, tcfg = _cfgs(q_lora)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    a, m = _cfgs()[1].attention, _cfgs()[1].moe
    assert (a.kind, a.num_heads, a.num_kv_heads, a.kv_lora_rank, a.q_lora_rank) \
        == ("mla", 4, 4, 64, 32)
    assert (a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim) == (48, 32)
    assert (m.num_experts, m.top_k, m.num_shared_experts) == (4, 2, 1)
    assert (m.gate_policy, m.renormalize) == ("softmax_topk", True)


@pytest.mark.parametrize("q_lora", Q_LORA)
@pytest.mark.parametrize("window", [FULL_WINDOW, 8])
@pytest.mark.parametrize("return_kv", [False, True])
def test_mla_apply_matches_jax(q_lora, window, return_kv):
    """Prefill MLA, with and without the latents it returns for the cache,
    against ``repro.models.attention.mla_apply`` (S 37, so the jnp scan
    pads its last chunk)."""
    jcfg, tcfg = _cfgs(q_lora)
    jp, tp = _attn_params(q_lora)
    assert ("w_dq" in tp) == bool(q_lora) and ("w_q" in tp) == (not q_lora)
    assert tuple(tp["w_uk"].shape) == (4, 64, 32)
    x = _x((B, 37, 256), seed=2)
    want = JA.mla_apply(jp, jnp.asarray(x), jcfg.attention, window=window,
                        return_kv=return_kv)
    got = TA.mla_apply(tp, torch.from_numpy(x), tcfg.attention, window=window,
                       return_kv=return_kv)
    if not return_kv:
        want, got = (want, None), (got, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **CALL_TOL)
    if return_kv:
        for name, a, b in zip(("ckv", "kr"), got[1], want[1]):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **CALL_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("S_fill,start", [(10, 0), (37, 0), (20, 5)])
def test_fill_mla_cache_matches_jax(S_fill, start):
    """Latents into a 16-slot ring: S < W, and S > W, where only the last W
    positions survive (the ring tail), also from a start position."""
    _, tcfg = _cfgs()
    a = tcfg.attention
    ckv = _x((B, S_fill, a.kv_lora_rank), seed=3)
    kr = _x((B, S_fill, a.qk_rope_head_dim), seed=4)
    want = JA.fill_mla_cache(JA.mla_init_cache(B, 16, a, jnp.float32),
                             jnp.asarray(ckv), jnp.asarray(kr), start=start)
    got = TA.fill_mla_cache(TA.mla_init_cache(B, 16, a, torch.float32,
                                              device="cpu"),
                            torch.from_numpy(ckv), torch.from_numpy(kr),
                            start=start)
    for name, x, y in zip(("ckv", "kr", "positions"), got, want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y), err_msg=name)


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_mla_decode_matches_jax(q_lora):
    """Five absorbed-form decode steps after a 12-token prefill into a
    16-slot ring, with per-sequence positions (the second sequence two
    ahead, so its ring wraps): each step's output at 1e-5 and the cache
    it writes."""
    jcfg, tcfg = _cfgs(q_lora)
    a = tcfg.attention
    jp, tp = _attn_params(q_lora, seed=5)
    x = _x((B, S, 256), seed=6)
    _, (ckv, kr) = JA.mla_apply(jp, jnp.asarray(x), jcfg.attention,
                                window=FULL_WINDOW, return_kv=True)
    jcache = JA.fill_mla_cache(JA.mla_init_cache(B, 16, jcfg.attention, jnp.float32),
                               ckv, kr)
    tcache = TA.fill_mla_cache(TA.mla_init_cache(B, 16, a, torch.float32, device="cpu"),
                               torch.from_numpy(np.array(ckv)),
                               torch.from_numpy(np.array(kr)))
    for t in range(5):
        xt = _x((B, 1, 256), seed=10 + t)
        pos = np.array([S + t, S + 2 + t], np.int32)
        wy, jcache = JA.mla_decode(jp, jnp.asarray(xt), jcache, jnp.asarray(pos),
                                   jcfg.attention, window=FULL_WINDOW)
        ty, tcache = TA.mla_decode(tp, torch.from_numpy(xt), tcache,
                                   torch.from_numpy(pos), a, window=FULL_WINDOW)
        np.testing.assert_allclose(ty.numpy(), np.asarray(wy), **CALL_TOL,
                                   err_msg=f"step {t}")
        np.testing.assert_allclose(tcache.ckv.numpy(), np.asarray(jcache.ckv),
                                   **CALL_TOL)
        np.testing.assert_array_equal(tcache.positions.numpy(),
                                      np.asarray(jcache.positions))
    assert int(tcache.positions.max()) == S + 2 + 4  # the ring wrapped


@pytest.mark.parametrize("dispatch,impl", [("capacity", "einsum"),
                                           ("ragged", "fused")])
def test_prefill_and_decode_logits_match_jax(models, dispatch, impl):
    """A whole prefill's logits, then four decode steps', at 1e-4; the port
    runs its expert kernels' plain versions (``impl``), JAX its einsum."""
    q_lora, jparams = models
    jcfg, tcfg = _cfgs(q_lora, dispatch)
    tparams = interop.from_jax(jparams, tcfg, device="cpu")
    prompt = _tokens((B, S))
    jcache = jlm.init_cache(jcfg, B, CACHE)
    tcache = lm.init_cache(tcfg, B, CACHE, device="cpu")
    assert isinstance(tcache[0], TA.MLACache)
    jlog, jcache, _ = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    tlog, tcache, _ = lm.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache,
                                 impl=impl, device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    for pos in range(S, S + GEN):
        jlog, jcache, _ = jlm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                          jnp.int32(pos), jcache)
        tlog, tcache, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                         pos, tcache, impl=impl, device="cpu")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **LOGIT_TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("use_prefill", [True, False])
def test_generate_tokens_match_jax(models, use_prefill):
    """Greedy tokens equal to the JAX package's serve, by one prefill pass
    and by feeding the prompt token by token, both with ragged dispatch:
    JAX on its einsum experts, the port on its serving default, the fused
    kernel's path."""
    q_lora, jparams = models
    jcfg, tcfg = _cfgs(q_lora, "ragged")
    prompt = _tokens((B, S), seed=1)
    ref = jserve.generate(jparams, jcfg, jnp.asarray(prompt), GEN,
                          cache_len=CACHE, use_prefill=use_prefill)
    got = serve.generate(interop.from_jax(jparams, tcfg, device="cpu"), tcfg,
                         torch.from_numpy(prompt), GEN, cache_len=CACHE,
                         impl="fused", use_prefill=use_prefill, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_step0_grads_match_jax(models, dispatch):
    """The step-0 loss, its aux terms and the gradient of every leaf (MLA's
    latent and per-head projections, the shared and routed experts, the
    router) against ``jax.grad``; the attention's backward is the flash
    op's plain path with dv != dk."""
    q_lora, jparams = models
    jcfg, tcfg = _cfgs(q_lora, dispatch)
    tokens = _tokens((B, 16), seed=2)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    loss, aux, grads = train.loss_and_grads(
        interop.from_jax(jparams, tcfg, device="cpu"), tcfg,
        {"tokens": torch.from_numpy(tokens)}, impl="einsum", device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux_loss", "z_loss"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    flat_got = jax.tree_util.tree_flatten_with_path(interop.to_jax(grads))[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(jgrads)[0])
    assert len(flat_got) == len(flat_ref)
    names = {jax.tree_util.keystr(p) for p, _ in flat_got}
    assert any("w_uk" in n for n in names) and any("shared" in n for n in names)
    for path, a in flat_got:
        b = np.asarray(flat_ref[path])
        np.testing.assert_allclose(a, b, rtol=GRAD_REL,
                                   atol=GRAD_REL * float(np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))


def test_interop_round_trip(models):
    """The MLA leaves and the shared FFN cross both ways unchanged."""
    q_lora, jparams = models
    _, tcfg = _cfgs(q_lora)
    tparams = interop.from_jax(jparams, tcfg, device="cpu")
    attn = tparams["layers"][0]["attn"]
    assert tuple(attn["w_uv"].shape) == (4, 64, 32)
    assert "shared" in tparams["layers"][0]["ffn"]
    jax.tree.map(np.testing.assert_array_equal, interop.to_jax(tparams), jparams)


def test_serve_cli_deepseek_reduced(capsys):
    """``python -m repro_torch.launch.serve --arch deepseek-v2-236b
    --reduced --device cpu``: greedy tokens of the reduced 4-layer model."""
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                "--prompt_len", "16", "--gen", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{ARCH}-reduced on cpu: prefill 2x16")
    assert len(json.loads(out[1])) == 16 + 4
