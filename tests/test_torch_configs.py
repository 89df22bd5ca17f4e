"""The five architectures the port registered with the routing zoo —
``switch-base-128`` (top-1, topk_softmax, no renormalize, rmsnorm, GELU),
``arctic-480b`` (the dense residual FFN beside 128 experts),
``granite-3-2b`` and ``smollm-360m`` (tied embeddings; smollm's 15 query
heads over 5 kv heads, a GQA group of 3) and ``qwen2-72b`` (QKV bias, rope
theta 1e6) — against the JAX package at reduced size: the config copied
field for field, prefill and decode logits, greedy tokens, and the step-0
loss and gradients.

``reduced`` rounds smollm's heads to 4/4, so its GQA group of 3 is held
on a hand-made small variant (6 query heads over 2); granite keeps an odd
vocabulary (515, as 49155 is odd).  The QKV biases are zeros at init in
both packages, so they are drawn at random here before the params move
across.  Tolerances: logits rtol/atol 1e-4, gradients 1e-4 of each leaf's
largest magnitude (f32 reassociation between the packages).  The port
runs its kernel paths (their plain versions on the CPU), the JAX side its
einsum path, the same function.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import ARCHS, get_config, reduced  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402

NEW = ("switch-base-128", "arctic-480b", "granite-3-2b", "smollm-360m",
       "qwen2-72b")
TOL = dict(rtol=1e-4, atol=1e-4)
B, S, GEN, CACHE = 2, 8, 4, 16
# (dispatch, impl) of the MoE configs' logits; the dense ones have none
MOE_RUNS = (("ragged", "fused"), ("capacity", "pallas"))


def _small(name, get, red):
    """The reduced config of ``name`` from a package's (get_config,
    reduced), with the variants the module docstring names."""
    cfg = red(get(name), num_layers=2, d_model=96)
    if name == "smollm-360m":
        cfg = dataclasses.replace(cfg, attention=dataclasses.replace(
            cfg.attention, num_heads=6, num_kv_heads=2, head_dim=16))
    if name == "granite-3-2b":
        cfg = dataclasses.replace(cfg, vocab_size=515)
    return cfg


def _cfgs(name, dispatch="ragged"):
    jcfg, tcfg = (_small(name, jget_config, jreduced),
                  _small(name, get_config, reduced))
    if jcfg.moe is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dispatch=dispatch)) for c in (jcfg, tcfg))
    return jcfg, tcfg


def _with_random_biases(tree, rng):
    """QKV biases drawn at random (both packages init them at zero)."""
    if isinstance(tree, dict):
        return {k: (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                    if k == "b" else _with_random_biases(v, rng))
                for k, v in tree.items()}
    return tree


@pytest.fixture(scope="module", params=NEW)
def model(request):
    name = request.param
    jcfg, _ = _cfgs(name)
    jp = jax.tree.map(lambda a: np.array(a),
                      jlm.init_params(jax.random.PRNGKey(0), jcfg))
    return name, _with_random_biases(jp, np.random.default_rng(1))


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# the other families (slice 17), whose serving and training parity is in
# tests/test_torch_families.py
FAMILIES = ("rwkv6-7b", "hymba-1.5b", "whisper-tiny", "internvl2-76b")


@pytest.mark.parametrize("name", NEW + FAMILIES)
def test_config_copy_matches_jax(name):
    assert name in ARCHS
    assert (dataclasses.asdict(get_config(name))
            == dataclasses.asdict(jget_config(name)))
    jcfg, tcfg = _cfgs(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_the_features_each_config_exercises():
    """What each config is here for, on the full configs."""
    sw, ar, gr, sm, qw = (get_config(n) for n in NEW)
    assert (sw.moe.top_k, sw.moe.gate_policy, sw.moe.renormalize,
            sw.norm, sw.act) == (1, "topk_softmax", False, "rmsnorm", "gelu")
    assert ar.moe.dense_residual and ar.d_ff == ar.moe.d_expert_hidden == 4864
    assert (ar.attention.num_heads, ar.attention.num_kv_heads) == (56, 8)
    assert gr.tie_embeddings and gr.vocab_size == 49155
    assert sm.tie_embeddings and (sm.attention.num_heads,
                                  sm.attention.num_kv_heads) == (15, 5)
    assert qw.attention.qkv_bias and qw.attention.rope_theta == 1e6
    small = _cfgs("smollm-360m")[1].attention
    assert small.num_heads // small.num_kv_heads == 3


def _logits_case(name, jp, dispatch, impl):
    jcfg, tcfg = _cfgs(name, dispatch)
    tparams = interop.from_jax(jp, tcfg, device="cpu")
    prompt = _tokens(tcfg.vocab_size, (B, S))
    jcache = jlm.init_cache(jcfg, B, CACHE)
    tcache = lm.init_cache(tcfg, B, CACHE, device="cpu")
    jlog, jcache, _ = jlm.prefill(jp, jcfg, jnp.asarray(prompt), jcache,
                                  impl="einsum")
    tlog, tcache, _ = lm.prefill(tparams, tcfg, torch.from_numpy(prompt),
                                 tcache, impl=impl, device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    for pos in range(S, S + GEN):
        jlog, jcache, _ = jlm.decode_step(jp, jcfg, jnp.asarray(tok),
                                          jnp.int32(pos), jcache,
                                          impl="einsum")
        tlog, tcache, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                         pos, tcache, impl=impl, device="cpu")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"{name} decode {pos}")
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)


def test_prefill_and_decode_logits_match_jax(model):
    """Prefill logits and GEN greedy decode steps' logits; the port's MoE
    configs through fused/ragged and pallas/capacity."""
    name, jp = model
    runs = MOE_RUNS if _cfgs(name)[1].moe is not None else (("ragged",
                                                             "einsum"),)
    for dispatch, impl in runs:
        _logits_case(name, jp, dispatch, impl)


def test_step0_grads_match_jax(model):
    """The step-0 loss, its aux and every gradient leaf (fused, ragged)
    against jax.value_and_grad of JAX's loss_fn."""
    name, jp = model
    jcfg, tcfg = _cfgs(name)
    tokens = _tokens(tcfg.vocab_size, (B, 2 * S), seed=2)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                              impl="einsum"), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    loss, aux, grads = train.loss_and_grads(
        interop.from_jax(jp, tcfg, device="cpu"), tcfg,
        {"tokens": torch.from_numpy(tokens)}, impl="fused", device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got = dict(jax.tree_util.tree_flatten_with_path(interop.to_jax(grads))[0])
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrads))[0]
    assert len(got) == len(ref)
    for path, b in ref:
        b = np.asarray(b)
        np.testing.assert_allclose(got[path], b, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(b).max()),
                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_arctic_dense_residual_matches_jax():
    """The dense residual FFN (``params["dense"]`` beside the experts,
    ``core/fmoe.py`` ``fmoe_apply``) of arctic's MoE layer: the layer
    against JAX's, and the port's layer is its routed part plus the dense
    FFN (its gradients are in the step-0 check above)."""
    jcfg, tcfg = _cfgs("arctic-480b")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(4),
                                                  jcfg))
    from repro.core import fmoe as jfmoe
    from repro_torch.core import fmoe as tfmoe
    p_j = jax.tree.map(lambda a: np.asarray(a)[0], jp["layers"]["ffn"])
    assert "dense" in p_j and "dense" in lm.init_params(
        tcfg, seed=0, device="cpu")["layers"][0]["ffn"]
    x = np.random.default_rng(3).standard_normal((B, S, tcfg.d_model)).astype(
        np.float32)
    jy, _ = jfmoe.fmoe_apply(p_j, jnp.asarray(x), jcfg.moe, act=jcfg.act)
    p_t = interop.from_jax(jp, tcfg, device="cpu")["layers"][0]["ffn"]
    ty, _ = tfmoe.fmoe_apply(p_t, torch.from_numpy(x), tcfg.moe, act=tcfg.act)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    no_dense = {k: v for k, v in p_t.items() if k != "dense"}
    ty0, _ = tfmoe.fmoe_apply(no_dense, torch.from_numpy(x), tcfg.moe,
                              act=tcfg.act)
    torch.testing.assert_close(
        ty, ty0 + tfmoe.dense_ffn(p_t["dense"], torch.from_numpy(x),
                                  tcfg.act), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["granite-3-2b", "smollm-360m"])
def test_tied_embeddings_have_no_head(name):
    """Tied embeddings (``models/lm.py`` ``_logits``): no lm_head leaf, in
    either package, and the logits are the final hidden state times the
    embedding table (held against JAX by the logits and gradient tests)."""
    jcfg, tcfg = _cfgs(name)
    params = lm.init_params(tcfg, seed=0, device="cpu")
    assert "lm_head" not in params
    assert "lm_head" not in jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = torch.from_numpy(_tokens(tcfg.vocab_size, (1, S)))
    logits, _ = lm.forward(params, tcfg, tokens, device="cpu")
    assert logits.shape == (1, S, tcfg.vocab_size)


@pytest.mark.parametrize("name", NEW)
def test_serve_and_train_cli(capsys, name):
    """serve and train --arch at --reduced on the CPU."""
    serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt_len", "8", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith(f"{name}-reduced on cpu")
    train.main(["--arch", name, "--reduced", "--device", "cpu", "--steps",
                "1", "--batch", "2", "--seq", "16", "--log_every", "1"])
    steps = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(steps) == 1 and np.isfinite(float(steps[0].split()[3]))
