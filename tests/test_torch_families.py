"""The other families of the port — rwkv6-7b (ssm: RWKV6 time and channel
mix), hymba-1.5b (hybrid: attention and a Mamba head in parallel),
whisper-tiny (audio: an encoder over stubbed frame embeddings and a
cross-attending decoder) and internvl2-76b (vlm: stubbed patch embeddings
prepended) — against the JAX package at reduced size on the CPU.

Per family, params made by the port's ``init_params`` in the tree, shapes
and dtypes JAX's ``init_params`` makes (held by ``jax.eval_shape``, so no
JAX init runs), moved to JAX by ``interop.to_jax`` and back through
``interop.from_jax``, inputs from a numpy seed: forward logits (rtol/atol 1e-4), prefill then
one decode step and token-by-token decoding from an empty cache (atol
2e-4, the reference's own tolerance in its prefill tests; internvl2's
token-by-token run feeds tokens alone, as decode does), and the step-0
loss and every gradient leaf (1e-4 of each leaf's largest magnitude),
internvl2's loss over the text positions only (``fmoefy`` and the
fmoefy'd rwkv6 and hymba are in ``tests/test_torch_fmoefy.py``).  The
continuous batcher's ring mode (the only one these caches have)
against static ``generate``; the serve and train CLIs on rwkv6, hymba and
internvl2, and their refusal of whisper (its frames have no CLI input).
The JAX side runs its einsum path; the port its kernel paths' plain
versions, the same function.
"""
import dataclasses
import functools

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
from repro_torch.launch.scheduler import ContinuousBatcher  # noqa: E402
from repro_torch.launch.serve_api import Request, ServeConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402

FAMILIES = ("rwkv6-7b", "hymba-1.5b", "whisper-tiny", "internvl2-76b")
TOKENS_ONLY = ("rwkv6-7b", "hymba-1.5b", "internvl2-76b")
B, S, CACHE = 2, 8, 32
TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_ATOL = 2e-4


def _cfgs(name):
    return jreduced(jget_config(name)), reduced(get_config(name))


def _extra(cfg, seed=1) -> dict:
    """The stubbed frontend's input: frames (audio) or patches (vlm)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (B, cfg.encoder.num_frames, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    return {}


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _params(jcfg, tcfg, seed=0) -> dict:
    """The port's params from ``seed`` as the JAX tree of numpy arrays,
    held to the tree, shapes and dtypes of JAX's own init."""
    jp = interop.to_jax(lm.init_params(tcfg, seed=seed, device="cpu"))
    want = jax.eval_shape(lambda k: jlm.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(want) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(jp)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    return jp


def _jax_decode(step, jp, toks, cache):
    """Token-by-token JAX logits (B, S, V) and the cache after them."""
    out = []
    for t in range(toks.shape[1]):
        lg, cache, _ = step(jp, tokens=jnp.asarray(toks[:, t:t + 1]),
                            pos=jnp.int32(t), cache=cache)
        out.append(np.asarray(lg[:, 0]))
    return np.stack(out, 1), cache


def _jit(fn, cfg):
    """``fn`` of the JAX package jitted with its config bound (a jitted
    call compiles in about half the time the eager one takes)."""
    return jax.jit(functools.partial(fn, cfg=cfg))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """The family's configs, JAX params (numpy) and inputs, and every JAX
    result the tests compare with, computed once."""
    name = request.param
    jcfg, tcfg = _cfgs(name)
    jp = _params(jcfg, tcfg)
    toks = _tokens(tcfg.vocab_size, (B, S))
    extra = _extra(tcfg)
    jx = {k: jnp.asarray(v) for k, v in extra.items()}
    ref = {"forward": np.asarray(_jit(jlm.forward, jcfg)(
        jp, tokens=jnp.asarray(toks), **jx)[0])}
    enc = (_jit(jlm.encode, jcfg)(jp, frames=jx["frames"])
           if "frames" in jx else None)
    lg, cache, _ = _jit(jlm.prefill, jcfg)(
        jp, tokens=jnp.asarray(toks),
        cache=jlm.init_cache(jcfg, B, CACHE, enc_out=enc), **jx)
    P = lg.shape[1]
    nxt = jnp.asarray(_tokens(tcfg.vocab_size, (B, 1), seed=3))
    step = _jit(jlm.decode_step, jcfg)
    ref["prefill"] = np.asarray(lg)
    ref["next"] = np.asarray(step(jp, tokens=nxt, pos=jnp.int32(P),
                                  cache=cache)[0])
    ref["steps"], cache = _jax_decode(
        step, jp, toks, jlm.init_cache(jcfg, B, CACHE, enc_out=enc))
    ref["steps_next"] = np.asarray(step(jp, tokens=nxt, pos=jnp.int32(S),
                                        cache=cache)[0])
    ltoks = _tokens(tcfg.vocab_size, (B, 2 * S), seed=2)
    (ref["loss"], ref["aux"]), ref["grads"] = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(ltoks), **jx},
                              impl="einsum"), has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    return dict(name=name, tcfg=tcfg, jp=jp, toks=toks, extra=extra,
                nxt=np.asarray(nxt),
                ltoks=ltoks, ref=ref)


def _torch_extra(extra) -> dict:
    return {k: torch.from_numpy(v) for k, v in extra.items()}


def test_configs_registered_and_copied():
    """All thirteen of the reference's configs, the new four field for
    field, and what each is here for."""
    from repro.configs import ARCHS as JARCHS
    assert sorted(ARCHS) == sorted(JARCHS)
    for name in FAMILIES:
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jget_config(name)))
    rw, hy, wh, iv = (get_config(n) for n in FAMILIES)
    assert rw.attention is None and rw.ssm.kind == "rwkv6" and rw.act == "rwkv"
    assert hy.ssm.kind == "mamba" and hy.attention.global_layers == (0, 15, 31)
    assert (hy.attention.num_heads // hy.attention.num_kv_heads,
            hy.attention.sliding_window) == (5, 1024)
    assert wh.encoder.num_frames == 1500 and wh.frontend == "audio"
    assert iv.frontend == "vision" and iv.num_patches == 256


def test_forward_logits_match_jax(family):
    f = family
    tp = interop.from_jax(f["jp"], f["tcfg"], device="cpu")
    logits, _ = lm.forward(tp, f["tcfg"], torch.from_numpy(f["toks"]),
                           device="cpu", **_torch_extra(f["extra"]))
    np.testing.assert_allclose(logits.numpy(), f["ref"]["forward"], **TOL)


def test_prefill_then_decode_match_jax(family):
    """Prefill logits and the decode step after it (at 2e-4), the audio
    cache's encoder output set by prefill."""
    f = family
    cfg = f["tcfg"]
    tp = interop.from_jax(f["jp"], cfg, device="cpu")
    cache = lm.init_cache(cfg, B, CACHE, device="cpu")
    lg, cache, _ = lm.prefill(tp, cfg, torch.from_numpy(f["toks"]), cache,
                              device="cpu", **_torch_extra(f["extra"]))
    np.testing.assert_allclose(lg.numpy(), f["ref"]["prefill"],
                               atol=DECODE_ATOL)
    nxt, _, _ = lm.decode_step(tp, cfg, torch.from_numpy(f["nxt"]),
                               lg.shape[1], cache, device="cpu")
    np.testing.assert_allclose(nxt.numpy(), f["ref"]["next"],
                               atol=DECODE_ATOL)


def test_token_by_token_decode_matches_jax(family):
    """Decoding the prompt a token at a time from an empty cache (the
    audio cache holding the encoder output), and one more step."""
    f = family
    cfg = f["tcfg"]
    tp = interop.from_jax(f["jp"], cfg, device="cpu")
    enc = (lm.encode(tp, cfg, torch.from_numpy(f["extra"]["frames"]))
           if cfg.family == "audio" else None)
    cache = lm.init_cache(cfg, B, CACHE, device="cpu", enc_out=enc)
    steps = []
    for t in range(S):
        lg, cache, _ = lm.decode_step(
            tp, cfg, torch.from_numpy(f["toks"][:, t:t + 1]), t, cache,
            device="cpu")
        steps.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(steps, 1).numpy(),
                               f["ref"]["steps"], atol=DECODE_ATOL)
    lg, _, _ = lm.decode_step(tp, cfg, torch.from_numpy(f["nxt"]), S, cache,
                              device="cpu")
    np.testing.assert_allclose(lg.numpy(), f["ref"]["steps_next"],
                               atol=DECODE_ATOL)


def test_step0_loss_and_grads_match_jax(family):
    """The step-0 loss, its ce and every gradient leaf (the encoder's
    stacked ``enc_layers`` included) against jax.value_and_grad."""
    f = family
    cfg = f["tcfg"]
    batch = {"tokens": torch.from_numpy(f["ltoks"]),
             **_torch_extra(f["extra"])}
    loss, aux, grads = train.loss_and_grads(
        interop.from_jax(f["jp"], cfg, device="cpu"), cfg, batch,
        impl="fused", device="cpu")
    np.testing.assert_allclose(float(loss), float(f["ref"]["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(f["ref"]["aux"]["ce"]),
                               rtol=1e-5)
    got = dict(jax.tree_util.tree_flatten_with_path(interop.to_jax(grads))[0])
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, f["ref"]["grads"]))[0]
    assert len(got) == len(ref)
    for path, b in ref:
        b = np.asarray(b)
        np.testing.assert_allclose(
            got[path], b, rtol=1e-4, atol=1e-4 * float(np.abs(b).max()),
            err_msg=f"{f['name']} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name", ["rwkv6-7b", "hymba-1.5b"])
def test_batcher_ring_matches_static_generate(name):
    """The continuous batcher on the recurrent caches (ring mode: they do
    not page): each request's greedy tokens equal static ``generate``'s,
    with slots reused as requests retire."""
    cfg = reduced(get_config(name))
    params = lm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=s) for s in (5, 9, 3)]
    b = ContinuousBatcher(params, cfg, ServeConfig(slots=2, max_len=32),
                          impl="fused", device="cpu")
    assert not b.paged
    for i, p in enumerate(prompts):
        b.submit(Request(id=i, prompt=p, max_new_tokens=5, arrival=0.0))
    b.run()
    out = {c.request_id: c.tokens for c in b.completions}
    for i, p in enumerate(prompts):
        seq = serve.generate(params, cfg, torch.as_tensor(p)[None], 5,
                             cache_len=32, device="cpu")
        assert out[i] == seq[0, len(p):].tolist(), (name, i)


@pytest.mark.parametrize("name", TOKENS_ONLY)
def test_serve_and_train_cli(capsys, name):
    serve.main(["--arch", name, "--reduced", "--device", "cpu", "--batch",
                "2", "--prompt_len", "8", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0].startswith(f"{name}-reduced on cpu")
    train.main(["--arch", name, "--reduced", "--device", "cpu", "--steps",
                "1", "--batch", "2", "--seq", "16", "--log_every", "1"])
    steps = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(steps) == 1 and np.isfinite(float(steps[0].split()[3]))


def test_clis_refuse_whisper():
    """whisper's decoder needs the stubbed frontend's frames, which no CLI
    flag feeds (the reference's CLIs fail in ``encode``)."""
    for main in (serve.main, train.main):
        with pytest.raises(ValueError, match="frame embeddings"):
            main(["--arch", "whisper-tiny", "--reduced", "--device", "cpu"])
    cfg = reduced(get_config("whisper-tiny"))
    with pytest.raises(ValueError, match="frame embeddings"):
        serve.generate(lm.init_params(cfg, device="cpu"), cfg,
                       torch.zeros(1, 4, dtype=torch.long), 2, device="cpu")
