"""Parity of the port's serving path with the JAX package at reduced
``fastmoe-gpt`` (2 layers, d_model 256, 4 experts, expert hidden 512), f32.

The JAX params move through ``repro_torch.interop.from_jax``; prompts are
numpy.  Tolerance on logits: rtol/atol 1e-4 — f32 reassociation only,
compounded over two layers, attention and the vocab projection (per layer
the MoE output agrees to 1e-5, tests/test_torch_moe.py).  Greedy tokens
must be equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, GEN, CACHE = 2, 8, 4, 16


def _cfgs(dispatch):
    def make(get, red):
        cfg = red(get("fastmoe-gpt"), num_layers=2, d_model=256)
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return make(jget_config, jreduced), make(get_config, reduced)


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs("capacity")
    return jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))


def _prompt():
    return np.random.default_rng(0).integers(0, 512, (B, S)).astype(np.int32)


def test_config_copy_matches_jax():
    for name in ("fastmoe-gpt", "fastmoe-gpt-dense"):
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jget_config(name)))
    jcfg, tcfg = _cfgs("ragged")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


@pytest.mark.parametrize("dispatch,impl", [("ragged", "fused"),
                                           ("capacity", "einsum")])
def test_prefill_and_decode_logits_match_jax(jparams, dispatch, impl):
    jcfg, tcfg = _cfgs(dispatch)
    tparams = interop.from_jax(jparams, tcfg, device="cpu")
    prompt = _prompt()
    jcache = jlm.init_cache(jcfg, B, CACHE)
    tcache = lm.init_cache(tcfg, B, CACHE, device="cpu")
    jlog, jcache, _ = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), jcache,
                                  impl=impl)
    tlog, tcache, _ = lm.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache,
                                 impl=impl, device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    for pos in range(S, S + 4):
        jlog, jcache, _ = jlm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                          jnp.int32(pos), jcache, impl=impl)
        tlog, tcache, _ = lm.decode_step(tparams, tcfg, torch.from_numpy(tok),
                                         pos, tcache, impl=impl, device="cpu")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        tok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("dispatch", ["ragged", "capacity"])
def test_generate_tokens_match_jax(jparams, dispatch):
    """JAX generate runs its default einsum experts; the port runs its
    serving default, the fused kernel's path."""
    jcfg, tcfg = _cfgs(dispatch)
    prompt = _prompt()
    ref = jserve.generate(jparams, jcfg, jnp.asarray(prompt), GEN,
                          cache_len=CACHE)
    got = serve.generate(interop.from_jax(jparams, tcfg, device="cpu"), tcfg,
                         torch.from_numpy(prompt), GEN, cache_len=CACHE,
                         impl="fused", device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("impl", ["pallas", "fused"])
def test_prefill_path_matches_token_by_token(jparams, impl):
    """The port alone: prefill + decode against feeding the prompt token by
    token through decode_step (same tokens, logits to 1e-4); forward gives
    the prefill's logits exactly."""
    _, tcfg = _cfgs("ragged")
    tparams = interop.from_jax(jparams, tcfg, device="cpu")
    prompt = torch.from_numpy(_prompt())
    a = serve.generate(tparams, tcfg, prompt, GEN, cache_len=CACHE, impl=impl,
                       device="cpu")
    b = serve.generate(tparams, tcfg, prompt, GEN, cache_len=CACHE, impl=impl,
                       use_prefill=False, device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    cache = lm.init_cache(tcfg, B, CACHE, device="cpu")
    full, _, _ = lm.prefill(tparams, tcfg, prompt, cache, impl=impl, device="cpu")
    fwd, _ = lm.forward(tparams, tcfg, prompt, impl=impl, device="cpu")
    torch.testing.assert_close(fwd, full, rtol=0, atol=0)
    cache = lm.init_cache(tcfg, B, CACHE, device="cpu")
    for pos in range(S):
        step, cache, _ = lm.decode_step(tparams, tcfg, prompt[:, pos:pos + 1],
                                        pos, cache, impl=impl, device="cpu")
        torch.testing.assert_close(step[:, 0], full[:, pos], **TOL)


def test_interop_round_trip(jparams):
    _, tcfg = _cfgs("ragged")
    back = interop.to_jax(interop.from_jax(jparams, tcfg, device="cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jparams)
