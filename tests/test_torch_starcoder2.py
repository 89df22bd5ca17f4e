"""Parity of the port's long-prompt sliding-window serving with the JAX
package at reduced ``starcoder2-15b`` (2 layers, d_model 256, 4 heads of
64, window 64, QKV bias), f32, with ``num_kv_heads`` 2 on both sides so
that GQA groups exist.

A 96-token prompt, longer than the window, is prefilled into a 64-slot
ring (``serve.cache_len_for``), then 40 tokens are decoded, so the ring
wraps.  The JAX params move through ``interop.from_jax``; the prompt is
numpy.  Tolerance on logits: rtol/atol 1e-4 (f32 reassociation compounded
over two layers and the vocab projection, as ``test_torch_serve.py``).
Greedy tokens must be equal.
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
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
B, S, GEN = 2, 96, 40


def _cfg(get, red):
    cfg = red(get("starcoder2-15b"), num_layers=2, d_model=256)
    return dataclasses.replace(
        cfg, attention=dataclasses.replace(cfg.attention, num_kv_heads=2))


def test_config_copy_matches_jax():
    assert (dataclasses.asdict(get_config("starcoder2-15b"))
            == dataclasses.asdict(jget_config("starcoder2-15b")))
    tcfg = _cfg(get_config, reduced)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(_cfg(jget_config, jreduced))
    a = tcfg.attention
    assert (a.num_heads, a.num_kv_heads, a.sliding_window, a.qkv_bias) == (4, 2, 64, True)
    assert serve.cache_len_for(tcfg, S + GEN) == 64
    assert serve.cache_len_for(get_config("starcoder2-15b"), 8192 + 32) == 4096


def test_long_prompt_prefill_and_ring_decode_match_jax():
    jcfg, tcfg = _cfg(jget_config, jreduced), _cfg(get_config, reduced)
    jparams = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = interop.from_jax(jparams, tcfg, device="cpu")
    W = serve.cache_len_for(tcfg, S + GEN)
    prompt = np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                               (B, S)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, B, W)
    tcache = lm.init_cache(tcfg, B, W, device="cpu")
    jlog, jcache, _ = jlm.prefill(jparams, jcfg, jnp.asarray(prompt), jcache)
    tlog, tcache, _ = lm.prefill(tparams, tcfg, torch.from_numpy(prompt), tcache,
                                 device="cpu")
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jtok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
    ttok = torch.argmax(tlog[:, -1], -1)[:, None]
    for pos in range(S, S + GEN):
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jlog, jcache, _ = jlm.decode_step(jparams, jcfg, jnp.asarray(jtok),
                                          jnp.int32(pos), jcache)
        tlog, tcache, _ = lm.decode_step(tparams, tcfg, ttok, pos, tcache,
                                         device="cpu")
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        jtok = np.asarray(jnp.argmax(jlog[:, -1], -1))[:, None].astype(np.int32)
        ttok = torch.argmax(tlog[:, -1], -1)[:, None]
    assert int(tcache[0].positions.max()) == S + GEN - 1  # the ring wrapped
