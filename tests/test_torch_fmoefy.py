"""The paper's ``fmoefy`` plugin (§3.1, Listing 1; ``core/fmoefy.py``)
against the JAX package's: the rewritten config field for field for
(E, k) in {(4, 1), (16, 2), (96, 4)} on granite-3-2b and rwkv6-7b, and
the double-MoE refusal; then fmoefy'd reduced rwkv6 (the MoE in place of
the channel mix) and hymba on the CPU: each MoE layer on the same input
for every impl x dispatch against JAX's einsum layer (1e-5: f32
reassociation over one layer), and the model's forward logits (1e-4).
The port's params are made by its ``init_params``, in the tree, shapes
and dtypes JAX's ``init_params`` makes, and moved through ``interop``.
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
from repro.core import fmoe as jfmoe  # noqa: E402
from repro.core.fmoefy import fmoefy as jfmoefy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import fmoefy, interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import fmoe as tfmoe  # noqa: E402
from repro_torch.models import lm  # noqa: E402

B, S = 2, 8
TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
IMPLS = ("einsum", "pallas", "fused")
DISPATCHES = ("capacity", "ragged")


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


@pytest.mark.parametrize("name", ["granite-3-2b", "rwkv6-7b"])
@pytest.mark.parametrize("E,k", [(4, 1), (16, 2), (96, 4)])
def test_fmoefy_matches_jax(name, E, k):
    out = fmoefy(get_config(name), num_experts=E, top_k=k)
    assert (dataclasses.asdict(out)
            == dataclasses.asdict(jfmoefy(jget_config(name), num_experts=E,
                                          top_k=k)))
    assert out.moe.d_expert_hidden == max(8, get_config(name).d_ff // k)
    assert out.family == ("ssm" if name == "rwkv6-7b" else "moe")
    with pytest.raises(ValueError, match="already has an MoE FFN"):
        fmoefy(out)
    with pytest.raises(ValueError, match="already has an MoE FFN"):
        fmoefy(get_config("arctic-480b"))


@pytest.mark.parametrize("name", ["rwkv6-7b", "hymba-1.5b"])
def test_fmoefied_layers_match_jax(name):
    """fmoefy'd reduced rwkv6 (the MoE replaces the channel mix) and
    hymba: each MoE layer on the same input for every impl x dispatch
    against JAX's einsum layer (1e-5), and the model's forward logits
    (fused, ragged) against JAX's (1e-4)."""
    jbase = jreduced(jfmoefy(jget_config(name), num_experts=96, top_k=2))
    tbase = reduced(fmoefy(get_config(name), num_experts=96, top_k=2))
    assert dataclasses.asdict(jbase) == dataclasses.asdict(tbase)
    jp = _params(jbase, tbase, seed=5)
    tp = interop.from_jax(jp, tbase, device="cpu")
    x = np.random.default_rng(6).standard_normal(
        (B, S, tbase.d_model)).astype(np.float32)
    toks = _tokens(tbase.vocab_size, (B, S), seed=7)
    layer_fn = jax.jit(jfmoe.fmoe_apply, static_argnames=("cfg", "act"))
    for dispatch in DISPATCHES:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, dispatch=dispatch)) for c in (jbase, tbase))
        for layer in range(tcfg.num_layers):
            p_j = jax.tree.map(lambda a: np.asarray(a)[layer],
                               jp["layers"]["ffn"])
            jy, _ = layer_fn(p_j, jnp.asarray(x), cfg=jcfg.moe,
                             act=jcfg.act)
            for impl in IMPLS:
                ty, _ = tfmoe.fmoe_apply(tp["layers"][layer]["ffn"],
                                         torch.from_numpy(x), tcfg.moe,
                                         act=tcfg.act, impl=impl)
                np.testing.assert_allclose(
                    ty.numpy(), np.asarray(jy), **MOE_TOL,
                    err_msg=f"{name} {dispatch} {impl} layer {layer}")
    # the model (the ssm block's MoE in place of the channel mix) on the
    # last dispatch
    jl, _ = jax.jit(functools.partial(jlm.forward, cfg=jcfg))(
        jp, tokens=jnp.asarray(toks))
    tl, _ = lm.forward(tp, tcfg, torch.from_numpy(toks), impl="fused",
                       device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL,
                               err_msg=f"{name} {dispatch}")
