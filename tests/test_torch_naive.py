"""The naive MoE baselines (paper §5.2, Fig 5) of the port against the JAX
package's ``repro.core.naive``, on the same numpy params and tokens:
``moe_loop_masked`` and ``moe_per_sample`` for top-k at k = 2 and k = 1
(Switch), GELU and SwiGLU experts, at 1e-5; both equal to the port's own
``fmoe_apply`` without drops (capacity factor 8) at 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import fmoe as jfmoe  # noqa: E402
from repro.core import naive as jnaive  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import fmoe as tfmoe  # noqa: E402
from repro_torch.core import naive  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("fn", ["moe_loop_masked", "moe_per_sample"])
@pytest.mark.parametrize("k", [2, 1])
@pytest.mark.parametrize("act", ["gelu", "swiglu"])
def test_naive_matches_jax(fn, k, act):
    d, T = 32, 20
    kw = dict(num_experts=4, top_k=k, d_expert_hidden=48, capacity_factor=8.0)
    jcfg, tcfg = JMoEConfig(**kw), MoEConfig(**kw)
    params = jax.tree.map(np.asarray, jfmoe.fmoe_init(
        jax.random.PRNGKey(k), d, jcfg, act=act))
    x = np.random.default_rng(5).standard_normal((2, T // 2, d)).astype(
        np.float32)
    want = np.asarray(getattr(jnaive, fn)(jax.tree.map(jnp.asarray, params),
                                          jnp.asarray(x), jcfg, act=act))
    got = getattr(naive, fn)(_tree_t(params), torch.from_numpy(x), tcfg,
                             act=act)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    y, _ = tfmoe.fmoe_apply(_tree_t(params), torch.from_numpy(x), tcfg,
                            act=act)
    np.testing.assert_allclose(got.numpy(), y.numpy(), **TOL)
