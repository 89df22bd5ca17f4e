"""Parity of the port's gate, dispatch plans and MoE layer with the JAX
package, on the same numpy inputs and params (moved through numpy).

Tolerances: routing decisions (ids, positions, keep masks, group sizes,
sort order) must be equal; float outputs agree to rtol/atol 1e-5, the f32
reassociation between the two packages' products (the JAX side runs its
Pallas kernels in interpret mode).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import fmoe as jfmoe  # noqa: E402
from repro.core import gate as jgate  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import fmoe as tfmoe  # noqa: E402
from repro_torch.core import gate as tgate  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("policy", ["softmax_topk", "topk_softmax"])
@pytest.mark.parametrize("renorm", [True, False])
def test_gate_matches_jax_with_ties(policy, renorm):
    """Experts 0/1 and 2/3 have identical router columns, so every token has
    tied probabilities: both packages must pick the lower index first."""
    d, E, T = 16, 6, 12
    w = _np((d, E), 0)
    w[:, 1] = w[:, 0]
    w[:, 3] = w[:, 2]
    x = _np((T, d), 1)
    kw = dict(num_experts=E, top_k=3, gate_policy=policy, renormalize=renorm)
    ref = jgate.gate_forward({"w": jnp.asarray(w)}, jnp.asarray(x),
                             JMoEConfig(**kw))
    got = tgate.gate_forward({"w": torch.from_numpy(w)}, torch.from_numpy(x),
                             MoEConfig(**kw))
    np.testing.assert_array_equal(got.expert_ids.numpy(),
                                  np.asarray(ref.expert_ids))
    for a, b in [(got.combine_weights, ref.combine_weights),
                 (got.probs, ref.probs), (got.logits, ref.logits)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # the tie is real: some token picked both members of a tied pair
    ids = got.expert_ids.numpy()
    assert any({0, 1} <= set(r) or {2, 3} <= set(r) for r in ids)


def test_router_other_than_topk_raises():
    """Every router of the zoo routes now (tests/test_torch_routers.py);
    a name outside it is refused by the gate, its init and the layer."""
    cfg = MoEConfig(router="switch", num_experts=8, d_expert_hidden=8)
    with pytest.raises(ValueError, match="unknown router"):
        tgate.route_tokens({"w": torch.zeros(4, 8)}, torch.zeros(2, 4), cfg)
    with pytest.raises(ValueError, match="unknown router"):
        tgate.router_init(torch.Generator(), 4, cfg, device="cpu")
    params = tfmoe.fmoe_init(torch.Generator(), 4, MoEConfig(
        num_experts=8, d_expert_hidden=8), device="cpu")
    with pytest.raises(ValueError, match="unknown router"):
        tfmoe.fmoe_apply(params, torch.zeros(2, 4), cfg)


def test_capacity_plan_with_overflow_matches_jax():
    E, T, k, C, d = 4, 20, 2, 4, 8
    ids = np.random.default_rng(2).integers(0, E, (T, k))
    ids[:, 1] = (ids[:, 0] + 1) % E  # top-k ids are distinct per token
    ids[:8, 0] = 1  # expert 1 overflows its capacity
    jplan = JD.make_capacity_plan(jnp.asarray(ids, jnp.int32), E, C)
    tplan = TD.make_capacity_plan(torch.from_numpy(ids), E, C)
    for a, b in [(tplan.positions, jplan.positions), (tplan.keep, jplan.keep),
                 (tplan.load, jplan.load)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not tplan.keep.all()
    x, cw = _np((T, d), 3), np.random.default_rng(4).random((T, k)).astype(np.float32)
    jbuf = JD.dispatch_capacity(jnp.asarray(x), jplan, E)
    tbuf = TD.dispatch_capacity(torch.from_numpy(x), tplan, E)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    out = _np((E, C, d), 5)
    jy = JD.combine_capacity(jnp.asarray(out), jplan, jnp.asarray(cw))
    ty = TD.combine_capacity(torch.from_numpy(out), tplan, torch.from_numpy(cw))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


def test_ragged_plan_matches_jax():
    E, T, k, d = 4, 15, 2, 8
    ids = np.random.default_rng(6).integers(0, E - 1, (T, k))  # expert 3 empty
    jplan = JD.make_ragged_plan(jnp.asarray(ids, jnp.int32), E)
    tplan = TD.make_ragged_plan(torch.from_numpy(ids), E)
    for a, b in [(tplan.sort_idx, jplan.sort_idx),
                 (tplan.group_sizes, jplan.group_sizes),
                 (tplan.token_rows, jplan.token_rows)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = _np((T, d), 7)
    np.testing.assert_array_equal(
        TD.dispatch_ragged(torch.from_numpy(x), tplan).numpy(),
        np.asarray(JD.dispatch_ragged(jnp.asarray(x), jplan)))
    ys, cw = _np((T * k, d), 8), np.random.default_rng(9).random((T, k)).astype(np.float32)
    jy = JD.combine_ragged(jnp.asarray(ys), jplan, jnp.asarray(cw))
    ty = TD.combine_ragged(torch.from_numpy(ys), tplan, torch.from_numpy(cw))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("impl", ["einsum", "pallas", "fused"])
def test_fmoe_apply_matches_jax(impl, dispatch):
    d, T = 64, 24
    kw = dict(num_experts=4, top_k=2, d_expert_hidden=96, dispatch=dispatch,
              capacity_factor=0.5)  # capacity drops rows
    jcfg, tcfg = JMoEConfig(**kw), MoEConfig(**kw)
    params = _tree_np(jfmoe.fmoe_init(jax.random.PRNGKey(0), d, jcfg, act="gelu"))
    x = _np((2, T // 2, d), 10)
    jy, jm = jfmoe.fmoe_apply(params, jnp.asarray(x), jcfg, act="gelu", impl=impl)
    ty, tm = tfmoe.fmoe_apply(_tree_t(params), torch.from_numpy(x), tcfg,
                              act="gelu", impl=impl)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for name in ("aux_loss", "z_loss", "load", "drop_frac"):
        np.testing.assert_allclose(getattr(tm, name).numpy(),
                                   np.asarray(getattr(jm, name)), **TOL)


def test_fmoe_apply_with_a_mesh_raises():
    """The psum mode (tokens not sharded over the expert axis) trains: under
    autograd it records a graph through its all-reduce, here over a
    world-size-1 gloo group in this process, whose output and gradients
    are the local path's bit for bit.  What a mesh still refuses is held by
    ``tests/test_torch_ep.py::test_unsupported_options_raise``; the
    multi-rank gradients by its psum cases."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    assert not tdist.is_initialized()
    init_distributed("cpu", rank=0, world_size=1, store=tdist.HashStore())
    try:
        dist = tfmoe.DistConfig(make_local_mesh(1, 1), ("data",))
        assert dist.mode == "psum"
        cfg = MoEConfig(num_experts=2, d_expert_hidden=8)
        gen = torch.Generator().manual_seed(0)
        params = tfmoe.fmoe_init(gen, 4, cfg, device="cpu")
        x = torch.randn(2, 3, 4, generator=gen)
        r = torch.randn(2, 3, 4, generator=gen)
        res = []
        for d in (dist, None):
            p = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
                 for k, v in params.items()}
            xs = x.clone().requires_grad_()
            y, m = tfmoe.fmoe_apply(p, xs, cfg, dist=d)
            assert y.grad_fn is not None and m.aux_loss.grad_fn is not None
            leaves = [p["router"]["w"], *p["experts"].values(), xs]
            res.append([y] + list(torch.autograd.grad(
                (y * r).sum() + m.aux_loss + m.z_loss, leaves)))
        for a, b in zip(*res):
            assert torch.equal(a, b)
    finally:
        tdist.destroy_process_group()
