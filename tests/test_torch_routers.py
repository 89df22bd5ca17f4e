"""The routing zoo of the port (noisy_topk, gumbel, expert_choice, frozen and
the StableMoE distillation) against the JAX package, on the same numpy
inputs and params.

Exploration noise: torch cannot reproduce ``jax.random``'s bits, so every
noisy case hands the port JAX's own draw, made here from the same key and
shape (the gate forwards take it as ``noise``; the layer and model paths
draw through ``gate.gate_noise``, which these tests replace by a lookup of
JAX's draws keyed on the seed the port passes).  The arithmetic after the
draw is then held bit for bit on the routing decision.

Where the port runs a kernel path (its plain version on the CPU), the
JAX side runs its einsum path — the same function, so the kernels' JAX
counterparts (Pallas in interpret mode, costly to compile) run only in
the expert-choice impl matrix, as ``tests/test_torch_moe.py`` runs them.

Tolerances: expert and token ids, capacity positions and group sizes
equal; gate weights 1e-6 (f32 softmax of the same logits); a MoE layer
1e-5 (the two packages' f32 products reassociate; the JAX Pallas kernels
run in interpret mode); gradients 1e-4 of each leaf's largest magnitude;
expert-choice's dense layer against its dispatched paths bit-equal on the
einsum capacity path and within 1e-6 elsewhere (the JAX package's own
dense == dispatched misses bit-exactness by 4.77e-7).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import fmoe as jfmoe  # noqa: E402
from repro.core import gate as jgate  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import fmoe as tfmoe  # noqa: E402
from repro_torch.core import gate as tgate  # noqa: E402
from repro_torch.core.fmoe import expert_seed  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402

ROUTERS = tgate.ROUTERS
IMPLS = ("einsum", "pallas", "fused")
DISPATCHES = ("capacity", "ragged")
W_TOL = dict(rtol=1e-6, atol=1e-6)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, T, E = 32, 24, 8
TINY = float(np.finfo(np.float32).tiny)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close_to_scale(got, ref, rel=1e-4, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rel,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=msg)


def _jax_draw(router, key, shape):
    """The draw the JAX package makes for ``router`` from ``key``."""
    if router == "gumbel":
        return np.asarray(jax.random.uniform(key, shape, jnp.float32,
                                             minval=TINY, maxval=1.0))
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _moe_kw(router, **kw):
    return {**dict(num_experts=E, top_k=2, d_expert_hidden=48), **kw,
            "router": router}


def _layer_params(router, act="gelu", seed=0, **kw):
    jcfg = JMoEConfig(**_moe_kw(router, **kw))
    return jcfg, jax.tree.map(np.asarray, jfmoe.fmoe_init(
        jax.random.PRNGKey(seed), D_MODEL, jcfg, act=act))


def _router_params(router, seed=3):
    """Router leaves of ``router`` (numpy), w_noise and w_frozen too where
    the router carries them, from JAX's router_init."""
    cfg = JMoEConfig(**_moe_kw(router))
    return jax.tree.map(lambda a: np.array(a), jgate.router_init(
        jax.random.PRNGKey(seed), D_MODEL, cfg))


# ---------------------------------------------------------------------------
# The gate forwards
# ---------------------------------------------------------------------------


def _gate_case(router, seed=1, ties=True, **kw):
    """(jax cfg, port cfg, params, x, key) — tied router columns, so the
    selection's tie order is exercised."""
    p = _router_params("noisy_topk" if router in ("topk", "noisy_topk")
                       else "gumbel")
    if ties:
        for name in p:
            p[name][:, 1] = p[name][:, 0]
            p[name][:, 3] = p[name][:, 2]
    x = _np((T, D_MODEL), seed)
    kw = _moe_kw(router, **kw)
    return JMoEConfig(**kw), MoEConfig(**kw), p, x, jax.random.PRNGKey(seed)


def _assert_gate(got, ref):
    np.testing.assert_array_equal(got.expert_ids.numpy(),
                                  np.asarray(ref.expert_ids))
    np.testing.assert_allclose(got.combine_weights.numpy(),
                               np.asarray(ref.combine_weights), **W_TOL)
    for a, b in [(got.probs, ref.probs), (got.logits, ref.logits)]:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **W_TOL)


@pytest.mark.parametrize("policy", ["softmax_topk", "topk_softmax"])
@pytest.mark.parametrize("noisy", [False, True])
def test_gate_forward_jitter_matches_jax(policy, noisy):
    """topk's optional exploration jitter: JAX's normal draw, 0.01 of it
    on the logits."""
    jcfg, tcfg, p, x, key = _gate_case("topk", gate_policy=policy)
    ref = jgate.gate_forward(p, jnp.asarray(x), jcfg,
                             rng=key if noisy else None)
    noise = _jax_draw("topk", key, (T, E)) if noisy else None
    got = tgate.gate_forward(_t(p), torch.from_numpy(x), tcfg,
                             noise=None if noise is None else _t(noise))
    _assert_gate(got, ref)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("noisy", [False, True])
def test_noisy_topk_forward_matches_jax(noisy, seed):
    jcfg, tcfg, p, x, key = _gate_case("noisy_topk", seed=seed)
    ref = jgate.noisy_topk_forward(p, jnp.asarray(x), jcfg,
                                   rng=key if noisy else None)
    noise = _t(_jax_draw("noisy_topk", key, (T, E))) if noisy else None
    got = tgate.noisy_topk_forward(_t(p), torch.from_numpy(x), tcfg,
                                   noise=noise)
    _assert_gate(got, ref)


@pytest.mark.parametrize("temperature", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("noisy", [False, True])
def test_gumbel_forward_matches_jax(noisy, temperature):
    """Selection on the perturbed logits, weights from the clean
    probabilities renormalized; temperature 0 draws nothing."""
    jcfg, tcfg, p, x, key = _gate_case("gumbel",
                                       router_temperature=temperature)
    ref = jgate.gumbel_topk_forward(p, jnp.asarray(x), jcfg,
                                    rng=key if noisy else None)
    noise = _t(_jax_draw("gumbel", key, (T, E))) if noisy else None
    got = tgate.gumbel_topk_forward(_t(p), torch.from_numpy(x), tcfg,
                                    noise=noise)
    _assert_gate(got, ref)
    if noisy and temperature > 0:  # the noise really moves the selection
        clean = tgate.gumbel_topk_forward(_t(p), torch.from_numpy(x), tcfg)
        assert not torch.equal(clean.expert_ids, got.expert_ids)


def test_frozen_forward_matches_jax_and_detaches():
    jcfg, tcfg, p, x, _ = _gate_case("frozen")
    ref = jgate.frozen_forward(p, jnp.asarray(x), jcfg)
    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    got = tgate.frozen_forward(tp, torch.from_numpy(x), tcfg)
    _assert_gate(got, ref)
    assert not got.logits.requires_grad  # w_frozen is detached


@pytest.mark.parametrize("router", ["noisy_topk", "gumbel"])
def test_noise_free_exploration_routers_equal_topk(router):
    """Without a draw the exploration routers are the deterministic gates:
    noisy_topk is topk_softmax top-k, gumbel softmax top-k renormalized,
    exactly."""
    _, tcfg, p, x, _ = _gate_case(router, ties=False)
    policy = "topk_softmax" if router == "noisy_topk" else "softmax_topk"
    topk = MoEConfig(**_moe_kw("topk", gate_policy=policy))
    fwd = (tgate.noisy_topk_forward if router == "noisy_topk"
           else tgate.gumbel_topk_forward)
    got = fwd(_t(p), torch.from_numpy(x), tcfg)
    want = tgate.gate_forward(_t(p), torch.from_numpy(x), topk)
    assert torch.equal(got.expert_ids, want.expert_ids)
    torch.testing.assert_close(got.combine_weights, want.combine_weights,
                               rtol=0, atol=1e-7)
    assert torch.equal(got.probs, want.probs)


@pytest.mark.parametrize("router", ["topk", "noisy_topk", "gumbel", "frozen"])
def test_route_tokens_draws_through_gate_noise(router, monkeypatch):
    """route_tokens draws ``gate_noise`` over (T_all, E) and takes its rows;
    a seed routes exactly as the gate forward given that draw."""
    _, tcfg, p, x, key = _gate_case(router, ties=False)
    draws = _jax_draw(router, key, (2 * T, E))
    calls = []

    def fake(kind, shape, seed, device, dtype=torch.float32):
        calls.append((kind, tuple(shape), seed))
        return _t(draws)

    monkeypatch.setattr(tgate, "gate_noise", fake)
    got = tgate.route_tokens(_t(p), torch.from_numpy(x), tcfg, noise_seed=5,
                             noise_rows=(T, 2 * T))
    if router in ("topk", "frozen"):  # no draw: topk's jitter is unarmed
        assert calls == []
        return
    kind = "uniform" if router == "gumbel" else "normal"
    assert calls == [(kind, (2 * T, E), 5)]
    fwd = {"topk": tgate.gate_forward, "noisy_topk": tgate.noisy_topk_forward,
           "gumbel": tgate.gumbel_topk_forward}[router]
    want = fwd(_t(p), torch.from_numpy(x), tcfg, noise=_t(draws[T:]))
    assert torch.equal(got.expert_ids, want.expert_ids)
    assert torch.equal(got.combine_weights, want.combine_weights)


def test_gate_noise_draws():
    """The draws are a pure function of the seed; uniform stays in [tiny,
    1)."""
    a = tgate.gate_noise("normal", (64, 8), 3, "cpu")
    assert torch.equal(a, tgate.gate_noise("normal", (64, 8), 3, "cpu"))
    assert not torch.equal(a, tgate.gate_noise("normal", (64, 8), 4, "cpu"))
    u = tgate.gate_noise("uniform", (4096, 8), 3, "cpu")
    assert float(u.min()) >= TINY and float(u.max()) < 1.0
    assert abs(float(a.mean())) < 0.2 and abs(float(u.mean()) - 0.5) < 0.02


def test_expert_choice_forward_matches_jax_with_ties():
    """Each expert's top-C tokens; identical token rows tie, and the lower
    token index goes first, as jax.lax.top_k(probs.T, C)."""
    p = _router_params("expert_choice")
    x = _np((T, D_MODEL), 4)
    x[5] = x[2]
    x[9] = x[2]
    jcfg, tcfg = (JMoEConfig(**_moe_kw("expert_choice")),
                  MoEConfig(**_moe_kw("expert_choice")))
    for C in (1, 3, T):
        ref = jgate.expert_choice_forward(p, jnp.asarray(x), jcfg, capacity=C)
        got = tgate.expert_choice_forward(_t(p), torch.from_numpy(x), tcfg,
                                          capacity=C)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **W_TOL)
    assert {2, 5} <= set(got[0].numpy().ravel())


@pytest.mark.parametrize("T_,cf", [(24, 2.0), (1, 1.25), (3, 1.25), (16, 0.1),
                                   (8, 8.0)])
def test_ec_capacity_matches_jax(T_, cf):
    """At decode C = max(1, min(T, floor(T cf / E))): one token may be all
    an expert picks."""
    assert TD.ec_capacity(T_, E, cf) == JD.ec_capacity(T_, E, cf)


# ---------------------------------------------------------------------------
# Init, distillation, aux loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router", ROUTERS)
def test_router_init_leaves(router):
    """The leaves JAX's router_init makes, at their scales; ``w`` drawn
    first, so topk and expert_choice draw exactly gate_init's stream and a
    distilling router's ``w`` is topk's."""
    cfg = MoEConfig(**_moe_kw(router, num_experts=64))
    d = 256
    got = tgate.router_init(torch.Generator().manual_seed(7), d, cfg,
                            device="cpu")
    ref = jgate.router_init(jax.random.PRNGKey(0), d,
                            JMoEConfig(**_moe_kw(router, num_experts=64)))
    assert sorted(got) == sorted(ref)
    for k, v in got.items():
        assert v.shape == ref[k].shape and v.dtype == torch.float32
        scale = d ** -0.5 * (0.1 if k == "w_noise" else 1.0)
        assert abs(float(v.std()) / scale - 1) < 0.05, k
    w0 = tgate.gate_init(torch.Generator().manual_seed(7), d, 64,
                         device="cpu")["w"]
    assert torch.equal(got["w"], w0)
    if router in ("topk", "expert_choice"):
        assert list(got) == ["w"]


def test_router_distill_loss_and_its_gradient():
    """The loss against JAX's; its gradient reaches only w_frozen, and
    equals jax.grad's."""
    p = _router_params("gumbel")
    x = _np((T, D_MODEL), 6)
    jcfg, tcfg = (JMoEConfig(**_moe_kw("gumbel")),
                  MoEConfig(**_moe_kw("gumbel")))
    g_j = jgate.gumbel_topk_forward(p, jnp.asarray(x), jcfg)
    ref, ref_g = jax.value_and_grad(
        lambda q: jgate.router_distill_loss(q, jnp.asarray(x), g_j))(p)
    tp = {k: v.requires_grad_() for k, v in _t(p).items()}
    xt = torch.from_numpy(x).requires_grad_()
    g_t = tgate.gumbel_topk_forward(tp, xt, tcfg)
    loss = tgate.router_distill_loss(tp, xt, g_t)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    gw, gf, gx = torch.autograd.grad(loss, [tp["w"], tp["w_frozen"], xt],
                                     allow_unused=True)
    assert gw is None and gx is None
    _close_to_scale(gf.numpy(), ref_g["w_frozen"], 1e-5)
    assert not np.asarray(ref_g["w"]).any()


@pytest.mark.parametrize("router", ["topk", "noisy_topk", "gumbel", "frozen"])
def test_aux_loss_matches_jax(router):
    """Balance loss, plus the distillation term where w_frozen rides along
    and the router is not frozen (a topk router given w_frozen too)."""
    p = _router_params("gumbel")
    if router == "noisy_topk":
        p = _router_params("noisy_topk")
    x = _np((T, D_MODEL), 8)
    jcfg, tcfg = (JMoEConfig(**_moe_kw(router)), MoEConfig(**_moe_kw(router)))
    g_j = jgate.route_tokens(p, jnp.asarray(x), jcfg)
    g_t = tgate.route_tokens(_t(p), torch.from_numpy(x), tcfg)
    got = tfmoe._aux_loss(_t(p), torch.from_numpy(x), g_t, tcfg)
    ref = jfmoe._aux_loss(p, jnp.asarray(x), g_j, jcfg)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    plain = float(jfmoe.load_balance_loss(g_j.probs, g_j.expert_ids, E))
    assert (float(got) == pytest.approx(plain)) == (router == "frozen")


# ---------------------------------------------------------------------------
# The MoE layer
# ---------------------------------------------------------------------------


def _layer_grads_jax(params, x, r, cfg, act, impl, rng=None):
    def f(p, xx):
        y, m = jfmoe.fmoe_apply(p, xx, cfg, act=act, impl=impl, rng=rng)
        return (y * r).sum(), (y, m)
    (_, (y, m)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jax.tree.map(jnp.asarray, params),
                                         jnp.asarray(x))
    return y, m, gp, gx


def _layer_grads_torch(params, x, r, cfg, act, impl, noise_seed=None):
    p = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
         for k, v in _t(params).items()}
    xs = torch.from_numpy(x).requires_grad_()
    y, m = tfmoe.fmoe_apply(p, xs, cfg, act=act, impl=impl,
                            noise_seed=noise_seed)
    leaves = [t for v in p.values() for t in v.values()] + [xs]
    g = torch.autograd.grad((y * torch.from_numpy(r)).sum(), leaves,
                            allow_unused=True, materialize_grads=True)
    names = [f"{k}/{n}" for k, v in p.items() for n in v]
    return y, m, dict(zip(names, g[:-1])), g[-1]


def _assert_layer(got, ref, router):
    y, m, gp, gx = got
    jy, jm, jgp, jgx = ref
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **LAYER_TOL)
    for name in ("aux_loss", "z_loss", "load", "drop_frac"):
        np.testing.assert_allclose(getattr(m, name).detach().numpy(),
                                   np.asarray(getattr(jm, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    _close_to_scale(gx.numpy(), jgx, 1e-4, "x")
    for path, g in gp.items():
        k, n = path.split("/")
        _close_to_scale(g.numpy(), jgp[k][n], 1e-4, f"{router} {path}")


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_expert_choice_layer_matches_jax(impl, dispatch):
    """JAX's _moe_local with router=expert_choice: y, metrics (aux 0, flat
    load, nothing dropped) and the gradients of sum(y * r)."""
    jcfg, params = _layer_params("expert_choice", dispatch=dispatch,
                                 capacity_factor=1.5)
    tcfg = MoEConfig(**_moe_kw("expert_choice", dispatch=dispatch,
                               capacity_factor=1.5))
    x, r = _np((T, D_MODEL), 10), _np((T, D_MODEL), 11)
    got = _layer_grads_torch(params, x, r, tcfg, "gelu", impl)
    _assert_layer(got, _layer_grads_jax(params, x, r, jcfg, "gelu", impl),
                  "expert_choice")
    m = got[1]
    assert float(m.aux_loss) == 0 and float(m.drop_frac) == 0
    torch.testing.assert_close(m.load, torch.full((E,), 1 / E))


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_expert_choice_dense_equals_dispatched(impl, dispatch):
    """gate.expert_choice_moe (the dense reference) against the dispatched
    local path: bit-equal on einsum/capacity (the same products), within
    1e-6 on the grouped kernels' plain versions."""
    cfg = MoEConfig(**_moe_kw("expert_choice", dispatch=dispatch,
                              capacity_factor=2.0))
    _, params = _layer_params("expert_choice")
    x = torch.from_numpy(_np((2, T // 2, D_MODEL), 12))
    dense, probs = tgate.expert_choice_moe(_t(params), x, cfg, act="gelu",
                                           capacity_factor=2.0)
    y, _ = tfmoe.fmoe_apply(_t(params), x, cfg, act="gelu", impl=impl)
    if (impl, dispatch) == ("einsum", "capacity"):
        assert torch.equal(y, dense)
    else:
        assert float((y - dense).abs().max()) <= 1e-6
    assert probs.shape == (T, E)


@pytest.mark.parametrize("router", ROUTERS[1:])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_every_router_layer_matches_jax(router, dispatch):
    """Each router of the zoo through fmoe_apply (fused, swiglu, capacity
    that drops rows) against JAX's, noise-free: y, metrics and gradients
    (topk's: ``tests/test_torch_moe.py``)."""
    kw = dict(dispatch=dispatch, capacity_factor=0.75)
    jcfg, params = _layer_params(router, act="swiglu", **kw)
    tcfg = MoEConfig(**_moe_kw(router, **kw))
    x, r = _np((T, D_MODEL), 13), _np((T, D_MODEL), 14)
    _assert_layer(_layer_grads_torch(params, x, r, tcfg, "swiglu", "fused"),
                  _layer_grads_jax(params, x, r, jcfg, "swiglu", "einsum"),
                  router)


@pytest.mark.parametrize("router", ["noisy_topk", "gumbel"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_noisy_layer_matches_jax_draw(router, dispatch, monkeypatch):
    """The exploration routers with a seed, given JAX's draw from the
    key JAX's layer uses: the same routing, y and gradients."""
    kw = dict(dispatch=dispatch)
    jcfg, params = _layer_params(router, **kw)
    tcfg = MoEConfig(**_moe_kw(router, **kw))
    x, r = _np((T, D_MODEL), 15), _np((T, D_MODEL), 16)
    key = jax.random.PRNGKey(21)
    draw = _t(_jax_draw(router, key, (T, E)))
    monkeypatch.setattr(tgate, "gate_noise",
                        lambda kind, shape, seed, device, dtype=None: draw)
    got = _layer_grads_torch(params, x, r, tcfg, "gelu", "einsum",
                             noise_seed=9)
    _assert_layer(got, _layer_grads_jax(params, x, r, jcfg, "gelu", "einsum",
                                        rng=key), router)
    clean = tfmoe.fmoe_apply(_t(params), torch.from_numpy(x), tcfg,
                             act="gelu")[0]
    assert not torch.equal(clean, got[0])  # the draw reached the routing


def test_dist_router_overrides_the_config():
    """DistConfig.router pins the router without touching the config, as
    the reference's fmoe_apply does."""
    jcfg, params = _layer_params("gumbel")
    x = torch.from_numpy(_np((T, D_MODEL), 17))
    cfg = MoEConfig(**_moe_kw("gumbel"))
    frozen = MoEConfig(**_moe_kw("frozen"))
    y0, _ = tfmoe.fmoe_apply(_t(params), x, frozen, act="gelu")
    y1, _ = tfmoe.fmoe_apply(_t(params), x, cfg, act="gelu",
                             dist=tfmoe.DistConfig(None, (), router="frozen"))
    assert torch.equal(y0, y1)


def test_interop_carries_the_router_leaves():
    """from_jax / to_jax move w_noise and w_frozen both ways."""
    jcfg, tcfg = _model_cfgs("noisy_topk")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tp = interop.from_jax(jp, tcfg, device="cpu")
    assert sorted(tp["layers"][0]["ffn"]["router"]) == ["w", "w_frozen",
                                                        "w_noise"]
    back = interop.to_jax(tp)
    for k in ("w", "w_noise", "w_frozen"):
        np.testing.assert_array_equal(back["layers"]["ffn"]["router"][k],
                                      jp["layers"]["ffn"]["router"][k])


# ---------------------------------------------------------------------------
# The model and the train step
# ---------------------------------------------------------------------------

B, S = 2, 16


def _model_cfgs(router, dispatch="ragged", remat="none"):
    def make(get, red):
        cfg = red(get("fastmoe-gpt"), num_layers=2, d_model=64)
        return dataclasses.replace(cfg, remat=remat, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch, router=router))
    return make(jget_config, jreduced), make(get_config, reduced)


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _assert_tree_close(got: dict, ref: dict, rel: float):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_got) == len(flat_ref)
    for path, a in flat_got:
        b = np.asarray(flat_ref[path])
        np.testing.assert_allclose(a, b, rtol=rel,
                                   atol=rel * float(np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))


def _seeded_draws(monkeypatch, router, rng, seed, layers, shape):
    """Make the port's gate_noise return, for layer l's seed
    expert_seed(seed, l), JAX's draw from split(rng, layers)[l] (the keys
    JAX's lm.forward hands its layers)."""
    keys = jax.random.split(rng, layers)
    table = {expert_seed(seed, l): _t(_jax_draw(router, keys[l], shape))
             for l in range(layers)}
    monkeypatch.setattr(tgate, "gate_noise",
                        lambda kind, shp, s, device, dtype=None: table[s])


@pytest.mark.parametrize("router,noisy", [("expert_choice", False),
                                          ("frozen", False),
                                          ("noisy_topk", True),
                                          ("gumbel", True)])
def test_model_step0_grads_match_jax(router, noisy, monkeypatch):
    """Reduced fastmoe-gpt (fused, ragged, remat on) with each router of
    the zoo: the step-0 loss, aux and every gradient leaf against
    jax.value_and_grad of JAX's loss_fn, the exploration routers with
    JAX's per-layer draws (noise-free, they route as the layer tests hold;
    topk's model: ``tests/test_torch_train.py``)."""
    jcfg, tcfg = _model_cfgs(router, remat="full")
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = _tokens()
    rng = jax.random.PRNGKey(5) if noisy else None
    seed = 77 if noisy else None
    if noisy:
        _seeded_draws(monkeypatch, router, rng, seed, 2, (B * S, 4))
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                              impl="einsum", rng=rng), has_aux=True)(jp)
    loss, aux, grads = train.loss_and_grads(
        interop.from_jax(jp, tcfg, device="cpu"), tcfg,
        {"tokens": torch.from_numpy(tokens)}, impl="fused", device="cpu",
        router_seed=seed)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux_loss", "z_loss", "drop_frac", "load"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_tree_close(interop.to_jax(grads),
                       jax.tree.map(np.asarray, jgrads), 1e-4)


@pytest.mark.parametrize("router", ["noisy_topk", "expert_choice"])
def test_train_steps_match_jax(router, monkeypatch):
    """Two AdamW steps of make_train_step: the exploration draw per step
    (JAX folds the step into PRNGKey(17); the port seeds
    expert_seed(17, step, microbatch)) and expert-choice."""
    jcfg, tcfg = _model_cfgs(router, dispatch="capacity")
    jp0 = jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    opt_kw = dict(lr=1e-3)
    jstep = jax.jit(jtrain.make_train_step(jcfg, joptim.AdamW(**opt_kw),
                                           warmup=2, total_steps=10,
                                           impl="einsum"))
    jp = jax.tree.map(jnp.asarray, jp0)
    jst = joptim.AdamW(**opt_kw).init(jp)
    topt = toptim.AdamW(**opt_kw)
    tstep = train.make_train_step(tcfg, topt, warmup=2, total_steps=10,
                                  impl="einsum", device="cpu")
    tp = interop.from_jax(jp0, tcfg, device="cpu")
    tst = topt.init(tp)
    for step in range(2):
        if router in tgate.EXPLORING:
            _seeded_draws(monkeypatch, router,
                          jax.random.fold_in(jax.random.PRNGKey(17), step),
                          expert_seed(17, step, 0), 2, (B * S, 4))
        tokens = _tokens(step)
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(tokens)},
                            jnp.int32(step))
        tp, tst, tm = tstep(tp, tst, {"tokens": torch.from_numpy(tokens)},
                            step)
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {step} {k}")
    _assert_tree_close(interop.to_jax(tp), jax.tree.map(np.asarray, jp), 1e-4)


def test_noisy_step_repeats_and_remat_recomputes_the_draw():
    """The seed decides the draw: two runs of a noisy step are equal bit
    for bit, remat's recompute routes as the forward did (the gradients
    equal the no-remat run's), and another step's seed routes otherwise."""
    _, tcfg = _model_cfgs("gumbel", remat="full")
    _, plain = _model_cfgs("gumbel", remat="none")
    from repro_torch.models import lm
    params = lm.init_params(tcfg, seed=0, device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens())}
    runs = [train.loss_and_grads(params, cfg, batch, impl="fused",
                                 device="cpu", router_seed=s)
            for cfg, s in ((tcfg, 3), (tcfg, 3), (plain, 3), (tcfg, 4))]
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(*(train.tree_leaves(r[2]) for r in runs[:2])):
        assert torch.equal(a, b)
    for a, b in zip(*(train.tree_leaves(r[2]) for r in (runs[0], runs[2]))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert not torch.equal(runs[0][0], runs[3][0])


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def _train_cli(capsys, *args, steps=3):
    train.main(["--arch", "fastmoe-gpt", "--reduced", "--device", "cpu",
                "--steps", str(steps), "--log_every", "1", "--batch", "2",
                "--seq", "8", *args])
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("router", ["noisy_topk", "gumbel"])
def test_train_cli_freezes_the_router(capsys, router):
    """--router R --freeze_router_at 2: distilling steps 0-1, then the
    router-frozen line and step 2 through w_frozen."""
    lines = _train_cli(capsys, "--router", router, "--freeze_router_at", "2")
    steps = [ln for ln in lines if ln.startswith("step")]
    assert "router frozen" in steps[2] and steps[2].startswith("step     2")
    losses = [float(ln.split("loss")[1].split()[0]) for ln in steps
              if "loss" in ln]
    assert len(losses) == 3 and all(5.0 < v < 8.0 for v in losses), losses


@pytest.mark.parametrize("router", ["expert_choice", "frozen"])
def test_train_cli_router(capsys, router):
    lines = _train_cli(capsys, "--router", router, "--dispatch", "capacity",
                       steps=1)
    assert sum(ln.startswith("step") for ln in lines) == 1


def test_train_cli_refuses_freezing_a_non_distilling_router():
    with pytest.raises(SystemExit, match="distilling router"):
        train.main(["--reduced", "--device", "cpu", "--router", "topk",
                    "--freeze_router_at", "2"])


@pytest.mark.parametrize("router", ROUTERS)
def test_serve_cli_router(capsys, router):
    """serve --router R at reduced size: greedy tokens; gumbel serves as
    topk's softmax top-k (no draw at decode)."""
    serve.main(["--reduced", "--device", "cpu", "--batch", "2",
                "--prompt_len", "8", "--gen", "4", "--router", router])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and "prefill 2x8" in out[0]
    assert len(eval(out[1])) == 12


@pytest.mark.parametrize("router", ["expert_choice", "noisy_topk"])
def test_continuous_serving_takes_the_router(capsys, router):
    """The continuous batcher routes by the config's router (expert-choice
    picks from a tick's few tokens: C = max(1, floor(T cf / E)))."""
    serve.main(["--reduced", "--device", "cpu", "--continuous", "--slots", "2",
                "--requests", "3", "--prompt_len", "8", "--gen", "3",
                "--block_size", "4", "--router", router])
    out = capsys.readouterr().out.splitlines()
    assert "3 requests, 9 tokens" in out[0], out
