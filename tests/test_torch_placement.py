"""Expert placement in the port (``repro_torch.placement``,
``core/monitor``) against the JAX package, on the same numpy inputs.

* the planner, the cost model, the controller, the load monitor, the
  calibration and the replan probation: the same plans (equal tuples), the
  same costs (to 1e-12), EMAs, bounds and decisions, built after the
  reference's ``tests/test_placement.py``, ``test_per_layer.py``,
  ``test_calibrate.py`` and the probation cases of ``test_resilience.py``,
  with explicit constants (the two packages' defaults differ: the port's
  are the card's own);
* migration of a 2-layer param tree and its AdamW state, shared and
  per-layer plans, bit for bit against the reference's ``migrate``;
* the MoE layer under a plan (``DistConfig.local(placement=)``), both
  dispatches, every impl, topk and expert-choice: against the JAX
  package's layer (its einsum path) at 1e-5, and bit for bit against the
  port's own unplaced layer;
* a 2-layer model's loss, step-0 gradients and ``load_layers`` under a
  ``PerLayerPlacement`` against JAX at 1e-4 of each leaf's scale;
* at world size 1 (a gloo group in this process): the a2a layer with
  shadowed experts and a shrunk capacity, the train step under a plan
  bit-equal to the unplaced one, ``ragged_bound="auto"`` and the
  ``ReplanHook``; the refusals (the psum mode, shadowing with tp); and
  the telemetry sinks of the monitor, the probation and the hook.

The multi-rank cases (gloo 1x2, 1x4, 1x2x2) are in ``test_torch_ep.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import placement as JP  # noqa: E402
from repro.configs.base import MoEConfig as JMoEConfig  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import fmoe as jfmoe  # noqa: E402
from repro.core import monitor as jmon  # noqa: E402
from repro.resilience import ReplanProbation as JProbation  # noqa: E402
from repro_torch import placement as TP  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import fmoe as tfmoe  # noqa: E402
from repro_torch.core import monitor as tmon  # noqa: E402

E = 8
LAYER = dict(num_experts=E, top_k=2, d_expert_hidden=64, capacity_factor=2.0)
# the reference's v5e constants, given explicitly to both packages
V5E = dict(ici_bw=50e9, hbm_bw=819e9, peak_flops=197e12)
PLAN_KW = dict(d_model=256, d_hidden=512, capacity=64)


def _zipf(n, a=1.2, seed=None):
    load = 1.0 / (np.arange(n) + 1) ** a
    if seed is not None:
        load = load[np.random.default_rng(seed).permutation(n)]
    return load / load.sum()


def _consts():
    return (JP.CostConstants(**V5E, source="x"),
            TP.CostConstants(**V5E, source="x"))


def _same_cost(a, b):
    for f in ("a2a_s", "sync_s", "hbm_s", "drop_frac", "total_s"):
        assert abs(getattr(a, f) - getattr(b, f)) <= 1e-12 * max(
            1.0, abs(getattr(a, f))), f


def _same_plan(a, b):
    if isinstance(a, JP.PerLayerPlacement):
        assert isinstance(b, TP.PerLayerPlacement)
        assert len(a.layers) == len(b.layers)
        for pa, pb in zip(a.layers, b.layers):
            _same_plan(pa, pb)
        return
    assert tuple(a) == tuple(b), (a, b)


# ---------------------------------------------------------------------------
# Planner, cost model, controller
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E_,W", [(8, 4), (10, 4), (7, 3), (5, 8), (16, 16)])
def test_greedy_placer_matches_jax(E_, W):
    load = np.random.RandomState(0).rand(E_)
    assert (tmon.expert_placement(E_, W, load)
            == jmon.expert_placement(E_, W, load))
    assert tmon.expert_placement(E_, W) == jmon.expert_placement(E_, W)


@pytest.mark.parametrize("ranks", [1, 2, 4])
@pytest.mark.parametrize("kw", [dict(), dict(shrink_capacity=False),
                                dict(train=False, replan_every=10),
                                dict(d_hidden=64, bytes_per_elem=2)])
def test_plan_and_costs_match_jax(ranks, kw):
    jc, tc = _consts()
    for seed in range(3):
        load = _zipf(16, 1.5, seed)
        args = {**PLAN_KW, **kw}
        jp = JP.plan_placement(load, ranks, constants=jc, **args)
        tp = TP.plan_placement(load, ranks, constants=tc, **args)
        _same_plan(jp, tp)
        ckw = {k: v for k, v in args.items() if k != "shrink_capacity"}
        for S in (0, ranks, 2 * ranks):
            jcand = jp._replace(num_shadow=S)
            tcand = tp._replace(num_shadow=S)
            _same_cost(JP.placement_cost(jcand, load, constants=jc, **ckw),
                       TP.placement_cost(tcand, load, constants=tc, **ckw))
        np.testing.assert_array_equal(tp.logical_to_physical,
                                      jp.logical_to_physical)
        np.testing.assert_array_equal(tp.expert_to_rank, jp.expert_to_rank)
        np.testing.assert_array_equal(tp.replication, jp.replication)
        assert tp.main_capacity(56) == jp.main_capacity(56)


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_per_layer_plan_and_cost_match_jax(ranks):
    jc, tc = _consts()
    load = np.stack([_zipf(16, 1.5, s) for s in range(3)])
    jp = JP.plan_placement_per_layer(load, ranks, constants=jc, **PLAN_KW)
    tp = TP.plan_placement_per_layer(load, ranks, constants=tc, **PLAN_KW)
    _same_plan(jp, tp)
    _same_cost(JP.per_layer_cost(jp, load, constants=jc, **PLAN_KW),
               TP.per_layer_cost(tp, load, constants=tc, **PLAN_KW))
    np.testing.assert_array_equal(tp.logical_to_physical,
                                  jp.logical_to_physical)
    # identical rows degenerate to the shared plan, stacked
    same = np.stack([load[0]] * 3)
    shared = TP.plan_placement(load[0], ranks, constants=tc, **PLAN_KW)
    assert all(p == shared for p in TP.plan_placement_per_layer(
        same, ranks, constants=tc, **PLAN_KW).layers)
    with pytest.raises(ValueError):
        TP.per_layer_placement([TP.identity_placement(16, 2),
                                TP.identity_placement(16, 2)._replace(
                                    num_shadow=2)])


@pytest.mark.parametrize("per_layer", [False, True])
def test_controller_matches_jax(per_layer):
    """The same load series through both controllers: the same replan steps
    and plans, the same flat skips; after a rollback the blacklisted plan
    is never proposed again."""
    jc, tc = _consts()
    L = 2 if per_layer else 0
    mons = [m.LoadMonitor(16, ema=0.5, num_layers=L) for m in (jmon, tmon)]
    kw = dict(PLAN_KW, capacity=4096)  # the wire dominates: shadows pay
    ctls = [P.PlacementController(mon, 4, **kw, every=2, min_gain=0.01,
                                  num_layers=L, constants=c)
            for P, mon, c in ((JP, mons[0], jc), (TP, mons[1], tc))]
    flat = np.full(16, 1 / 16)
    for step in range(1, 13):
        load = flat if step < 4 else _zipf(16, 1.5, step // 6)
        if per_layer:
            load = np.stack([load, load[::-1]])
        for mon in mons:
            mon.update(tfmoe.MoEMetrics(0.0, 0.0, load, 0.0))
        got = [c.maybe_replan(step) for c in ctls]
        assert (got[0] is None) == (got[1] is None), step
        if got[0] is not None:
            _same_plan(*got)
        if step == 8 and got[0] is None:  # roll back the live plan
            prev = [P.identity_per_layer(16, 4, 2) if per_layer
                    else P.identity_placement(16, 4) for P in (JP, TP)]
            bad = [c.current for c in ctls]
            for c, p, b in zip(ctls, prev, bad):
                c.rollback(p, b)
    for f in ("replans", "rollbacks", "flat_skips"):
        assert getattr(ctls[0], f) == getattr(ctls[1], f), f
    assert ctls[1].replans >= 1 and ctls[1].flat_skips >= 1
    assert ctls[1]._is_flat(flat) and not ctls[1]._is_flat(_zipf(16))
    with pytest.raises(ValueError, match="LoadMonitor"):
        TP.PlacementController(tmon.LoadMonitor(16), 4, **PLAN_KW,
                               num_layers=2)


# ---------------------------------------------------------------------------
# Load monitor, calibration, probation
# ---------------------------------------------------------------------------


def test_load_monitor_matches_jax(tmp_path):
    mons = [m.LoadMonitor(E, ema=0.9, num_layers=2, record_every=2)
            for m in (jmon, tmon)]
    rng = np.random.default_rng(3)
    for step in range(7):
        load = rng.random((2, E)) * (np.arange(E) + 1)
        drop = float(rng.random() * 1e-2) if step > 4 else 0.0
        for mon in mons:
            mon.update(tfmoe.MoEMetrics(0.0, 0.0,
                                        load if step % 2 else load.sum(0),
                                        drop))
    j, t = mons
    np.testing.assert_array_equal(t.load_ema, j.load_ema)
    np.testing.assert_array_equal(t.load_ema_layers, j.load_ema_layers)
    assert t.drop_ema == j.drop_ema and t.steps == j.steps
    assert t.snapshot() == j.snapshot() and list(t.history) == list(j.history)
    assert t.imbalance == j.imbalance
    for args in ((64, 2, 4), (64, 2, 2), (100, 1, 8)):
        for guard in (1e-3, 1.0):
            assert (t.suggest_ragged_bound(*args, drop_guard=guard)
                    == j.suggest_ragged_bound(*args, drop_guard=guard))
    cold = tmon.LoadMonitor(E)
    assert cold.suggest_ragged_bound(64, 2, 4) == 128  # never drops cold
    t.dump(tmp_path / "m.json")
    assert (tmp_path / "m.json").read_text().startswith("{")


CALIB = [
    {},
    {"fig8": [{"backend": "cpu", "us_off": 100, "us_on": 50,
               "a2a_elems_off": 4000, "a2a_elems_on": 1000}]},
    {"fig8": [{"backend": "gpu", "us_off": 100, "us_on": 50,
               "a2a_elems_off": 4000, "a2a_elems_on": 1000}],
     "fig3": [{"backend": "gpu", "gflops": 500.0},
              {"backend": "cpu", "gflops": 9e9}]},
    {"fig8": [{"backend": "tpu", "us_off": 50, "us_on": 100,
               "a2a_elems_off": 4000, "a2a_elems_on": 1000}],
     "fig3": [{"backend": "tpu", "gflops": 1e12}]},  # both non-informative
]


@pytest.mark.parametrize("results", CALIB)
def test_calibrate_constants_match_jax(results, tmp_path):
    """The reference's rules on the same dicts: a measured field equals the
    reference's, a field left unmeasured keeps each package's own default
    (the port's: the H100's datasheet numbers, never a TPU's)."""
    import json

    j = JP.calibrate_constants(results)
    t = TP.calibrate_constants(results)
    jd, td = JP.CostConstants(), TP.CostConstants()
    for f in ("ici_bw", "hbm_bw", "peak_flops"):
        if getattr(j, f) != getattr(jd, f):
            assert getattr(t, f) == getattr(j, f), f
        else:
            assert getattr(t, f) == getattr(td, f), f
    assert (t.source.startswith("measured")
            == j.source.startswith("measured"))
    path = tmp_path / "results.json"
    path.write_text(json.dumps(results))
    assert TP.load_calibration(str(path)) == t
    assert TP.load_calibration() == td
    assert TP.load_calibration(str(tmp_path / "missing.json")) == td
    assert (td.hbm_bw, td.peak_flops, td.ici_bw) == (3.35e12, 989e12, 450e9)
    assert "h100" in td.source


SERIES = [
    ([2.0, 2.0, 2.0], [0.0] * 3, 2.0, 0.0),  # commits
    ([2.5, 2.6, 2.4], [0.0] * 3, 2.0, 0.0),  # loss regression
    ([2.0, 2.0, 2.0], [0.2, 0.1, 0.3], 2.0, 0.0),  # drop regression
    ([2.0, float("nan"), 2.2, 2.3], [None] * 4, 2.0, None),  # nan skipped
]


@pytest.mark.parametrize("series", SERIES)
def test_probation_decisions_match_jax(series):
    losses, drops, bl, bd = series
    probs = [P(window=8, loss_tol=1.05, min_samples=3)
             for P in (JProbation, TP.ReplanProbation)]
    for p in probs:
        p.start(10, "old", "new", baseline_loss=bl, baseline_drop=bd)
    for i, (loss, drop) in enumerate(zip(losses, drops)):
        got = [p.observe(11 + i, loss=loss, drop=drop) for p in probs]
        assert tuple(got[0]) == tuple(got[1]), i
        assert probs[0].active == probs[1].active
    for p in probs:  # the window ends: committed
        p.observe(30, loss=bl)
    assert not probs[1].active


@pytest.mark.parametrize("ctor", ["monitor", "probation", "hook"])
def test_sinks_take_records(ctor):
    """The telemetry sink of the monitor (its sampled snapshots), the
    probation (its verdicts) and the train hook (its monitor's snapshots)
    takes their records, as the reference's do."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.balance import MoEMetrics
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh
    from repro_torch.obs.sink import MemorySink

    sink = MemorySink()
    load = np.arange(1.0, E + 1.0)
    if ctor == "monitor":
        mon = tmon.LoadMonitor(E, record_every=1, sink=sink)
        mon.update(MoEMetrics(0.0, 0.0, load, 0.25))
        want = ["load_monitor"]
        assert sink.records[0]["drop_ema"] == pytest.approx(0.0025)
    elif ctor == "probation":
        p = TP.ReplanProbation(window=8, min_samples=3, sink=sink)
        p.start(10, "OLD", "NEW", baseline_loss=1.0)
        for s in (11, 12, 13):
            d = p.observe(s, loss=2.0)
        assert d.rollback
        want = ["replan_rollback"]
        assert sink.records[0]["metric"] == "loss"
        assert sink.records[0]["start"] == 10
    else:
        cfg = reduced(get_config("fastmoe-gpt"))
        hook = train.ReplanHook(cfg, None, Mesh(1, 1), 2, 8, sink=sink)
        hook.observe(0, {"load": np.ones(cfg.moe.num_experts),
                         "drop_frac": 0.0}, {}, None, loss=1.0)
        want = ["load_monitor"]
    assert [r["kind"] for r in sink.records] == want


# ---------------------------------------------------------------------------
# Migration
# ---------------------------------------------------------------------------


def _lm_cfg(pkg="torch", num_layers=2, dispatch="capacity"):
    if pkg == "torch":
        from repro_torch.configs import get_config, reduced
    else:
        from repro.configs import get_config, reduced
    cfg = reduced(get_config("fastmoe-gpt"), num_layers=num_layers,
                  d_model=64)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, num_experts=E, capacity_factor=2.0, dispatch=dispatch))


def _plans(num_layers=2, S=2):
    """A shared and a per-layer plan of both packages (1 rank)."""
    rng = np.random.default_rng(5)
    perms = [tuple(int(i) for i in rng.permutation(E))
             for _ in range(num_layers)]
    out = {}
    for name, P in (("jax", JP), ("torch", TP)):
        shared = P.ExpertPlacement(E, 1, perms[0], num_shadow=S)
        per = P.per_layer_placement([P.ExpertPlacement(E, 1, p, num_shadow=S)
                                     for p in perms])
        out[name] = dict(shared=shared, per_layer=per)
    return out


@pytest.mark.parametrize("kind", ["shared", "per_layer"])
def test_migrate_matches_jax_bit_for_bit(kind):
    from repro.models import lm as jlm
    from repro.optim import AdamW as JAdamW
    from repro_torch import interop
    from repro_torch.optim import AdamW

    cfg = _lm_cfg("jax")
    jparams = jlm.init_params(jax.random.PRNGKey(0), cfg)
    jopt = JAdamW().init(jparams)
    jopt = jopt._replace(mu=jax.tree.map(lambda a: a + 1.0, jopt.mu))
    plans = _plans()
    jplan, tplan = plans["jax"][kind], plans["torch"][kind]
    tcfg = _lm_cfg()
    np_params = jax.tree.map(np.asarray, jparams)
    tparams = interop.from_jax(np_params, tcfg, device="cpu")
    tmu = interop.from_jax(jax.tree.map(np.asarray, jopt.mu), tcfg,
                           device="cpu")
    topt = AdamW().init(tparams)._replace(mu=tmu)
    want = jax.tree.map(np.asarray, JP.from_logical(jparams, jplan))
    want_mu = jax.tree.map(np.asarray, JP.from_logical(jopt.mu, jplan))
    TP.from_logical(tparams, tplan)
    TP.from_logical(topt, tplan)
    got, got_mu = interop.to_jax(tparams), interop.to_jax(topt.mu)
    for a, b in ((got, want), (got_mu, want_mu)):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
    # between two plans, and back to logical: the start, bit for bit
    other = TP.per_layer_placement([TP.ExpertPlacement(
        E, 1, tuple(range(E))[::-1], num_shadow=0)] * 2)
    TP.migrate(tparams, tplan, other)
    want2 = jax.tree.map(np.asarray, JP.migrate(
        JP.from_logical(jparams, jplan), jplan, JP.per_layer_placement(
            [JP.ExpertPlacement(E, 1, tuple(range(E))[::-1])] * 2)))
    for x, y in zip(jax.tree.leaves(interop.to_jax(tparams)),
                    jax.tree.leaves(want2)):
        np.testing.assert_array_equal(x, y)
    TP.to_logical(tparams, other)
    for x, y in zip(jax.tree.leaves(interop.to_jax(tparams)),
                    jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(TP.router_index_table(tplan),
                                  JP.router_index_table(jplan))


def test_migrate_is_in_place_and_refuses_a_per_layer_plan_on_a_layer():
    gen = torch.Generator().manual_seed(0)
    params = tfmoe.fmoe_init(gen, 16, MoEConfig(**LAYER), device="cpu")
    wo = params["experts"]["wo"]
    before = wo.clone()
    plan = TP.ExpertPlacement(E, 1, tuple(range(E))[::-1])
    assert TP.from_logical(params, plan) is params
    assert params["experts"]["wo"] is wo  # the same storage, permuted
    assert torch.equal(wo, before.flip(0))
    with pytest.raises(ValueError, match="per-layer"):
        TP.migrate(params, plan, TP.per_layer_placement([plan, plan]))


# ---------------------------------------------------------------------------
# Dispatch under a plan
# ---------------------------------------------------------------------------


def test_capacity_plan_with_per_expert_capacities_matches_jax():
    ids = np.random.default_rng(2).integers(0, E, (40, 2))
    caps = (4, 8, 2, 8, 8, 1, 8, 3)
    j = JD.make_capacity_plan(jnp.asarray(ids, jnp.int32), E, caps)
    t = TD.make_capacity_plan(torch.from_numpy(ids), E, caps)
    assert t.capacity == j.capacity == 8
    for f in ("positions", "keep", "load"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), f)
    with pytest.raises(ValueError, match="capacities"):
        TD.make_capacity_plan(torch.from_numpy(ids), E, caps[:3])


def test_ec_to_physical_matches_jax():
    grid = np.random.default_rng(4).integers(0, 50, (E, 6))
    table = np.random.default_rng(5).permutation(E)
    np.testing.assert_array_equal(
        TD.ec_to_physical(torch.from_numpy(grid),
                          torch.from_numpy(table)).numpy(),
        np.asarray(JD.ec_to_physical(jnp.asarray(grid), jnp.asarray(table))))
    g = torch.from_numpy(grid)
    assert TD.ec_to_physical(g) is g


# ---------------------------------------------------------------------------
# The MoE layer under a plan
# ---------------------------------------------------------------------------


def _layer_params(d=32):
    gen = torch.Generator().manual_seed(0)
    params = tfmoe.fmoe_init(gen, d, MoEConfig(**LAYER), device="cpu")
    x = torch.randn(64, d, generator=gen)
    return params, x


def _placed(params, plan):
    pp = {k: {n: t.clone() for n, t in v.items()} for k, v in params.items()}
    return TP.from_logical(pp, plan)


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_placed_layer_matches_jax_and_the_unplaced_layer(dispatch, router):
    """Each impl under a permuting plan with shadowed experts: y and load
    against the JAX package's placed layer (einsum) at 1e-5, and bit for
    bit against the port's own unplaced layer; the gradients of sum(y *
    r), mapped back to logical order, equal the unplaced ones."""
    params, x = _layer_params()
    kw = dict(LAYER, dispatch=dispatch, router=router)
    tcfg, jcfg = MoEConfig(**kw), JMoEConfig(**kw)
    plans = _plans(1, S=2)
    jplan, tplan = plans["jax"]["shared"], plans["torch"]["shared"]
    np_params = {k: {n: t.numpy() for n, t in v.items()}
                 for k, v in params.items()}
    jy, jm = jfmoe.fmoe_apply(
        JP.from_logical(jax.tree.map(jnp.asarray, np_params), jplan),
        jnp.asarray(x.numpy()), jcfg, act="swiglu",
        dist=jfmoe.DistConfig.local(placement=jplan))
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(9))
    for impl in ("einsum", "pallas", "fused"):
        res = []
        for plan in (None, tplan):
            p = params if plan is None else _placed(params, plan)
            p = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
                 for k, v in p.items()}
            dist = None if plan is None else tfmoe.DistConfig.local(plan)
            y, m = tfmoe.fmoe_apply(p, x, tcfg, act="swiglu", impl=impl,
                                    dist=dist)
            leaves = [*p["router"].values(), *p["experts"].values()]
            g = torch.autograd.grad((y * r).sum(), leaves)
            gt = {"experts": dict(zip(p["experts"], g[len(p["router"]):]))}
            if plan is not None:
                TP.to_logical(gt, plan)
            res.append((y, m.load, m.drop_frac, list(g[:len(p["router"])]),
                        list(gt["experts"].values())))
        (y0, l0, d0, r0, e0), (y1, l1, d1, r1, e1) = res
        assert torch.equal(y0, y1) and torch.equal(l0, l1), impl
        assert torch.equal(d0, d1)
        for a, b in zip(r0 + e0, r1 + e1):
            assert torch.equal(a, b), impl
        np.testing.assert_allclose(y1.detach().numpy(), np.asarray(jy),
                                   rtol=1e-5, atol=1e-5, err_msg=impl)
        np.testing.assert_allclose(l1.numpy(), np.asarray(jm.load),
                                   atol=1e-6, err_msg=impl)


def test_l2p_table_and_per_layer_refusal():
    """``l2p`` (a per-layer plan's row) routes as the shared plan with that
    table; a whole PerLayerPlacement is refused on a layer."""
    params, x = _layer_params()
    cfg = MoEConfig(**LAYER)
    plan = _plans(1, S=0)["torch"]["shared"]
    pp = _placed(params, plan)
    y0, _ = tfmoe.fmoe_apply(params, x, cfg)
    y1, _ = tfmoe.fmoe_apply(pp, x, cfg,
                             l2p=torch.from_numpy(plan.logical_to_physical))
    assert torch.equal(y0, y1)
    with pytest.raises(TypeError, match="PerLayerPlacement"):
        tfmoe.fmoe_apply(pp, x, cfg, dist=tfmoe.DistConfig.local(
            TP.per_layer_placement([plan, plan])))


def test_model_under_per_layer_plan_matches_jax():
    """A 2-layer reduced fastmoe-gpt under a PerLayerPlacement (local
    carrier): the loss at 1e-4, every step-0 gradient at 1e-4 of its
    leaf's scale, and ``load_layers`` (logical order) against the JAX
    package's ``loss_fn`` with the same plan; and bit for bit against the
    port's unplaced model after ``to_logical``."""
    from repro.models import lm as jlm
    from repro_torch import interop
    from repro_torch.launch.train import loss_and_grads

    jcfg, tcfg = _lm_cfg("jax"), _lm_cfg()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    plans = _plans(2, S=2)
    jplan, tplan = plans["jax"]["per_layer"], plans["torch"]["per_layer"]
    tokens = np.random.default_rng(1).integers(0, 512, (2, 16)).astype(
        np.int32)
    jdist = jfmoe.DistConfig.local(placement=jplan)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                              dist=jdist), has_aux=True))(
        JP.from_logical(jparams, jplan))
    np_params = jax.tree.map(np.asarray, jparams)
    runs = []
    for plan in (None, tplan):
        p = interop.from_jax(np_params, tcfg, device="cpu")
        if plan is not None:
            TP.from_logical(p, plan)
        dist = None if plan is None else tfmoe.DistConfig.local(plan)
        loss, aux, g = loss_and_grads(p, tcfg, {"tokens": tokens},
                                      device="cpu", dist=dist)
        runs.append((loss, aux, g))
    (l0, a0, g0), (l1, a1, g1) = runs
    assert torch.equal(l0, l1)
    assert torch.equal(a0["load_layers"], a1["load_layers"])
    np.testing.assert_allclose(float(l1), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(a1["load_layers"].numpy(),
                               np.asarray(jaux["load_layers"]), atol=1e-6)
    got = interop.to_jax(g1)
    want = jax.tree.map(np.asarray, jg)
    for path, x in jax.tree_util.tree_leaves_with_path(want):
        y = got
        for k in path:
            y = y[k.key]
        scale = max(float(np.abs(x).max()), 1e-30)
        np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=str(path))
    TP.to_logical(g1, tplan)
    for a, b in zip(jax.tree.leaves(interop.to_jax(g0)),
                    jax.tree.leaves(interop.to_jax(g1))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# World size 1: a gloo group in this process
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh1():
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    assert not tdist.is_initialized()
    init_distributed("cpu", rank=0, world_size=1, store=tdist.HashStore())
    try:
        yield make_local_mesh(1, 1)
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_world_size_1_shadowed_a2a_layer(mesh1, dispatch):
    """At one rank the a2a layer under a plan with shadowed experts (the
    filler launch) equals the unplaced local layer bit for bit; a shrunk
    capacity drops exactly the rows the host counts from the routing and
    the two capacities."""
    params, x = _layer_params()
    cfg = MoEConfig(**LAYER, dispatch=dispatch)
    plan = _plans(1, S=2)["torch"]["shared"]
    pp = _placed(params, plan)
    dist = tfmoe.DistConfig(mesh1, ("data", "model"), placement=plan)
    for impl in ("einsum", "pallas", "fused"):
        y0, m0 = tfmoe.fmoe_apply(params, x, cfg, impl=impl)
        y1, m1 = tfmoe.fmoe_apply(pp, x, cfg, impl=impl, dist=dist)
        assert torch.equal(y0, y1) and torch.equal(m0.load, m1.load), impl
    if dispatch == "ragged":
        return
    shrunk = plan._replace(capacity_scale=0.5)
    _, m = tfmoe.fmoe_apply(pp, x, cfg, dist=dist._replace(placement=shrunk))
    from repro_torch.core import gate
    ids = gate.route_tokens(params["router"], x, cfg).expert_ids.numpy()
    C = TD.expert_capacity(64, E, 2, cfg.capacity_factor)
    caps = np.where(np.isin(np.arange(E), plan.physical_to_logical[:6]),
                    shrunk.main_capacity(C), C)
    seen = np.zeros(E, int)
    kept = 0
    for e in ids.T.reshape(-1):  # slot-major, as the plan assigns
        kept += seen[e] < caps[e]
        seen[e] += 1
    assert float(m.drop_frac) == pytest.approx(1 - kept / ids.size, abs=0)
    assert float(m.drop_frac) > 0


def test_world_size_1_placed_train_step_is_bit_equal(mesh1):
    """A train step under a per-layer permuting plan over the 1x1 mesh:
    loss, grad norm and the params after AdamW, mapped back to logical
    order, equal the unplaced step's bit for bit."""
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import lm
    from repro_torch.optim import AdamW

    cfg = _lm_cfg(dispatch="ragged")
    plan = _plans(2, S=0)["torch"]["per_layer"]
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 16)))
    out = []
    for pl in (None, plan):
        params = lm.init_params(cfg, device="cpu", param_dtype="float32")
        opt = AdamW(lr=1e-3)
        state = opt.init(params)
        if pl is not None:
            TP.from_logical(params, pl)
        dist = tfmoe.DistConfig(mesh1, ("data", "model"), placement=pl)
        step = make_train_step(cfg, opt, dist=dist, impl="fused",
                               device="cpu", warmup=1)
        params, state, m = step(params, state, {"tokens": tokens}, 0)
        if pl is not None:
            TP.to_logical(params, pl)
        out.append((params, m))
    (p0, m0), (p1, m1) = out
    assert torch.equal(m0["loss"], m1["loss"])
    assert torch.equal(m0["grad_norm"], m1["grad_norm"])
    from repro_torch.optim.adamw import tree_leaves
    for a, b in zip(tree_leaves(p0), tree_leaves(p1)):
        assert torch.equal(a, b)


def test_auto_ragged_bound_resolves_from_the_monitor():
    """``ragged_bound="auto"``: a cold or missing monitor is the dropless
    0; a warmed skewed one sizes the shard to its peak peer share (and on
    a node mesh the slim inter-node shard); the reference's arithmetic."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import Mesh

    cfg = reduced(get_config("fastmoe-gpt"))  # 4 experts, top-2
    mesh = Mesh(1, 2)
    assert tfmoe.moe_dist(cfg, mesh, 8, ragged_bound="auto").ragged_bound == 0
    mon = tmon.LoadMonitor(4, ema=0.0)
    assert tfmoe.moe_dist(cfg, mesh, 8, seq_len=16, ragged_bound="auto",
                          load_monitor=mon).ragged_bound == 0
    jm = jmon.LoadMonitor(4, ema=0.0)
    for m in (mon, jm):
        m.update(tfmoe.MoEMetrics(0, 0, np.array([0.1, 0.2, 0.3, 0.4]), 0))
    d = tfmoe.moe_dist(cfg, mesh, 8, seq_len=16, ragged_bound="auto",
                       load_monitor=mon)
    assert d.ragged_bound == jm.suggest_ragged_bound(64, 2, 2) == 112
    node = Mesh(1, 2, node=2)
    d = tfmoe.moe_dist(cfg, node, 8, seq_len=16, ragged_bound="auto",
                       load_monitor=mon)
    assert d.ragged_bound == jm.suggest_ragged_bound(32, 2, 4)
    assert d.inter_bound == jm.suggest_ragged_bound(64, 2, 4)
    # at one rank the peak share is everything: dropless
    assert tfmoe.moe_dist(cfg, Mesh(1, 1), 8, seq_len=16,
                          ragged_bound="auto",
                          load_monitor=mon).ragged_bound == 0


def test_replan_hook_at_one_rank_keeps_the_identity(mesh1):
    """At one rank no plan pays for itself (shadowing saves no wire): the
    hook feeds its monitor and never replans; a forced switch migrates the
    live state in place and rebuilds the step."""
    from repro_torch.launch.train import ReplanHook
    from repro_torch.models import lm
    from repro_torch.optim import AdamW

    cfg = _lm_cfg()
    opt = AdamW()
    hook = ReplanHook(cfg, opt, mesh1, 2, 16, every=2, per_layer=True,
                      opts=dict(impl="einsum", device="cpu"))
    assert hook.enabled and hook.controller.num_ranks == 1
    L = cfg.num_layers
    for step in range(8):
        load = np.stack([_zipf(E, 1.5, step + i) for i in range(L)])
        _, _, fn = hook.observe(step, {"load_layers": torch.from_numpy(load),
                                       "loss": torch.tensor(2.0)},
                                None, None)
        assert fn is None
    assert hook.monitor.steps == 8 and hook.controller.replans == 0
    params = lm.init_params(cfg, device="cpu", param_dtype="float32")
    state = opt.init(params)
    w = params["layers"][1]["ffn"]["experts"]["wo"]
    before = w.clone()
    plan = _plans(2, S=0)["torch"]["per_layer"]
    params, state, fn = hook._switch(hook.placement, plan, params, state)
    assert params["layers"][1]["ffn"]["experts"]["wo"] is w
    assert torch.equal(w, before[list(plan.layers[1].physical_to_logical)])
    assert callable(fn)
    with pytest.raises(ValueError, match="load_layers"):
        hook.observe(2, {"load": torch.ones(E)}, params, state)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def test_psum_mode_and_shadowing_with_tp_refuse_a_plan():
    from repro_torch.launch.mesh import Mesh

    params, x = _layer_params()
    cfg = MoEConfig(**LAYER)
    mesh = Mesh(1, 2)
    # the psum mode runs a plan (item 5, ported); its shadowed experts must
    # be laid out as the a2a mode's: a rank's owned block, then the tail
    psum = tfmoe.DistConfig(mesh, (), placement=TP.ExpertPlacement(
        E, 2, tuple(range(E)), num_shadow=2))
    assert psum.mode == "psum"
    with pytest.raises(ValueError, match="placement.migrate lays them out"):
        tfmoe.fmoe_apply(params, x, cfg, dist=psum)
    tp = tfmoe.DistConfig(mesh, ("data", "model"), tp_axis="data",
                          placement=TP.ExpertPlacement(
                              E, 2, tuple(range(E)), num_shadow=2))
    with pytest.raises(NotImplementedError, match="expert-internal TP"):
        tfmoe.fmoe_apply(params, x, cfg, dist=tp)
    wrong = tfmoe.DistConfig(mesh, ("data", "model"),
                             placement=TP.identity_placement(E, 4))
    with pytest.raises(ValueError, match="ranks"):
        tfmoe.fmoe_apply(params, x, cfg, dist=wrong)


def test_train_cli_refuses_auto_bound_without_replans(capsys):
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="replan_every"):
        train.main(["--reduced", "--device", "cpu", "--ragged_bound", "auto"])
    with pytest.raises(SystemExit, match="--mesh"):
        train.main(["--reduced", "--device", "cpu", "--replan_every", "2"])


@pytest.mark.parametrize("chunks", [1, 2])
def test_pipelines_issue_the_filler_once(mesh1, chunks):
    """``fill_fn`` on the three pipelined exchanges (at one rank, a gloo
    group here): called once, its result returned beside the exchange's,
    which equals the exchange without a filler."""
    from repro_torch.core import pipeline

    group = mesh1.group(("model",))
    calls = []

    def fill():
        calls.append(1)
        return torch.ones(3)

    send = torch.randn(1, 8, 4, generator=torch.Generator().manual_seed(0))
    buf = send.reshape(1, 2, 4, 4)
    runs = {
        "ragged": lambda f: pipeline.ragged_pipelined_exchange(
            send, group, 1, chunks, fill_fn=f),
        "hier": lambda f: pipeline.hier_ragged_pipeline(
            send, group, 1, chunks, lambda r, c: r * 2, fill_fn=f),
        "capacity": lambda f: pipeline.pipelined_expert_exchange(
            buf, group, 1, chunks, lambda b: b * 2, fill_fn=f)}
    for name, run in runs.items():
        calls.clear()
        out, filled = run(fill)
        plain, none = run(None)
        assert calls == [1] and torch.equal(filled, torch.ones(3)), name
        assert none is None and torch.equal(out, plain), name
