"""Serving under expert placement (ROADMAP §1 item 5) in the port, against
the JAX package on the same numpy inputs, in f32 on the CPU:

* the slot-wise combines of the placed psum mode
  (``dispatch.combine_capacity_slots``, ``combine_ragged_slots``: the
  ``combine_topk`` kernel's plain version at k = 1) and the shadow addend
  (``shadow_only``), bit for bit, and the ragged one in bf16 too;
* ``lm.decode_step(layer_loads=True)``: the (L, E) loads and
  ``drop_frac`` at 1e-5, ring and paged, unplaced and under a per-layer
  plan (the loads in logical order whatever the layout);
* ``serve.plan_for_serving``: the plan, as equal tuples, and the migrated
  expert leaves, the same cost constants given to both packages (their
  defaults differ: the card's here, the reference's own there);
* ``scheduler.ServeReplanHook``: the replan ticks, the plans it applies
  and its rollback on a scripted series of loads and drops, through a stub
  batcher that records ``apply_placement``, against the reference's hook,
  and the records its telemetry sink takes against the reference's;
* ``ServeConfig.from_args`` with the replan and telemetry fields, and the
  one-process batcher: the identity plan from tick 0 (one rank: no
  replan), and a mid-stream ``apply_placement``, both leaving the tokens
  unchanged;
* the refusal that stands: a node axis in serving.

The placed psum layer across ranks, the placed psum train step and the
batchers on 1x2 and 2x2 meshes ride ``tests/test_torch_ep.py``'s spawns.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.placement as JP  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core.fmoe import DistConfig as JDist  # noqa: E402
from repro.launch import scheduler as jscheduler  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import serve_api as jserve_api  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.placement.shadow import shadow_only as jshadow_only  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import placement as TP  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import dispatch as D  # noqa: E402
from repro_torch.core.fmoe import DistConfig  # noqa: E402
from repro_torch.launch import scheduler, serve  # noqa: E402
from repro_torch.launch.serve_api import Request, ServeConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
E, T, K, DOUT = 8, 24, 2, 16


def _routing(seed=0):
    g = np.random.default_rng(seed)
    ids = np.stack([g.choice(E, K, replace=False) for _ in range(T)])
    w = g.random((T, K)).astype(np.float32)
    return ids.astype(np.int32), w / w.sum(1, keepdims=True)


# ---------------------------------------------------------------------------
# The slot-wise combines and the shadow addend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [4, (4, 4, 4, 4, 4, 4, 8, 8)])
def test_combine_capacity_slots_matches_jax(capacity):
    """Capacity 4 drops rows (24 tokens x 2 over 8 experts), and the
    per-expert capacities of a placement's shadowed tail: the per-slot
    weighted outputs (T, k, dout) bit for bit."""
    ids, w = _routing()
    width = capacity if isinstance(capacity, int) else max(capacity)
    out = np.random.default_rng(1).standard_normal(
        (E, width, DOUT)).astype(np.float32)
    jp = JD.make_capacity_plan(jnp.asarray(ids), E, capacity)
    tp = D.make_capacity_plan(torch.from_numpy(ids).long(), E, capacity)
    assert not bool(np.asarray(jp.keep).all())  # the capacity drops
    want = JD.combine_capacity_slots(jnp.asarray(out), jp, jnp.asarray(w))
    got = D.combine_capacity_slots(torch.from_numpy(out), tp,
                                   torch.from_numpy(w))
    assert got.shape == (T, K, DOUT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_ragged_slots_matches_jax(dtype):
    """The ragged per-slot outputs through ``combine_topk`` at k = 1: bit
    for bit, f32 and bf16 (the kernel's f32 product rounded once is the
    bf16 product)."""
    ids, w = _routing(2)
    ys = np.random.default_rng(3).standard_normal((T * K, DOUT)).astype(
        np.float32)
    jp = JD.make_ragged_plan(jnp.asarray(ids), E)
    tp = D.make_ragged_plan(torch.from_numpy(ids).long(), E)
    want = JD.combine_ragged_slots(jnp.asarray(ys, dtype), jp, jnp.asarray(w))
    got = D.combine_ragged_slots(
        torch.from_numpy(ys).to(getattr(torch, dtype)), tp,
        torch.from_numpy(w))
    assert got.shape == (T, K, DOUT) and got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_shadow_only_matches_jax():
    """The shadowed experts' outputs alone in the zeroed combine buffer,
    under a plan with 2 shadowed experts (and the re-export under
    ``placement``)."""
    assert TP.shadow_only is D.shadow_only
    perm = tuple(range(E))[::-1]
    jspec = JP.shadow_spec(JP.ExpertPlacement(E, 2, perm, num_shadow=2), E, 8)
    tspec = D.shadow_spec(TP.ExpertPlacement(E, 2, perm, num_shadow=2), E, 8)
    assert tuple(jspec) == tuple(tspec)
    out = np.random.default_rng(4).standard_normal((2, 8, DOUT)).astype(
        np.float32)
    got = D.shadow_only(torch.from_numpy(out), tspec)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jshadow_only(jnp.asarray(out),
                                                          jspec)))


# ---------------------------------------------------------------------------
# The decode step's loads
# ---------------------------------------------------------------------------


def _gpt(get, red, dispatch="capacity", experts=4):
    cfg = red(get("fastmoe-gpt"), num_layers=2, d_model=64,
              max_experts=experts)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))


@pytest.fixture(scope="module")
def gpt():
    jcfg, tcfg = _gpt(jget_config, jreduced), _gpt(get_config, reduced)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("paged", [False, True])
def test_decode_step_layer_loads_match_jax(gpt, paged, placed):
    """``decode_step(layer_loads=True)``'s fourth output, the (L, E) loads
    in logical order, and the drop fraction against the reference's serve
    step (capacity; a slot idle in the paged case) at 1e-5;
    placed: under a per-layer plan (a permutation per layer, the params in
    its order, the local carrier), whose loads are the unplaced ones."""
    jcfg, tcfg, jp, jp_np = gpt
    n = tcfg.moe.num_experts
    dist = jdist = None
    tp = interop.from_jax(jp_np, tcfg, device="cpu")
    if placed:
        perms = [(1, 3, 0, 2), (2, 0, 3, 1)]
        tplan = TP.per_layer_placement([TP.ExpertPlacement(n, 1, p)
                                        for p in perms])
        jplan = JP.per_layer_placement([JP.ExpertPlacement(n, 1, p)
                                        for p in perms])
        TP.from_logical(tp, tplan)
        jp = JP.from_logical(jp, jplan)
        dist, jdist = DistConfig.local(tplan), JDist.local(jplan)
    tok = np.random.default_rng(12).integers(0, 512, (3, 1))
    pos = np.array([0, 0, 0])
    step = jserve.make_serve_step(jcfg, dist=jdist, with_metrics=True,
                                  paged=paged, layer_loads=True)
    kw = dict(device="cpu", dist=dist, layer_loads=True)
    if paged:
        tables = np.array([[2, 3], [4, 5], [0, 0]], np.int32)
        want = step(jp, jnp.asarray(tok), jnp.asarray(pos),
                    jlm.init_paged_cache(jcfg, 6, 4), jnp.asarray(tables))
        got = lm.decode_step(tp, tcfg, torch.from_numpy(tok),
                             torch.from_numpy(pos),
                             lm.init_paged_cache(tcfg, 6, 4, device="cpu"),
                             block_tables=torch.from_numpy(tables), **kw)
    else:
        want = step(jp, jnp.asarray(tok), jnp.asarray(pos),
                    jlm.init_cache(jcfg, 3, 8))
        got = lm.decode_step(tp, tcfg, torch.from_numpy(tok),
                             torch.from_numpy(pos),
                             lm.init_cache(tcfg, 3, 8, device="cpu"), **kw)
    assert len(got) == 4 and got[3].shape == (tcfg.num_layers, n)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_allclose(got[3].numpy(),
                               np.asarray(want[2]["load_layers"]), **TOL)
    L = tcfg.num_layers
    np.testing.assert_allclose(float(got[2].drop_frac) / L,
                               float(want[2]["drop_frac"]), **TOL)
    np.testing.assert_allclose(got[2].load.numpy() / L,
                               np.asarray(want[2]["load"]), **TOL)


# ---------------------------------------------------------------------------
# plan_for_serving and the ServeReplanHook
# ---------------------------------------------------------------------------


def _plan_tuple(plan):
    layers = plan.layers if hasattr(plan, "layers") else (plan,)
    return [(p.num_experts, p.num_ranks, tuple(int(i) for i in
                                               p.physical_to_logical),
             p.num_shadow, float(p.capacity_scale)) for p in layers]


def _same_constants(monkeypatch):
    """The port's default constants (the card's) given to the reference's
    ``load_calibration`` too."""
    const = TP.load_calibration()
    monkeypatch.setattr(JP, "load_calibration",
                        lambda *a, **k: JP.CostConstants(*const[:3]))
    return const


@pytest.mark.parametrize("per_layer", [True, False])
def test_plan_for_serving_matches_jax(monkeypatch, per_layer):
    """8 experts over 2 ranks, a (4, 8) prompt: the per-layer plan (or the
    shared one on the summed load) and the params migrated into its order
    equal the reference's."""
    jcfg = _gpt(jget_config, jreduced, experts=8)
    tcfg = _gpt(get_config, reduced, experts=8)
    const = _same_constants(monkeypatch)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jp_np = jax.tree.map(np.asarray, jp)
    prompt = np.random.default_rng(5).integers(0, 512, (4, 8)).astype(np.int32)
    jplan, jmoved = jserve.plan_for_serving(jp, jcfg, jnp.asarray(prompt), 2,
                                            per_layer=per_layer)
    tp = interop.from_jax(jp_np, tcfg, device="cpu")
    tplan, tmoved = serve.plan_for_serving(tp, tcfg, prompt, 2,
                                           per_layer=per_layer, device="cpu",
                                           constants=const)
    assert tmoved is tp  # migrated in place
    assert _plan_tuple(tplan) == _plan_tuple(jplan)
    assert hasattr(tplan, "layers") == per_layer
    want = np.asarray(jmoved["layers"]["ffn"]["experts"]["wo"])
    for i, layer in enumerate(tmoved["layers"]):
        np.testing.assert_array_equal(layer["ffn"]["experts"]["wo"].numpy(),
                                      want[i])


class _Stub:
    """What a ServeReplanHook reads of its batcher, recording the plans it
    applies."""

    def __init__(self, cfg, slots):
        self.cfg, self.B, self.applied = cfg, slots, []

    def apply_placement(self, plan):
        self.applied.append(plan)


HOOK_TICKS = 24
HOOK_DROPS = [0.0] * 4 + [0.3] * 4 + [0.0] * 16  # regresses after tick 4


def _hook_series(hook, n_layers, n_experts):
    """Feed the scripted series; returns [(tick, replans, rollbacks)] at
    each tick where a counter moved."""
    g = np.random.default_rng(9)
    skew = 1.0 / (np.arange(n_experts) + 1) ** 1.5
    events, seen = [], (0, 0)
    for tick in range(1, HOOK_TICKS + 1):
        load = np.stack([np.roll(skew, 3 * layer) for layer in
                         range(n_layers)]) * (1 + 0.05 * g.random())
        hook.observe(tick, {"drop_frac": HOOK_DROPS[tick - 1],
                            "load_layers": load.astype(np.float32),
                            "load": load.sum(0).astype(np.float32)})
        now = (hook.controller.replans, hook.controller.rollbacks)
        if now != seen:
            events.append((tick, *now))
            seen = now
    return events


@pytest.mark.parametrize("per_layer", [True, False])
def test_serve_replan_hook_matches_the_reference(monkeypatch, per_layer):
    """The port's hook and the reference's, each forced to accept a plan
    (min_gain -10), on the same skewed loads (every tick: every 4 ticks
    gives sync_every 1) and a drop fraction that regresses after the
    replan: the same replan tick and plan, the same rollback (to the plan
    before it, which is then blacklisted), and then the same later
    replans."""
    jcfg = _gpt(jget_config, jreduced, experts=8)
    tcfg = _gpt(get_config, reduced, experts=8)
    _same_constants(monkeypatch)
    stubs, events = [], []
    for make, cfg in ((jscheduler.ServeReplanHook, jcfg),
                      (scheduler.ServeReplanHook, tcfg)):
        stub = _Stub(cfg, 4)
        hook = make(stub, 2, every=4, per_layer=per_layer)
        hook.controller.min_gain = -10.0
        assert hook.sync_every == 1 and hook.probation.window == 4
        events.append(_hook_series(hook, cfg.num_layers,
                                   cfg.moe.num_experts))
        stubs.append(stub)
    assert events[0] == events[1], events
    assert any(e[2] == 1 for e in events[1]), events  # a rollback
    assert ([_plan_tuple(p) for p in stubs[0].applied]
            == [_plan_tuple(p) for p in stubs[1].applied])
    assert len(stubs[1].applied) >= 2  # the replan and its rollback


# ---------------------------------------------------------------------------
# ServeConfig and the one-process batcher
# ---------------------------------------------------------------------------


def test_serve_config_takes_the_replan_fields():
    """``from_args`` takes replan_every, per_layer_plans and the telemetry
    fields (metrics_out, trace) as the reference's does; its CLI's model
    fields are not ServeConfig's here."""
    args = SimpleNamespace(batch=4, slots=None, block_size=None, max_len=None,
                           policy=None, mesh="2x2", replan_every=8,
                           per_layer_plans=False, metrics_out="m.jsonl",
                           trace="t.json")
    got = ServeConfig.from_args(args)
    want = jserve_api.ServeConfig.from_args(args)
    for f in dataclasses.fields(ServeConfig):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.mesh_shape() == (2, 2)
    assert ServeConfig().replan_every == 0 and ServeConfig().per_layer_plans


def _tokens(batcher):
    return {c.request_id: c.tokens for c in batcher.completions}


def test_one_process_batcher_under_placement(gpt):
    """Ragged (dropless), 2 slots: with replan_every the identity plan is
    engaged from tick 0 and one rank never replans; a permutation applied
    mid-stream (params migrated in place) leaves every token as the
    unplaced run's."""
    _, tcfg, _, jp_np = gpt
    cfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, dispatch="ragged"))
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(0, cfg.vocab_size, 4 + i % 3), 3 + i % 4)
            for i in range(5)]

    def run(scfg, switch=None):
        b = scheduler.ContinuousBatcher(
            interop.from_jax(jp_np, cfg, device="cpu"), cfg, scfg,
            device="cpu")
        for i, p, n in reqs:
            b.submit(Request(id=i, prompt=p, max_new_tokens=n, arrival=0.0))
        while b.queue or any(s is not None for s in b.slots):
            b.step()
            if b.ticks == 2 and switch is not None:
                b.apply_placement(switch)
        return b

    base = run(ServeConfig(slots=2, max_len=16, block_size=4))
    hooked = run(ServeConfig(slots=2, max_len=16, block_size=4,
                             replan_every=2))
    assert hooked.replans == 0 and hooked.plan.is_identity
    assert _tokens(hooked) == _tokens(base)
    n = cfg.moe.num_experts
    moved = run(ServeConfig(slots=2, max_len=16, block_size=4),
                switch=TP.ExpertPlacement(n, 1, tuple(range(n))[::-1]))
    assert moved.replans == 1 and _tokens(moved) == _tokens(base)


def test_serve_hook_sink_takes_the_references_records(monkeypatch):
    """The port's hook and the reference's, each with an in-memory sink, on
    the scripted series of test_serve_replan_hook_matches_the_reference:
    the same records (replan, replan_rollback, replan_commit) at the same
    ticks, in the same order."""
    from repro.obs.sink import MemorySink as JSink
    from repro_torch.obs.sink import MemorySink

    jcfg = _gpt(jget_config, jreduced, experts=8)
    tcfg = _gpt(get_config, reduced, experts=8)
    _same_constants(monkeypatch)
    got = []
    for make, cfg, sink in ((jscheduler.ServeReplanHook, jcfg, JSink()),
                            (scheduler.ServeReplanHook, tcfg, MemorySink())):
        stub = _Stub(cfg, 4)  # the port's hook holds it weakly
        hook = make(stub, 2, every=4, per_layer=True, sink=sink)
        hook.controller.min_gain = -10.0
        _hook_series(hook, cfg.num_layers, cfg.moe.num_experts)
        got.append([(r["kind"], r["step"]) for r in sink.records])
    assert got[0] == got[1], got
    kinds = [k for k, _ in got[1]]
    assert "replan" in kinds and "replan_rollback" in kinds, kinds


def test_refusals_that_stand(gpt):
    """A node axis in serving."""
    with pytest.raises(NotImplementedError, match="node axis"):
        ServeConfig(mesh="1x2x2").mesh_shape()
