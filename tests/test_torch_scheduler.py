"""Continuous batching of the port (``launch/scheduler``, ``serve_api``,
the paged KV caches) and temperature sampling, against the JAX package and
on its own, in f32 on the CPU.

* Against the JAX package: one request stream through JAX's
  ``ContinuousBatcher`` and the port's, on reduced ``fastmoe-gpt`` (2
  layers, d_model 256, ragged) and reduced ``deepseek-v2-236b`` (2 layers,
  d_model 64, MLA), params through ``interop.from_jax``: greedy tokens
  equal for every request.  ``gqa_decode_paged`` / ``mla_decode_paged``
  against the reference functions on the same pool, tables and positions
  at 1e-5 (f32 reassociation over <= 32 keys and the projections); the
  written pool equal.  The serve step's logits and metrics (``drop_frac``,
  the per-layer expert load) at 1e-5, ring and paged.
* The port on its own, the reference's ``tests/test_scheduler.py`` cells
  without placement: batched == isolated greedy generation (dense, and
  MoE on ``ragged``, which is dropless), slot reuse under staggered
  arrivals, EOS, paged == ring bit for bit (GQA and MLA; ``max_len`` a
  multiple of ``block_size``, so the view is as long as the ring), block
  reuse under pool pressure, the over-cap refusal, the static policy's
  head-of-line blocking, ``ServeConfig``, ``Completion`` and the null
  block that is never written.  MoE on ``capacity`` is not expected to
  equal isolated generation: C follows the tick's token count, idle slots
  included, as in the reference, so it is not asserted.
* Sampling: temperature 0 is greedy, a seeded generator repeats its
  sequence, and 20000 draws from one logits row match softmax(l / T) by a
  chi-square test (7 degrees of freedom; 24.32 is the 0.999 quantile).
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.attention as JA  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import scheduler as jscheduler  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import serve_api as jserve_api  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.scheduler import ContinuousBatcher  # noqa: E402
from repro_torch.launch.serve_api import (Completion, Request,  # noqa: E402
                                          ServeConfig)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import lm  # noqa: E402

CALL_TOL = dict(rtol=1e-5, atol=1e-5)
CHI2_BOUND = 24.32  # chi-square, 7 degrees of freedom, 0.999 quantile
MODELS = {"gqa": ("fastmoe-gpt", 256, "ragged"),
          "mla": ("deepseek-v2-236b", 64, None)}


def _cfg(kind, get=get_config, red=reduced, arch=None):
    name, d_model, dispatch = MODELS[kind]
    cfg = red(get(arch or name), num_layers=2, d_model=d_model)
    if dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return cfg


@pytest.fixture(scope="module")
def gpt():
    cfg = _cfg("gqa")
    return cfg, lm.init_params(cfg, seed=0, device="cpu")


def _isolated(params, cfg, prompt, n, impl="fused"):
    seq = serve.generate(params, cfg, torch.as_tensor(prompt)[None], n,
                         cache_len=64, impl=impl, device="cpu")
    return seq[0, len(prompt):].tolist()


def _by_id(batcher):
    return {c.request_id: c.tokens for c in batcher.completions}


def _mixed_stream(vocab, n=9, seed=0):
    rng = np.random.RandomState(seed)
    return [(i, rng.randint(0, vocab, rng.randint(3, 20)),
             int(rng.randint(2, 12))) for i in range(n)]


def _run_stream(params, cfg, scfg, reqs, impl="fused"):
    b = ContinuousBatcher(params, cfg, scfg, impl=impl, device="cpu")
    for i, p, n in reqs:
        b.submit(Request(id=i, prompt=p, max_new_tokens=n, arrival=0.0))
    b.run()
    return _by_id(b), b


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(MODELS))
def test_batcher_matches_jax_batcher(kind):
    """The same stream (two prompt lengths, so JAX compiles two prefills)
    through both batchers, paged, 2 slots: every request's greedy tokens
    equal."""
    jcfg, tcfg = _cfg(kind, jget_config, jreduced), _cfg(kind)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(0, tcfg.vocab_size, s), int(rng.randint(2, 8)))
            for i, s in enumerate([5, 9, 5, 9, 5])]
    jb = jscheduler.ContinuousBatcher(jp, jcfg, jserve_api.ServeConfig(
        slots=2, max_len=24, block_size=8))
    for i, p, n in reqs:
        jb.submit(jserve_api.Request(id=i, prompt=p.astype(np.int32),
                                     max_new_tokens=n, arrival=0.0))
    jb.run()
    got, tb = _run_stream(tp, tcfg, ServeConfig(slots=2, max_len=24,
                                                block_size=8), reqs)
    want = {c.request_id: c.tokens for c in jb.completions}
    assert got == want
    assert tb.ticks == jb.ticks


def _pool_inputs(kind, cfg, P=6, bs=4, nb=3, seed=0):
    """A random pool with positions, tables (slot 2 idle: all null) and
    per-slot positions, as numpy."""
    rng = np.random.default_rng(seed)
    a = cfg.attention
    if kind == "gqa":
        shapes = [(P, bs, a.num_kv_heads, a.head_dim)] * 2
    else:
        shapes = [(P, bs, a.kv_lora_rank), (P, bs, a.qk_rope_head_dim)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    positions = np.full((P, bs), -1, np.int32)
    tables = np.array([[2, 3, 0], [4, 5, 0], [0, 0, 0]], np.int32)
    pos = np.array([6, 2, 0], np.int32)
    for slot, upto in ((0, 6), (1, 2)):
        for p in range(upto):
            positions[tables[slot, p // bs], p % bs] = p
    for leaf in leaves:  # the null block stays clean
        leaf[0] = 0.0
    return leaves, positions, tables, pos


@pytest.mark.parametrize("kind", list(MODELS))
def test_paged_decode_matches_jax(kind):
    """``gqa_decode_paged`` / ``mla_decode_paged`` against the reference's
    on the same pool, tables and positions: outputs at 1e-5, the written
    pool equal but for the scratch block (idle slots' writes, whose order
    is not defined) — JAX's and the port's."""
    jcfg, tcfg = _cfg(kind, jget_config, jreduced), _cfg(kind)
    a = tcfg.attention
    key = jax.random.PRNGKey(3)
    if kind == "gqa":
        jp = JA.gqa_init(key, jcfg.d_model, jcfg.attention, jnp.float32)
        jfn, tfn = JA.gqa_decode_paged, TA.gqa_decode_paged
        jcls, tcls = JA.PagedKVCache, TA.PagedKVCache
    else:
        jp = JA.mla_init(key, jcfg.d_model, jcfg.attention, jnp.float32)
        jfn, tfn = JA.mla_decode_paged, TA.mla_decode_paged
        jcls, tcls = JA.PagedMLACache, TA.PagedMLACache
    tp = jax.tree.map(lambda v: torch.from_numpy(np.array(v)), jp)
    leaves, positions, tables, pos = _pool_inputs(kind, tcfg)
    x = np.random.default_rng(1).standard_normal(
        (3, 1, tcfg.d_model)).astype(np.float32)
    for window in (1 << 30, 4):
        jy, jpool = jfn(jp, jnp.asarray(x), jcls(*map(jnp.asarray, leaves),
                                                 jnp.asarray(positions)),
                        jnp.asarray(tables), jnp.asarray(pos), jcfg.attention,
                        window=window)
        tpool = tcls(*(torch.from_numpy(v.copy()) for v in leaves),
                     torch.from_numpy(positions.copy()))
        ty, tpool = tfn(tp, torch.from_numpy(x), tpool,
                        torch.from_numpy(tables), torch.from_numpy(pos), a,
                        window=window)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **CALL_TOL)
        for name, got, want in zip(jcls._fields, tpool, jpool):
            keep = np.arange(got.shape[0]) != TA.SCRATCH_BLOCK
            np.testing.assert_allclose(got.numpy()[keep],
                                       np.asarray(want)[keep], **CALL_TOL,
                                       err_msg=name)
    assert (TA.NULL_BLOCK, TA.SCRATCH_BLOCK, TA.RESERVED_BLOCKS) == \
        (JA.NULL_BLOCK, JA.SCRATCH_BLOCK, JA.RESERVED_BLOCKS)


@pytest.mark.parametrize("paged", [False, True])
def test_serve_step_metrics_match_jax(paged):
    """``lm.decode_step``'s logits and its metrics averaged over the layers
    (``drop_frac``, ``load``) against the reference's serve step (capacity
    dispatch, a slot idle in the paged case) at 1e-5."""
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, dispatch="capacity")) for c in (_cfg("gqa", jget_config,
                                                     jreduced), _cfg("gqa")))
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tok = np.random.default_rng(12).integers(0, 512, (3, 1))
    pos = np.array([0, 0, 0])
    kw = dict(layer_loads=True)
    if paged:
        tables = np.array([[2, 3], [4, 5], [0, 0]], np.int32)
        jstep = jserve.make_serve_step(jcfg, with_metrics=True, paged=True, **kw)
        want = jstep(jp, jnp.asarray(tok), jnp.asarray(pos),
                     jlm.init_paged_cache(jcfg, 6, 4), jnp.asarray(tables))
        got = lm.decode_step(tp, tcfg, torch.from_numpy(tok),
                             torch.from_numpy(pos),
                             lm.init_paged_cache(tcfg, 6, 4, device="cpu"),
                             device="cpu", block_tables=torch.from_numpy(tables))
    else:
        jstep = jserve.make_serve_step(jcfg, with_metrics=True, **kw)
        want = jstep(jp, jnp.asarray(tok), jnp.asarray(pos),
                     jlm.init_cache(jcfg, 3, 8))
        got = lm.decode_step(tp, tcfg, torch.from_numpy(tok),
                             torch.from_numpy(pos),
                             lm.init_cache(tcfg, 3, 8, device="cpu"),
                             device="cpu")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **CALL_TOL)
    L = tcfg.num_layers
    for k, v in (("drop_frac", got[2].drop_frac), ("load", got[2].load)):
        np.testing.assert_allclose((v / L).numpy(), np.asarray(want[2][k]),
                                   **CALL_TOL, err_msg=k)


# ---------------------------------------------------------------------------
# The port's batcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["fastmoe-gpt-dense", "fastmoe-gpt"])
def test_batched_equals_isolated(arch):
    cfg = _cfg("gqa", arch=arch)
    params = lm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=s) for s in (5, 9, 3)]
    out, _ = _run_stream(params, cfg, ServeConfig(slots=2, max_len=64),
                         [(i, p, 6) for i, p in enumerate(prompts)])
    assert sorted(out) == [0, 1, 2]
    for i, p in enumerate(prompts):
        assert out[i] == _isolated(params, cfg, p, 6), i


def test_slots_reused_and_staggered_arrivals(gpt):
    cfg, params = gpt
    rng = np.random.default_rng(1)
    b = ContinuousBatcher(params, cfg, ServeConfig(slots=2, max_len=64),
                          device="cpu")
    first = Request(id=0, prompt=rng.integers(0, cfg.vocab_size, 4),
                    max_new_tokens=3)
    b.submit(first)
    b.step()  # the first request runs alone
    late = Request(id=1, prompt=rng.integers(0, cfg.vocab_size, 7),
                   max_new_tokens=5)
    b.submit(late)  # arrives mid-flight
    b.run()
    out = _by_id(b)
    assert out[0] == _isolated(params, cfg, first.prompt, 3)
    assert out[1] == _isolated(params, cfg, late.prompt, 5)
    for c in b.completions:  # the serving timeline is filled in and ordered
        assert c.queued <= c.first_token <= c.done
        assert len(c.token_times) == len(c.tokens)
        assert all(x >= 0 for x in c.latencies)


def test_eos_frees_slot(gpt):
    cfg, params = gpt
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 4)
    ref = _isolated(params, cfg, prompt, 8)
    b = ContinuousBatcher(params, cfg, ServeConfig(slots=1, max_len=64,
                                                   eos_id=int(ref[2])),
                          device="cpu")
    b.submit(Request(id=0, prompt=prompt, max_new_tokens=8))
    b.run()
    assert _by_id(b)[0] == ref[:ref.index(ref[2]) + 1]
    assert b.slots == [None]


@pytest.mark.parametrize("kind", list(MODELS))
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_paged_matches_ring_bitwise(kind, impl):
    """Decoding through the block-table view equals the per-slot ring bit
    for bit, across admissions, retires, slot reuse and partial tail
    blocks (max_len 48 = 6 blocks of 8)."""
    cfg = _cfg(kind)
    params = lm.init_params(cfg, seed=0, device="cpu")
    reqs = _mixed_stream(cfg.vocab_size, n=9 if kind == "gqa" else 5,
                         seed=0 if kind == "gqa" else 3)
    paged, bp = _run_stream(params, cfg, ServeConfig(
        slots=3, max_len=48, block_size=8, paged=True), reqs, impl)
    ring, br = _run_stream(params, cfg, ServeConfig(
        slots=3, max_len=48, block_size=8, paged=False), reqs, impl)
    assert bp.paged and not br.paged
    assert sorted(paged) == sorted(ring) == list(range(len(reqs)))
    assert paged == ring


def test_block_reuse_under_pool_pressure(gpt):
    """A pool too small for every request at once: admission waits FIFO,
    retired requests' blocks are recycled, every request still equals its
    isolated generation, and the pool drains back to free."""
    cfg, params = gpt
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, 5) for _ in range(3)]
    # each request needs ceil((5 + 6) / 8) = 2 blocks; 3 usable blocks
    # (5 minus the 2 reserved), so two can never run together
    b = ContinuousBatcher(params, cfg, ServeConfig(
        slots=2, max_len=16, block_size=8, num_blocks=5), device="cpu")
    assert b.allocator.free_blocks == 3
    for i, p in enumerate(prompts):
        b.submit(Request(id=i, prompt=p, max_new_tokens=6))
    b.run()
    out = _by_id(b)
    for i, p in enumerate(prompts):
        assert out[i] == _isolated(params, cfg, p, 6)
    assert b.allocator.free_blocks == 3  # every block returned
    assert (b.tables == TA.NULL_BLOCK).all()


def test_null_block_never_written(gpt):
    """After a stream with idle slots (their writes go to the scratch
    block), the null block of every layer's pool is as it was made."""
    cfg, params = gpt
    _, b = _run_stream(params, cfg, ServeConfig(slots=3, max_len=48,
                                                block_size=8),
                       _mixed_stream(cfg.vocab_size, n=5, seed=7))
    assert b.ticks > 0
    for pool in b.pool:
        assert (pool.positions[TA.NULL_BLOCK] == -1).all()
        assert not pool.k[TA.NULL_BLOCK].any()
        assert not pool.v[TA.NULL_BLOCK].any()
    assert any((pool.positions[TA.SCRATCH_BLOCK] >= 0).any()
               for pool in b.pool)  # idle slots did write somewhere


def test_submit_rejects_over_cap(gpt):
    cfg, params = gpt
    b = ContinuousBatcher(params, cfg, ServeConfig(slots=1, max_len=16),
                          device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        b.submit(Request(id=0, prompt=np.zeros(12, np.int64),
                         max_new_tokens=8))


def test_static_policy_head_of_line_blocks(gpt):
    """policy="static" admits only at whole-batch boundaries: short
    requests wait on the batch's longest, costing ticks the continuous
    policy saves, on the same decode path, so the tokens are equal."""
    cfg, params = gpt
    rng = np.random.default_rng(5)
    reqs = [(i, rng.integers(0, cfg.vocab_size, 4), n)
            for i, n in enumerate([2, 8, 2, 8])]

    def drive(policy):
        out, b = _run_stream(params, cfg, ServeConfig(
            slots=2, max_len=16, block_size=8, policy=policy), reqs)
        return out, b.ticks

    cont, t_cont = drive("continuous")
    stat, t_stat = drive("static")
    assert cont == stat
    assert t_stat > t_cont


def test_serve_config_from_args():
    args = SimpleNamespace(batch=4, slots=None, block_size=32, max_len=None,
                           policy="static", mesh=None)
    scfg = ServeConfig.from_args(args)
    assert scfg.slots == 4  # --batch maps onto slots when --slots is absent
    assert scfg.block_size == 32 and scfg.policy == "static"
    assert scfg.max_len == 256
    args.slots = 16
    assert ServeConfig.from_args(args).slots == 16  # explicit slots wins
    scfg = ServeConfig(slots=8, max_len=160, block_size=16, mesh="1x4")
    assert (scfg.blocks_per_slot, scfg.pool_blocks) == (10, 82)
    assert scfg.mesh_shape() == (1, 4)
    with pytest.raises(ValueError, match="policy"):
        ServeConfig(policy="batched")
    assert (scfg.replan_every, scfg.per_layer_plans) == (0, True)
    args.replan_every, args.per_layer_plans = 4, False  # the serve-time replan
    scfg = ServeConfig.from_args(args)
    assert (scfg.replan_every, scfg.per_layer_plans) == (4, False)
    for name in ("metrics_out", "trace"):  # telemetry (item 7): no field
        with pytest.raises(TypeError, match=name):
            ServeConfig(**{name: 1})


def test_completion_latencies():
    c = Completion(request_id=0, tokens=[1, 2, 3], prompt_len=4, queued=10.0,
                   first_token=10.5, done=10.7,
                   token_times=[10.5, 10.6, 10.7])
    assert c.ttft == pytest.approx(0.5)
    assert c.latencies == pytest.approx([0.5, 0.1, 0.1])
    stats = serve.serving_stats([c], 1.0, 3)
    assert stats["tokens"] == 3 and stats["ttft_p50"] == pytest.approx(0.5)
    assert stats["token_p50"] == pytest.approx(0.1)


# ---------------------------------------------------------------------------
# Temperature sampling
# ---------------------------------------------------------------------------


def test_temperature_zero_is_greedy(gpt):
    cfg, params = gpt
    prompt = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 6)))
    greedy = serve.generate(params, cfg, prompt, 5, cache_len=16, device="cpu")
    zero = serve.generate(params, cfg, prompt, 5, cache_len=16, device="cpu",
                          temperature=0.0,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(greedy, zero)


def test_seeded_sampling_repeats(gpt):
    cfg, params = gpt
    prompt = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 6)))
    runs = [serve.generate(params, cfg, prompt, 8, cache_len=16, device="cpu",
                           temperature=1.0,
                           generator=torch.Generator().manual_seed(seed))
            for seed in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="Generator"):
        serve.sample(torch.zeros(1, 4), temperature=1.0)


def test_sampling_frequencies_match_softmax():
    V, N, T = 8, 20000, 0.7
    logits = torch.from_numpy(np.random.default_rng(10).standard_normal(
        V).astype(np.float32))
    draws = serve.sample(logits.expand(N, V), T,
                         torch.Generator().manual_seed(11))
    assert draws.shape == (N, 1)
    counts = torch.bincount(draws[:, 0], minlength=V).double()
    expect = N * torch.softmax(logits.double() / T, -1)
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < CHI2_BOUND, (chi2, counts.tolist(), expect.tolist())


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_continuous(capsys):
    serve.main(["--continuous", "--reduced", "--device", "cpu", "--slots", "2",
                "--requests", "3", "--prompt_len", "8", "--gen", "4",
                "--block_size", "4"])
    out = capsys.readouterr().out
    assert "continuous (continuous, paged, 2 slots): 3 requests, 12 tokens" \
        in out, out
    assert "TTFT p50" in out and "per-token p50" in out
