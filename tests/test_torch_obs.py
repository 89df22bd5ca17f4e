"""Telemetry of the port (``repro_torch.obs``) against the JAX package's
``repro.obs``, case for case with ``tests/test_obs.py``, on the CPU:

* the counters: the single-worker layer's against the JAX layer's (both
  dispatches, a capacity that drops), their '+' accumulation, and at
  world size 1 (a gloo group in this process) the exchange sizes by hand
  (serial, bf16 wire, the shifts, ragged, the psum mode) and the
  collective tally equal with the counters on and off (the multi-rank
  counters against JAX's, and the tally on and off at 1x2, 2x2 and 1x4,
  ride ``tests/test_torch_ep.py``'s spawns);
* the span tracer, the sinks (tensors coerced, bf16 too), the load
  monitor's history and sink, ``StepStats`` and the tally it reads;
* serving: a decode step's packed metrics against the JAX serve step's;
* the train and serve CLIs with ``--metrics_out`` and ``--trace``, in
  this process (the train CLI over a world-size-1 gloo mesh).
"""
import json
import socket
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import dist_utils as du  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core import fmoe as tfmoe  # noqa: E402
from repro_torch.core.balance import MoEMetrics  # noqa: E402
from repro_torch.core.dispatch import expert_capacity  # noqa: E402
from repro_torch.core.monitor import LoadMonitor  # noqa: E402
from repro_torch.obs import sink as obs_sink  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.counters import ObsCounters  # noqa: E402
from repro_torch.obs.stats import StepStats, modeled_collective_bytes  # noqa: E402

COUNTERS = ObsCounters._fields


def _port_env(env):
    """The JAX env's layer as the port's: its config, params and input."""
    c = env.cfg
    cfg = MoEConfig(num_experts=c.num_experts, top_k=c.top_k,
                    d_expert_hidden=c.d_expert_hidden,
                    capacity_factor=c.capacity_factor, dispatch=c.dispatch)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return torch.from_numpy(np.array(t))
    x = torch.from_numpy(np.array(env.x)).reshape(-1, env.x.shape[-1])
    return cfg, conv(env.params), x


def _counters(m) -> dict:
    return {k: float(v) for k, v in m.obs.as_dict().items()}


# ---------------------------------------------------------------------------
# Counters: single-worker semantics and accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
def test_local_counters_single_device(dispatch):
    """No dist: nothing crosses a wire; dropped = drop_frac * (T * k); each
    counter equals the JAX layer's."""
    env = du.moe_env(capacity_factor=0.5, dispatch=dispatch)
    _, jm = du.oracle(env)
    cfg, params, x = _port_env(env)
    _, m = tfmoe.fmoe_apply(params, x, cfg)
    got = _counters(m)
    T = x.shape[0]
    assert got["wire_elems"] == got["wire_bytes"] == 0.0
    assert got["shadow_hits"] == 0.0 and got["imbalance"] == 1.0
    if dispatch == "capacity":
        assert float(m.drop_frac) > 0.0
    np.testing.assert_allclose(got["dropped"], float(m.drop_frac) * T * 2,
                               rtol=1e-5)
    for k in COUNTERS:
        np.testing.assert_allclose(got[k], float(getattr(jm.obs, k)),
                                   rtol=1e-5, err_msg=k)


def test_counters_accumulate_like_metrics():
    """ObsCounters is '+'-accumulable (the layers sum it), floats and
    tensors alike, and MoEMetrics sums it (None on either side keeps the
    other)."""
    a = ObsCounters(*(torch.tensor(v) for v in (1, 2, 3, 4, 1.5, 0.25, 0.75)))
    b = ObsCounters(10.0, 20.0, 30.0, 40.0, 0.5, 1.0, 19.0)
    s = a + b
    assert [float(v) for v in s] == [11, 22, 33, 44, 2.0, 1.25, 19.75]
    z = ObsCounters.zero()
    assert [float(v) for v in (z + a)] == [float(v) for v in a]
    assert set(a.as_dict()) == {"wire_elems", "wire_bytes", "dropped",
                                "shadow_hits", "imbalance",
                                "wire_bytes_intra", "wire_bytes_inter"}
    t = b.tensors("cpu")
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               for v in t)
    m = MoEMetrics.zero(4, "cpu") + MoEMetrics(*(torch.zeros(()),) * 2,
                                               torch.ones(4),
                                               torch.zeros(()), b)
    assert [float(v) for v in m.obs] == [float(v) for v in b]
    plain = MoEMetrics(0.0, 0.0, np.ones(4), 0.0)
    assert plain.obs is None and (plain + plain).obs is None


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


def test_wire_counters_match_hand_math(mesh1):
    """The exchange sizes at one rank (mp = 1), as the reference's hand
    math counts them: the serial capacity exchange moves (E, C, d) each
    way plus the int32 counts; the bf16 wire halves the payload bytes and
    keeps the counts int32; the shifts move (mp - 1) / mp of every leg,
    nothing at one rank; the ragged exchange B = t * k rows a peer; the
    psum mode one (t, d) all-reduce.  The serial exchange's payload bytes
    are those the collective tally saw (forward only, no_grad)."""
    env = du.moe_env()
    cfg, params, x = _port_env(env)
    t, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = expert_capacity(t, E, k, cfg.capacity_factor)
    axes = ("data", "model")

    def run(cfg, **kw):
        comm.tally_reset()
        with torch.no_grad():
            _, m = tfmoe.fmoe_apply(params, x, cfg,
                                    dist=tfmoe.DistConfig(mesh1, **kw))
        return _counters(m), comm.tallied(), comm.tallied_calls()

    got, byts, calls = run(cfg, token_axes=axes)
    elems = E * C * d * 2 + E
    assert got["wire_elems"] == elems and got["wire_bytes"] == 4 * elems
    assert got["wire_bytes_intra"] == 0.0
    assert got["wire_bytes_inter"] == got["wire_bytes"]
    assert got["dropped"] == 0.0 and got["shadow_hits"] == 0.0
    assert got["imbalance"] == 1.0  # one expert rank
    assert calls["all-to-all"] == 3  # counts, dispatch, return
    assert byts["all-to-all"] - got["wire_bytes"] == E * 4  # int64 counts

    got, _, _ = run(cfg, token_axes=axes, wire_dtype="bf16")
    assert got["wire_bytes"] == E * C * d * 2 * 2 + E * 4

    got, byts, _ = run(cfg, token_axes=axes, overlap_chunks=2)
    assert got["wire_bytes"] == 0.0 and got["wire_elems"] == 0.0
    assert byts.get("collective-permute", 0) == 0  # no shift at one rank

    import dataclasses
    rcfg = dataclasses.replace(cfg, dispatch="ragged")
    got, _, _ = run(rcfg, token_axes=axes)
    elems = t * k * d * 2 + E
    assert got["wire_elems"] == elems and got["wire_bytes"] == 4 * elems

    got, byts, _ = run(cfg, token_axes=())  # the psum mode
    assert got["wire_elems"] == t * d and got["wire_bytes"] == t * d * 4
    assert byts["all-reduce"] >= t * d * 4


@pytest.mark.parametrize("dispatch,kw", [
    ("capacity", {}), ("capacity", dict(overlap_chunks=2, wire_dtype="bf16")),
    ("ragged", {}), ("ragged", dict(ragged_bound=24))])
def test_obs_off_leaves_collectives_the_same(mesh1, dispatch, kw):
    """DistConfig.obs gates the counters; the collectives of a layer's
    forward and backward (the tally's calls and bytes by op) are the same
    with them on and off, and so is the output."""
    import dataclasses
    env = du.moe_env(dispatch=dispatch)
    cfg, params, x = _port_env(env)
    seen = {}
    for obs in (True, False):
        p = {g: {n: v.clone().requires_grad_() for n, v in leaves.items()}
             for g, leaves in params.items()}
        comm.tally_reset()
        y, m = tfmoe.fmoe_apply(p, x, dataclasses.replace(cfg),
                                dist=tfmoe.DistConfig(mesh1, ("data", "model"),
                                                      obs=obs, **kw))
        y.sum().backward()
        seen[obs] = (comm.tallied_calls(), comm.tallied(), y.detach(),
                     _counters(m))
    assert seen[True][0] == seen[False][0]
    assert seen[True][1] == seen[False][1]
    assert torch.equal(seen[True][2], seen[False][2])
    assert all(v == 0.0 for v in seen[False][3].values())
    # the shifts keep the one rank's slice at home: no wire at mp = 1
    assert (seen[True][3]["wire_elems"] > 0.0) != ("overlap_chunks" in kw)


# ---------------------------------------------------------------------------
# Span tracer
# ---------------------------------------------------------------------------


def test_tracer_nesting_and_export_roundtrip(tmp_path):
    tr = obs_trace.Tracer(enabled=True)
    with tr.span("outer", step=1) as s:
        assert isinstance(s, dict)
        with tr.span("inner"):
            pass
        s["tokens"] = 7  # the body can attach results to the span args
    evs = tr.events
    assert [e["name"] for e in evs] == ["inner", "outer"]  # close order
    inner, outer = evs
    assert outer["args"]["depth"] == 0 and inner["args"]["depth"] == 1
    assert outer["args"]["tokens"] == 7 and outer["args"]["step"] == 1
    assert outer["dur"] >= inner["dur"] >= 0
    path = tr.export(str(tmp_path / "trace.json"))
    back = obs_trace.load_trace(path)
    assert back["traceEvents"] == evs
    assert all(e["ph"] == "X" for e in back["traceEvents"])


def test_tracer_disabled_is_noop_and_ring_bounded(tmp_path):
    tr = obs_trace.Tracer(enabled=False)
    with tr.span("x") as s:
        assert s is None
    assert tr.events == []
    tr = obs_trace.Tracer(enabled=True, max_events=3)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    assert [e["name"] for e in tr.events] == ["s7", "s8", "s9"]
    # the module singleton: disabled by default, one configure() lights it
    assert not obs_trace.enabled()
    try:
        obs_trace.configure(enabled=True, max_events=16)
        with obs_trace.span("global"):
            pass
        assert [e["name"] for e in obs_trace.get().events] == ["global"]
    finally:
        obs_trace.configure(enabled=False)


# ---------------------------------------------------------------------------
# Metrics sinks
# ---------------------------------------------------------------------------


def test_jsonl_sink_roundtrip_and_append(tmp_path):
    p = str(tmp_path / "m.jsonl")
    with obs_sink.JsonlSink(p) as s:
        s.emit({"kind": "a", "v": torch.tensor(1.5), "arr": np.arange(3),
                "bf": torch.tensor([0.5, 2.0], dtype=torch.bfloat16),
                "i": torch.tensor(7)})
    with obs_sink.JsonlSink(p, append=True) as s:
        s.emit({"kind": "b", "v": 2})
    recs = obs_sink.jsonl_records(p)
    assert recs == [{"kind": "a", "v": 1.5, "arr": [0, 1, 2],
                     "bf": [0.5, 2.0], "i": 7},
                    {"kind": "b", "v": 2}]  # tensors coerced to Python


def test_csv_sink_locks_columns(tmp_path):
    p = str(tmp_path / "m.csv")
    with obs_sink.CsvSink(p) as s:
        s.emit({"a": 1, "b": 2})
        s.emit({"a": 3, "b": 4, "c": 5})  # an extra key is dropped
        s.emit({"a": 6})  # a missing key is left empty
    lines = open(p).read().strip().splitlines()
    assert lines[0] == "a,b"
    assert lines[1:] == ["1,2", "3,4", "6,"]


def test_memory_and_multi_sink():
    mem = obs_sink.MemorySink(capacity=2)
    for i in range(5):
        mem.emit({"i": i})
    assert [r["i"] for r in mem.records] == [3, 4]  # a bounded ring
    a, b = obs_sink.MemorySink(), obs_sink.MemorySink()
    multi = obs_sink.MultiSink(a, None, b)  # None sinks are skipped
    multi.emit({"x": torch.tensor(2.0)})
    assert a.records == b.records == [{"x": 2.0}]


# ---------------------------------------------------------------------------
# LoadMonitor: bounded history and sink
# ---------------------------------------------------------------------------


def _fake_metrics(E=8, drop=0.25):
    load = np.ones(E)
    load[0] = 2.0
    return SimpleNamespace(load=load, drop_frac=drop)


def test_load_monitor_history_bounded_and_sink_fed():
    from repro.core.monitor import LoadMonitor as JMonitor
    from repro.obs.sink import MemorySink as JSink

    sinks = []
    for make, sink in ((LoadMonitor, obs_sink.MemorySink()),
                       (JMonitor, JSink())):
        mon = make(8, history_cap=4, record_every=1, sink=sink)
        for _ in range(10):
            mon.update(_fake_metrics())
        assert len(mon.history) == 4  # a ring: old snapshots evicted
        assert mon.history[-1]["step"] == 10
        assert len(sink.records) == 10  # the sink saw every snapshot
        assert all(r["kind"] == "load_monitor" for r in sink.records)
        assert sink.records[-1]["imbalance"] > 1.0
        sinks.append(sink)
    assert sinks[0].records == pytest.approx(sinks[1].records)


def test_load_monitor_record_every_default_and_override():
    mon = LoadMonitor(8, record_every=2)
    for _ in range(6):
        mon.update(_fake_metrics())  # the instance's cadence
    assert [r["step"] for r in mon.history] == [2, 4, 6]
    mon.update(_fake_metrics(), record_every=7)
    assert [r["step"] for r in mon.history] == [2, 4, 6, 7]
    mon2 = LoadMonitor(8)  # record_every=0: never records
    for _ in range(5):
        mon2.update(_fake_metrics())
    assert len(mon2.history) == 0


# ---------------------------------------------------------------------------
# StepStats: measured counters against the tallied (modeled) bytes
# ---------------------------------------------------------------------------


def test_step_stats_record_and_wire_ratio():
    from repro.obs.stats import StepStats as JStats

    kw = dict(counters={"wire_bytes": 50.0, "loss": 1.25},
              modeled={"all-to-all": 80, "collective-permute": 20,
                       "all-reduce": 999})
    st = StepStats("train_step", 3, 0.5, **kw)
    assert st.measured_wire_bytes == 50.0
    assert st.modeled_wire_bytes == 100.0  # a2a + cp; all-reduce is not wire
    assert st.wire_ratio == 0.5
    rec = st.record()
    assert rec == JStats("train_step", 3, 0.5, **kw).record()
    assert rec["modeled_all_to_all_bytes"] == 80
    assert rec["modeled_all_reduce_bytes"] == 999
    assert rec["wire_measured_over_modeled"] == 0.5
    empty = StepStats("s", 0, 0.1)
    assert empty.measured_wire_bytes is None and empty.wire_ratio is None
    assert "wire_measured_over_modeled" not in empty.record()


def test_modeled_collective_bytes_reads_the_tally():
    """The port's modeled bytes are core.comm's host tally (the reference
    parses them from HLO): output bytes per rank by op, since the last
    reset, reading no tensor."""
    comm.tally_reset()
    comm.tally("all-to-all", 128 * 32 * 4)
    comm.tally("collective-permute", 64 * 2)
    comm.tally("all-to-all", 16)
    assert modeled_collective_bytes() == {"all-to-all": 128 * 32 * 4 + 16,
                                          "collective-permute": 64 * 2}
    assert comm.tallied_calls() == {"all-to-all": 2, "collective-permute": 1}
    comm.tally_reset()
    assert modeled_collective_bytes() == {}


# ---------------------------------------------------------------------------
# Serve and train
# ---------------------------------------------------------------------------


def _gpt_pair():
    import dataclasses

    from repro.configs import get_config as jget, reduced as jreduced
    from repro_torch.configs import get_config, reduced
    out = []
    for get, red in ((jget, jreduced), (get_config, reduced)):
        cfg = red(get("fastmoe-gpt"), num_layers=2, d_model=64)
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5)))
    return out


def test_serve_step_with_metrics_single_device():
    """A decode step's packed metrics (serve.decode_metrics: the drop
    fraction and the counters) against the JAX serve step's with_metrics
    dict, on the same params and token: single device, no wire."""
    from repro.launch.serve import make_serve_step
    from repro.models import lm as jlm
    from repro_torch import interop
    from repro_torch.launch import serve
    from repro_torch.models import lm

    jcfg, cfg = _gpt_pair()
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tok = np.arange(4, dtype=np.int32)[:, None] * 7
    step = make_serve_step(jcfg, with_metrics=True)
    _, _, jmd = step(jparams, jnp.asarray(tok), jnp.int32(0),
                     jlm.init_cache(jcfg, 4, cache_len=8))
    params = interop.from_jax(jax.tree.map(np.asarray, jparams), cfg,
                              device="cpu")
    with torch.no_grad():
        _, _, m = lm.decode_step(params, cfg, torch.from_numpy(tok), 0,
                                 lm.init_cache(cfg, 4, 8, device="cpu"),
                                 device="cpu")
    md = serve.decode_metrics(m, cfg)
    assert set(md) == set(jmd)
    assert float(md["wire_bytes"]) == 0.0 and float(md["imbalance"]) == 1.0
    for k, v in md.items():
        np.testing.assert_allclose(float(v), float(jmd[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.fixture
def world1_env(monkeypatch):
    """The torchrun environment of a one-rank world on a free localhost
    port, for the CLIs' own init_distributed."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                 ("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)


def test_train_cli_metrics_out_and_trace(tmp_path, world1_env, capsys):
    """--metrics_out/--trace end to end over a 1x1 mesh (the a2a exchange
    at one rank): a train_step record a step with the counters (wire
    bytes measured), the tallied collective bytes and their ratio, and a
    loadable Chrome trace with train_step spans."""
    from repro_torch.launch import train

    mpath, tpath = str(tmp_path / "metrics.jsonl"), str(tmp_path / "t.json")
    train.main(["--reduced", "--num_layers", "2", "--steps", "2", "--batch",
                "4", "--seq", "16", "--mesh", "1x1", "--device", "cpu",
                "--log_every", "1", "--metrics_out", mpath, "--trace", tpath])
    assert "done: 2 steps" in capsys.readouterr().out
    recs = obs_sink.jsonl_records(mpath)
    steps = [r for r in recs if r.get("kind") == "train_step"]
    assert [r["step"] for r in steps] == [0, 1]
    for r in steps:
        assert r["wall_s"] > 0
        assert r["wire_bytes"] > 0 and r["wire_elems"] > 0
        assert "loss" in r and "imbalance" in r
        assert r["modeled_all_to_all_bytes"] > 0
        assert r["modeled_all_reduce_bytes"] > 0
        assert r["wire_measured_over_modeled"] > 0
    trace = obs_trace.load_trace(tpath)
    names = {e["name"] for e in trace["traceEvents"]}
    assert "train_step" in names
    assert all(e["ph"] == "X" and e["dur"] >= 0
               for e in trace["traceEvents"])
    obs_trace.configure(enabled=False)


def test_serve_cli_metrics_out_and_trace(tmp_path, capsys):
    """serve --metrics_out/--trace: a decode_step record a step (latency,
    tokens/s, drop fraction, the counters) and decode_step spans; under
    --continuous the admit and retire records."""
    from repro_torch.launch import serve

    mpath, tpath = str(tmp_path / "m.jsonl"), str(tmp_path / "t.json")
    base = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt_len",
            "8", "--gen", "4"]
    serve.main(base + ["--metrics_out", mpath, "--trace", tpath])
    recs = obs_sink.jsonl_records(mpath)
    assert [r["pos"] for r in recs] == [8, 9, 10]
    for r in recs:
        assert r["kind"] == "decode_step" and r["wall_s"] > 0
        assert set(r) >= {"tokens_per_s", "drop_frac", *COUNTERS}
    spans = [e for e in obs_trace.load_trace(tpath)["traceEvents"]
             if e["name"] == "decode_step"]
    assert len(spans) == 3
    serve.main(base + ["--continuous", "--requests", "3", "--slots", "2",
                       "--metrics_out", mpath])
    kinds = [r["kind"] for r in obs_sink.jsonl_records(mpath)]
    assert kinds.count("serve_admit") == kinds.count("serve_retire") == 3
    assert "metrics written to" in capsys.readouterr().out
    obs_trace.configure(enabled=False)
    assert json.loads(json.dumps(recs))  # plain JSON values
