"""Resilience of the port (``repro_torch.checkpoint``, ``repro_torch.
resilience``) against the JAX package's, case for case with
``tests/test_resilience.py``, on the CPU:

* checkpoints: the durability units (atomic commit, the ``complete``
  marker, numeric step order, checksums, strict dtypes, GC), and across
  the packages: the port's save of the reference's tree writes the
  reference's manifest (sha256 included), each package restores the
  other's checkpoint bit for bit, and a save under a placement restores
  under none to the unplaced tree (the 1x2 save under a plan with
  shadowed experts rides ``tests/test_torch_ep.py``'s spawns);
* the step guard: the reference's verdicts and events for the same loss,
  grad-norm and drop streams, its host snapshot copied back into the live
  tensors, the snapshot cadence, the one-shot drop fallback; the probation
  and the fault registry (a NaN step poisons the params in place);
* the CLI drills on reduced fastmoe-gpt: a crash before the atomic
  publish (one subprocess, exit 137) then ``--resume``; a NaN step
  skipped and retried; stop-and-resume; a sustained drop spike.  The runs
  are in this process (``main(argv)``) on one thread (the CPU embedding
  backward is not bitwise reproducible across threads), each held bit for
  bit to one uninterrupted run: its losses and its final params and AdamW
  state (the final checkpoint's arrays).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.resilience import StepGuard as JGuard  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.obs import events as obs_events  # noqa: E402
from repro_torch.obs import sink as obs_sink  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.resilience import (CheckpointManager,  # noqa: E402
                                    ReplanProbation, StepGuard,
                                    TrainingAborted, faults)

ROOT = Path(__file__).resolve().parents[1]


class ListSink:
    def __init__(self):
        self.records = []

    def emit(self, rec):
        self.records.append(rec)

    def kinds(self):
        return [r.get("kind") for r in self.records]


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    faults.set_sink(None)
    yield
    faults.clear()
    faults.set_sink(None)


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "inner": {"b": torch.ones(5, dtype=torch.bfloat16),
                      "step": 7}}


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Checkpoint durability units
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "step_00000003")
    ckpt.save(path, tree, step=3)
    like = {"w": torch.zeros(3, 4), "inner": {"b": torch.zeros(
        5, dtype=torch.bfloat16), "step": 0}}
    out = ckpt.restore(path, like)
    assert torch.equal(out["w"], tree["w"])
    assert out["inner"]["b"].dtype == torch.bfloat16
    assert torch.equal(out["inner"]["b"], tree["inner"]["b"])
    assert out["inner"]["step"] == 7 and isinstance(out["inner"]["step"], int)
    m = ckpt.load_manifest(path)
    assert m["complete"] and m["step"] == 3
    # a bf16 leaf declares bf16 in the manifest though the file is f32
    assert m["params"]["inner/b"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, m["params"]["inner/b"]["file"])
                   ).dtype == np.float32
    assert m["params"]["inner/step"]["dtype"] == "int32"
    # inplace: copied into like's tensors, which come back
    back = ckpt.restore(path, like, inplace=True)
    assert back["w"] is like["w"] and torch.equal(like["w"], tree["w"])


def test_incomplete_and_tmp_dirs_are_invisible(tmp_path):
    """latest_step skips torn writes and temp dirs, and sorts steps
    numerically (step_9 < step_10000)."""
    root = str(tmp_path)
    tree = _tree()
    for s in (9, 10000):
        ckpt.save(ckpt.step_path(root, s), tree, step=s)
    torn = ckpt.step_path(root, 20000)  # arrays but no manifest
    os.makedirs(torn)
    np.save(os.path.join(torn, "arr_00000.npy"), np.zeros(3))
    unmarked = ckpt.step_path(root, 30000)  # no complete marker
    shutil.copytree(ckpt.step_path(root, 9), unmarked)
    m = ckpt.load_manifest(unmarked)
    del m["complete"]
    with open(os.path.join(unmarked, ckpt.MANIFEST), "w") as f:
        json.dump(m, f)
    os.makedirs(os.path.join(root, ".tmp-step_99999999.12345"))
    assert ckpt.latest_step(root) == ckpt.step_path(root, 10000)
    assert [s for s, _ in ckpt.complete_steps(root)] == [9, 10000]
    with pytest.raises(ckpt.CheckpointError):
        ckpt.restore(unmarked, tree)


def test_crash_mid_save_leaves_prior_checkpoint_intact(tmp_path, monkeypatch):
    """A save that dies before the atomic publish leaves only the temp
    dir; the prior checkpoint and latest_step are untouched, and GC from
    another pid sweeps the stale temp dir."""
    root = str(tmp_path)
    tree = _tree()
    ckpt.save(ckpt.step_path(root, 1), tree, step=1)

    class Boom(Exception):
        pass

    def no_publish(src, dst):
        raise Boom  # everything before the publish already happened

    monkeypatch.setattr(os, "replace", no_publish)
    with pytest.raises(Boom):
        ckpt.save(ckpt.step_path(root, 2), tree, step=2)
    monkeypatch.undo()
    assert ckpt.latest_step(root) == ckpt.step_path(root, 1)
    stale = [d for d in os.listdir(root) if d.startswith(".tmp-")]
    assert len(stale) == 1
    os.rename(os.path.join(root, stale[0]),
              os.path.join(root, ".tmp-step_00000002.99999"))
    assert len(ckpt.gc_checkpoints(root, keep=3)) == 1
    assert not any(d.startswith(".tmp-") for d in os.listdir(root))


def test_restore_catches_bit_rot(tmp_path):
    tree = _tree()
    path = str(tmp_path / "step_00000001")
    ckpt.save(path, tree, step=1)
    victim = os.path.join(path, ckpt.load_manifest(path)["params"]["w"]["file"])
    faults.corrupt_file(victim)
    like = {"w": torch.zeros(3, 4), "inner": {"b": torch.zeros(
        5, dtype=torch.bfloat16), "step": 0}}
    with pytest.raises(ckpt.CheckpointError, match="checksum"):
        ckpt.restore(path, like, inplace=True)
    assert not like["w"].any()  # every checksum is checked before a load
    ckpt.restore(path, tree, verify=False)  # the opt-out still loads


def test_restore_dtype_strict(tmp_path):
    """The manifest's dtype must match the target's; the only coercion is
    bf16's f32 storage."""
    path = str(tmp_path / "step_00000001")
    ckpt.save(path, {"w": torch.ones(2, 2)}, step=1)
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(path, {"w": torch.ones(2, 2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(path, {"w": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(path, {"v": torch.ones(2, 2)})


def test_corrupt_array_fault_is_caught_by_restore(tmp_path):
    """The registry's post-checksum corrupt_array fault is bit-rot the
    manifest's checksum catches (``match`` filters the flat key)."""
    faults.arm({"kind": "corrupt_array", "point": "ckpt_save_file",
                "match": "inner/b", "at": 1})
    tree = _tree()
    path = str(tmp_path / "step_00000001")
    ckpt.save(path, tree, step=1)
    assert faults.fired and faults.fired[0]["fault_kind"] == "corrupt_array"
    with pytest.raises(ckpt.CheckpointError, match="inner/b"):
        ckpt.restore(path, tree)


def test_manager_cadence_gc_and_corrupt_fallback(tmp_path):
    sink = ListSink()
    mgr = CheckpointManager(str(tmp_path), save_every=2, keep=2, sink=sink)
    tree = _tree()
    for s in range(6):
        mgr.maybe_save(s, tree)
    # the cadence counts completed steps: saves after 1, 3, 5; keep=2 GCs 1
    assert [s for s, _ in ckpt.complete_steps(str(tmp_path))] == [3, 5]
    assert obs_events.of_kind(sink.records, obs_events.CKPT_GC)
    newest = ckpt.step_path(str(tmp_path), 5)
    faults.corrupt_file(os.path.join(
        newest, ckpt.load_manifest(newest)["params"]["w"]["file"]))
    out = mgr.restore_latest(tree)
    assert out is not None and out[1] == 3
    assert [r["step"] for r in
            obs_events.of_kind(sink.records, obs_events.CKPT_CORRUPT)] == [5]
    assert [r["step"] for r in
            obs_events.of_kind(sink.records, obs_events.RESUME)] == [3]


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def _jax_state(dtype, arch="fastmoe-gpt"):
    """Reduced ``arch``'s JAX params (in ``dtype``) and the AdamW state
    after one update (nonzero moments, step 1)."""
    from repro.configs import get_config, reduced
    from repro.models import lm
    from repro.optim import AdamW

    cfg = reduced(get_config(arch), num_layers=2, d_model=64)
    params = jax.tree.map(lambda p: p.astype(dtype),
                          lm.init_params(jax.random.PRNGKey(0), cfg))
    opt = AdamW()
    grads = jax.tree.map(lambda p: (p * 0.5).astype(p.dtype), params)
    params, state, _ = opt.update(grads, opt.init(params), params)
    return cfg, params, state


def _port_state(params, state, arch="fastmoe-gpt"):
    from repro_torch.configs import get_config, reduced
    cfg = reduced(get_config(arch), num_layers=2, d_model=64)
    conv = lambda t: interop.from_jax(jax.tree.map(np.asarray, t), cfg,  # noqa: E731
                                      device="cpu")
    return {"params": conv(params),
            "opt": AdamWState(int(state.step), conv(state.mu),
                              conv(state.nu))}


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(0, _zeros(tree.mu), _zeros(tree.nu))
    if isinstance(tree, list):
        return [_zeros(v) for v in tree]
    return torch.zeros_like(tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_manifest_equals_the_references(tmp_path, dtype):
    """The port's save of the reference's tree (params with the layers
    stacked on L, AdamWState(step int32, mu, nu)) writes the reference's
    manifest for the same tree: keys, files, dtypes, shapes and sha256;
    ``ckpt.digests`` of the tree gives the same sha256s."""
    _, params, state = _jax_state(jnp.dtype(dtype))
    jckpt.save(str(tmp_path / "jax"), {"params": params, "opt": state},
               step=1)
    tree = _port_state(params, state)
    ckpt.save(str(tmp_path / "port"), tree, step=1)
    want = jckpt.load_manifest(str(tmp_path / "jax"))
    got = ckpt.load_manifest(str(tmp_path / "port"))
    assert list(got["params"]) == list(want["params"])
    assert got == want
    # the digests of a live tree, written nowhere, are the manifest's
    assert ckpt.digests(tree) == {k: v["sha256"]
                                  for k, v in want["params"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_each_package_restores_the_others_checkpoint(tmp_path, dtype):
    """repro.checkpoint.restore of a port checkpoint and the port's restore
    of a reference checkpoint give back every leaf bit for bit."""
    _, params, state = _jax_state(jnp.dtype(dtype))
    jtree = {"params": params, "opt": state}
    ttree = _port_state(params, state)
    jckpt.save(str(tmp_path / "jax"), jtree, step=1)
    ckpt.save(str(tmp_path / "port"), ttree, step=1)
    back = jckpt.restore(str(tmp_path / "port"), jax.tree.map(
        jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    got = ckpt.restore(str(tmp_path / "jax"), _zeros(ttree))
    assert got["opt"].step == 1
    for a, b in zip(_leaves(got), _leaves(ttree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_whisper_checkpoint_round_trips_between_packages(tmp_path):
    """Reduced whisper-tiny (the encoder's ``enc_layers`` stacked on L as
    the decoder's ``layers``): the port writes the reference's manifest,
    and each package restores the other's checkpoint bit for bit."""
    _, params, state = _jax_state(jnp.float32, "whisper-tiny")
    assert "enc_layers" in params
    jtree = {"params": params, "opt": state}
    ttree = _port_state(params, state, "whisper-tiny")
    assert isinstance(ttree["params"]["enc_layers"], list)
    jckpt.save(str(tmp_path / "jax"), jtree, step=1)
    ckpt.save(str(tmp_path / "port"), ttree, step=1)
    assert (ckpt.load_manifest(str(tmp_path / "port"))
            == jckpt.load_manifest(str(tmp_path / "jax")))
    back = jckpt.restore(str(tmp_path / "port"), jax.tree.map(
        jnp.zeros_like, jtree))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    got = ckpt.restore(str(tmp_path / "jax"), _zeros(ttree))
    assert got["opt"].step == 1
    for a, b in zip(_leaves(got), _leaves(ttree)):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_save_under_a_placement_restores_unplaced(tmp_path):
    """A tree in a per-layer plan's physical order (a permutation and two
    shadowed experts per layer) saved with the plan is in logical order:
    restored under no plan it is the unplaced tree bit for bit, and under
    the plan the placed one."""
    from repro_torch import placement as TP

    _, params, state = _jax_state(jnp.float32)
    tree = _port_state(params, state)
    E = tree["params"]["layers"][0]["ffn"]["experts"]["wi"].shape[0]
    plan = TP.per_layer_placement([
        TP.ExpertPlacement(E, 1, tuple(np.random.default_rng(s).permutation(
            E).tolist()), num_shadow=2) for s in range(2)])
    placed = _port_state(params, state)
    for t in (placed["params"], placed["opt"].mu, placed["opt"].nu):
        TP.from_logical(t, plan)
    ckpt.save(str(tmp_path / "c"), placed, step=1, placement=plan)
    got = ckpt.restore(str(tmp_path / "c"), _zeros(tree))
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    got = ckpt.restore(str(tmp_path / "c"), _zeros(tree), placement=plan)
    for a, b in zip(_leaves(got), _leaves(placed)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    assert not all(torch.equal(torch.as_tensor(a), torch.as_tensor(b))
                   for a, b in zip(_leaves(tree), _leaves(placed)))


# ---------------------------------------------------------------------------
# Step guard units
# ---------------------------------------------------------------------------


STREAM = [  # (step, loss, grad_norm, drop)
    (1, 1.0, 1.0, 0.5), (2, float("nan"), 1.0, 0.0), (2, 1.0, float("inf"),
                                                        0.0),
    (2, 1.0, 1.0, 0.5), (3, 1.0, 1.0, 0.5), (4, 1.0, 1.0, 0.5),
    (5, 1.0, 1.0, 0.1), (6, 1.0, 1.0, 0.9), (7, 1.0, 1.0, 0.9),
    (8, 1.0, 1.0, 0.9), (9, 1.0, 1.0, 0.9), (10, float("nan"), 1.0, 0.9),
    (10, float("nan"), None, 0.9), (10, float("nan"), 2.0, 0.9)]


def test_guard_verdicts_and_events_equal_the_references():
    """The same loss, grad-norm and drop stream, with a commit after each
    good step: the port's guard gives the reference's verdicts (ok,
    reason, fallback), events (kinds and fields) and abort."""
    runs = []
    for make, tree in ((JGuard, (jnp.ones(3), jnp.zeros(3))),
                       (StepGuard, (torch.ones(3), torch.zeros(3)))):
        sink = ListSink()
        g = make(max_bad_steps=2, drop_threshold=0.25, drop_patience=3,
                 sink=sink)
        g.commit(0, *tree)
        out = []
        for step, loss, gnorm, drop in STREAM:
            try:
                v = g.check(step, loss=loss, grad_norm=gnorm, drop=drop)
            except (TrainingAborted, RuntimeError) as e:
                out.append(("abort", type(e).__name__))
                break
            out.append(tuple(v))
            if v.ok:
                g.commit(step, *tree)
            else:
                g.restore()
        runs.append((out, json.dumps(sink.records, default=str)))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1] == runs[1][1]
    assert runs[1][0][-1] == ("abort", "TrainingAborted")


def test_guard_skip_restore_then_abort():
    sink = ListSink()
    g = StepGuard(max_bad_steps=2, sink=sink)
    p, o = {"w": torch.ones(3)}, {"m": torch.zeros(3)}
    g.commit(0, p, o)
    p["w"].mul_(float("nan"))  # the step poisons the live tensors
    assert not g.check(1, loss=float("nan")).ok
    rp, ro = g.restore()
    assert rp["w"] is p["w"]  # copied back into the live tensors
    assert torch.equal(p["w"], torch.ones(3))
    assert not g.check(1, loss=1.0, grad_norm=float("inf")).ok
    with pytest.raises(TrainingAborted):
        g.check(1, loss=float("nan"))
    ks = sink.kinds()
    assert ks.count(obs_events.GUARD_SKIP) == 3
    assert ks[-1] == obs_events.GUARD_ABORT
    g2 = StepGuard(max_bad_steps=1)  # a good step resets the streak
    g2.commit(0, p, o)
    for s in range(1, 5):  # alternating bad and good never aborts
        assert not g2.check(s, loss=float("nan")).ok
        g2.commit(s, p, o)
        assert g2.check(s, loss=0.5).ok


def test_guard_snapshot_cadence_and_force():
    g = StepGuard(snapshot_every=4)
    p = {"w": torch.zeros(2)}
    state = AdamWState(5, {"w": torch.zeros(2)}, {"w": torch.zeros(2)})
    g.commit(0, p, state)
    p["w"].fill_(1.0)
    g.commit(1, p, state._replace(step=6))  # within the cadence: not taken
    assert g.snapshot_step == 0
    assert torch.equal(g.snapshot[0]["w"], torch.zeros(2))
    p["w"].fill_(2.0)
    g.commit(2, p, state._replace(step=7), force=True)  # after a migration
    assert g.snapshot_step == 2
    p["w"].fill_(9.0)
    rp, rs = g.restore()
    assert torch.equal(rp["w"], torch.full((2,), 2.0)) and rs.step == 7


def test_guard_drop_fallback_is_one_shot():
    sink = ListSink()
    g = StepGuard(drop_threshold=0.2, drop_patience=3, sink=sink)
    g.commit(0, {}, {})
    hits = [g.check(s, loss=1.0, drop=0.5).fallback_dropless
            for s in range(1, 10)]
    assert hits == [False, False, True] + [False] * 6
    assert sink.kinds().count(obs_events.DROP_SPIKE) == 1
    g2 = StepGuard(drop_threshold=0.2, drop_patience=3)  # below resets
    g2.commit(0, {}, {})
    seq = [0.5, 0.5, 0.1, 0.5, 0.5, 0.5]
    assert [g2.check(i, loss=1.0, drop=d).fallback_dropless
            for i, d in enumerate(seq)] == [False] * 5 + [True]


# ---------------------------------------------------------------------------
# Probation and the fault registry
# ---------------------------------------------------------------------------


def test_probation_rollback_and_commit():
    sink = ListSink()
    pr = ReplanProbation(window=8, loss_tol=1.05, min_samples=3, sink=sink)
    pr.start(10, "OLD", "NEW", baseline_loss=1.0, baseline_drop=0.0)
    assert not pr.observe(11, loss=2.0).rollback  # below min_samples
    assert not pr.observe(12, loss=2.0).rollback
    d = pr.observe(13, loss=2.0)
    assert d.rollback and d.old_plan == "OLD" and d.new_plan == "NEW"
    assert not pr.active
    assert sink.kinds() == [obs_events.REPLAN_ROLLBACK]
    pr.start(20, "OLD", "NEW2", baseline_loss=1.0, baseline_drop=0.0)
    for s in range(21, 29):  # surviving the window commits
        assert not pr.observe(s, loss=1.0).rollback
    assert not pr.active
    assert sink.kinds()[-1] == obs_events.REPLAN_COMMIT
    pr.start(30, "OLD", "NEW3", baseline_drop=0.0)
    for _ in range(3):  # a drop regression judges without a loss baseline
        d = pr.observe(31, drop=0.2)
    assert d.rollback


def test_fault_hit_count_and_nonfinite_one_shot():
    faults.arm({"kind": "nonfinite", "point": "train_step", "step": 3,
                "until": 100})
    p = {"w": torch.ones(2, dtype=torch.bfloat16), "i": torch.tensor(1)}
    m = {"loss": torch.tensor(1.0), "grad_norm": torch.tensor(1.0)}
    _, _, m1 = faults.apply_step(p, {}, m, step=2)
    assert torch.isfinite(m1["loss"])  # before the step range
    p2, _, m2 = faults.apply_step(p, {}, m, step=3)
    assert not torch.isfinite(m2["loss"])
    assert p2 is p and not torch.isfinite(p["w"].float()).any()  # in place
    assert p["w"].dtype == torch.bfloat16 and int(p["i"]) == 1
    _, _, m3 = faults.apply_step(p, {}, m, step=3)  # one-shot: the retry
    assert torch.isfinite(m3["loss"])
    assert not faults.armed()
    faults.arm({"kind": "drop_spike", "point": "train_step", "step": 5,
                "value": 0.9})
    _, _, m4 = faults.apply_step(p, {}, m, step=5)  # the metrics only
    assert float(m4["drop_frac"]) == pytest.approx(0.9)


# ---------------------------------------------------------------------------
# CLI drills (in this process, one thread; one subprocess for the crash)
# ---------------------------------------------------------------------------


CLI = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "32",
       "--log_every", "1"]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(argv, metrics):
    """Run the train CLI in this process; the losses by step (the full
    floats of its train_step records) and its record kinds."""
    from repro_torch.launch import train
    train.main(CLI + argv + ["--metrics_out", str(metrics)])
    recs = obs_sink.jsonl_records(str(metrics))
    return ({r["step"]: r["loss"] for r in recs
             if r.get("kind") == "train_step"}, [r["kind"] for r in recs])


def _final_state(root) -> dict:
    """The newest checkpoint's arrays, by flat key."""
    path = ckpt.latest_step(str(root))
    m = ckpt.load_manifest(path)
    return {k: np.load(os.path.join(path, v["file"]))
            for k, v in m["params"].items()}


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """One uninterrupted 6-step run: its losses and its final state."""
    tmp = tmp_path_factory.mktemp("ref")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        losses, _ = _cli(["--steps", "6", "--ckpt_dir", str(tmp / "ck")],
                         tmp / "m.jsonl")
    finally:
        torch.set_num_threads(n)
    return losses, _final_state(tmp / "ck")


def _assert_state_equal(root, want):
    got = _final_state(root)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cli_crash_mid_save_then_resume(tmp_path, reference_run, one_thread):
    """os._exit(137) right before the atomic publish of the step-3
    checkpoint (a subprocess): the step-1 checkpoint stays intact and the
    torn save invisible; --resume restores step 1 and replays to the
    uninterrupted run's losses and final state, bit for bit."""
    ck = str(tmp_path / "ck")
    spec = [{"kind": "crash", "point": "ckpt_save_pre_commit", "at": 2}]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               REPRO_FAULTS=json.dumps(spec))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *CLI, "--steps",
         "6", "--ckpt_dir", ck, "--save_every", "2"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == faults.CRASH_EXIT_CODE, out.stderr[-2000:]
    assert ckpt.latest_step(ck) == ckpt.step_path(ck, 1)
    assert any(d.startswith(".tmp-") for d in os.listdir(ck))
    losses, kinds = _cli(["--steps", "6", "--ckpt_dir", ck, "--save_every",
                          "2", "--resume"], tmp_path / "m.jsonl")
    want, state = reference_run
    assert sorted(losses) == [2, 3, 4, 5]
    assert all(losses[s] == want[s] for s in losses), (losses, want)
    assert obs_events.RESUME in kinds and obs_events.CKPT_SAVE in kinds
    assert not any(d.startswith(".tmp-") for d in os.listdir(ck))  # GC
    _assert_state_equal(ck, state)


def test_cli_nan_step_skipped_and_retried(tmp_path, reference_run,
                                          one_thread, monkeypatch):
    """A NaN at step 2 (the params poisoned in place) is skipped; the retry
    from the host snapshot lands on the uninterrupted run's losses and
    final state, with the trail fault -> guard_skip -> guard_restore."""
    spec = [{"kind": "nonfinite", "point": "train_step", "step": 2}]
    monkeypatch.setenv("REPRO_FAULTS", json.dumps(spec))
    ck = tmp_path / "ck"
    losses, kinds = _cli(["--steps", "6", "--ckpt_dir", str(ck)],
                         tmp_path / "m.jsonl")
    want, state = reference_run
    assert losses == want
    i = kinds.index(obs_events.FAULT)
    assert kinds[i:i + 3] == [obs_events.FAULT, obs_events.GUARD_SKIP,
                              obs_events.GUARD_RESTORE]
    _assert_state_equal(ck, state)


def test_cli_resume_equivalence(tmp_path, reference_run, one_thread, capsys):
    """Stop at 4, resume to 6: the resumed half matches the uninterrupted
    run bit for bit (the data stream replays to the checkpoint's step)."""
    ck = str(tmp_path / "ck")
    _cli(["--steps", "4", "--ckpt_dir", ck], tmp_path / "a.jsonl")
    losses, _ = _cli(["--steps", "6", "--ckpt_dir", ck, "--resume"],
                     tmp_path / "b.jsonl")
    assert "resumed from step 3" in capsys.readouterr().out
    want, state = reference_run
    assert losses == {s: want[s] for s in (4, 5)}
    _assert_state_equal(ck, state)


def test_cli_sustained_drop_spike_emits_fallback(tmp_path, monkeypatch,
                                                 capsys):
    """A sustained injected drop spike trips the guard's one-shot dropless
    fallback (an event only without a mesh: the rebuild needs a bounded
    exchange)."""
    spec = [{"kind": "drop_spike", "point": "train_step", "step": 0,
             "until": 6, "value": 0.9}]
    monkeypatch.setenv("REPRO_FAULTS", json.dumps(spec))
    _, kinds = _cli(["--steps", "6", "--num_layers", "2", "--drop_patience",
                     "3"], tmp_path / "m.jsonl")
    assert "sustained drop spike" in capsys.readouterr().out
    assert kinds.count(obs_events.DROP_SPIKE) == 1
    assert kinds.count(obs_events.DROP_FALLBACK) == 1
