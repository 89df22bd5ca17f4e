"""Expert parallelism of the port (paper §3.2) against the JAX package,
across ranks that are CPU processes joined by gloo.

One spawn of ranks per mesh shape (1x1, 1x2, 2x2, 1x4) runs every case of
that mesh.  The ranks are processes of this file run as a script: they
import ``repro_torch`` and never JAX, take one thread each, meet through a
``FileStore`` under the test's tmp dir (``init_process_group`` with a
timeout), and save their results; a spawn that does not end within
``SPAWN_TIMEOUT`` seconds is killed and fails its tests.  The test process
holds the results to the JAX package:

* *layer matrix* (1x2, 2x2, 1x4): {capacity, ragged} x {einsum, pallas,
  fused} (the kernels' plain versions on the CPU) at
  ``tests/dist_utils.moe_env``'s settings (8 experts, top-2, d 32, hidden
  64, 8 x 16 tokens, capacity factor 8): ``y``, ``load`` and ``drop_frac``
  against JAX's single-rank ``fmoe_apply(dist=None)`` on the whole input
  at 1e-5, ragged dropping nothing; the gradients of ``sum(y * r)`` for a
  seeded ``r`` (each rank's expert shard against its slice, the router
  after ``sync_grads``, the rank's input rows) against ``jax.grad`` at
  1e-5 of each leaf's largest magnitude;
* *forced drops* (2x2): a ragged bound that drops rows, against the JAX
  package's distributed layer (same mesh, same bound): ``y`` and
  ``drop_frac``;
* *model* (1x2, 2x2): reduced ``fastmoe-gpt`` with ``remat="full"``, the
  step-0 loss, aux and z loss, every gradient leaf after ``sync_grads``,
  the global grad norm, and two train steps' losses against the JAX
  package's distributed ``lm.loss_fn(dist=DistConfig(mesh, ("data",
  "model")))`` on fake CPU devices (``tests/dist_utils.run``) at 1e-4 (of
  the leaf's largest magnitude for gradients) — a sharded aux loss is the
  mean of per-shard losses and capacity drops are decided per rank, so the
  single-rank model is not the counterpart; and the sync semantics:
  ``world`` leaves equal on every rank, expert leaves equal within a data
  group and different across model ranks;
* *world size 1* (1x1): the exchange is an identity, and the EP path's
  loss and every gradient equal the local path's bit for bit, as do the
  params after one train step; and psum decode equals local decode;
* *psum layer matrix* (1x2 and 1x4 with ``token_axes=()``, 2x2 with
  ``("data",)``): the same {capacity, ragged} x {einsum, pallas, fused}
  cases in the psum mode (every rank of a model group holds the same
  tokens, under ``torch.no_grad()``: the mode serves only), ``y``,
  ``load`` and ``drop_frac`` against JAX's single-rank layer at 1e-5 —
  the reference's own psum cell (``tests/test_distributed.py``);
* *psum decode* (1x2): reduced ``fastmoe-gpt`` decoding greedily through
  ``lm.decode_step(dist=serve.decode_dist(...))``, logits against the JAX
  package's distributed ``lm.decode_step`` on fake CPU devices at 1e-4,
  greedy tokens equal;
* refusals of what the slice does not carry, and the ``torchrun`` CLIs of
  training and of continuous serving.
"""
import datetime
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 180  # seconds a spawn of ranks may take before it is killed
STORE_TIMEOUT = datetime.timedelta(seconds=150)  # a collective's own limit
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
TASKS = {"1x1": ["bit_equal"], "1x2": ["layer", "model", "decode"],
         "2x2": ["layer", "model", "drops"], "1x4": ["layer"]}
DISPATCHES = ("capacity", "ragged")
IMPLS = ("einsum", "pallas", "fused")
# model level: the port's impl per dispatch; the JAX side runs einsum (its
# Pallas kernels in interpret mode would cost minutes of compile)
MODEL_IMPL = {"capacity": "einsum", "ragged": "fused"}
DROP_BOUND = 24  # rows per peer shard: 64 rows a rank over 2 peers drop
MODEL_B, MODEL_S = 4, 16
LAYER = dict(num_experts=8, top_k=2, d_expert_hidden=64, capacity_factor=8.0)
LR, WARMUP, TOTAL = 1e-3, 2, 10
DECODE_STEPS, DECODE_CACHE = 6, 8  # psum decode: greedy steps, ring length


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _sub(flat, prefix):
    n = len(prefix) + 1
    return {k[n:]: v for k, v in flat.items() if k.startswith(prefix + "/")}


def _model_cfg(dispatch, package="repro_torch", d_model=64):
    """Reduced fastmoe-gpt (2 layers, 4 experts, remat on) of ``package``'s
    configs: "repro_torch", or "repro" (JAX) on the test-process side."""
    import dataclasses
    import importlib

    configs = importlib.import_module(f"{package}.configs")
    cfg = configs.reduced(configs.get_config("fastmoe-gpt"), num_layers=2,
                          d_model=d_model)
    return dataclasses.replace(
        cfg, remat="full", moe=dataclasses.replace(cfg.moe, dispatch=dispatch))


def _tokens(step):
    return np.random.default_rng(100 + step).integers(
        0, 512, (MODEL_B, MODEL_S)).astype(np.int32)


# ---------------------------------------------------------------------------
# The ranks (this file run as a script): repro_torch only, no JAX
# ---------------------------------------------------------------------------


def _layer_task(spec, job, mesh, out):
    from repro_torch import interop
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe
    from repro_torch.core.sync import sync_grads

    inp = dict(np.load(job / "layer.npz"))
    d = inp["x"].shape[-1]
    x = torch.from_numpy(inp["x"]).reshape(-1, d)
    r = torch.from_numpy(inp["r"]).reshape(-1, d)
    t = x.shape[0] // mesh.size
    rows = slice(mesh.rank * t, (mesh.rank + 1) * t)
    whole = _unflatten({k: torch.from_numpy(v) for k, v in inp.items()
                        if k.startswith(("router/", "experts/"))})
    params = interop.shard_params(whole, mesh)
    leaves = [params["router"]["w"]] + list(params["experts"].values())
    cases = [(dp, impl, 0) for dp in DISPATCHES for impl in IMPLS]
    if "drops" in spec["tasks"]:
        cases.append(("ragged", "fused", DROP_BOUND))
    for dispatch, impl, bound in cases:
        cfg = MoEConfig(dispatch=dispatch, **LAYER)
        dist = fmoe.DistConfig(mesh, ("data", "model"), ragged_bound=bound)
        p = {"router": {"w": leaves[0].clone().requires_grad_()},
             "experts": {k: v.clone().requires_grad_()
                         for k, v in params["experts"].items()}}
        xs = x[rows].clone().requires_grad_()
        y, m = fmoe.fmoe_apply(p, xs, cfg, act="swiglu", dist=dist, impl=impl)
        key = f"drops/{dispatch}/{impl}" if bound else f"layer/{dispatch}/{impl}"
        out.update({f"{key}/y": y.detach(), f"{key}/load": m.load,
                    f"{key}/drop_frac": m.drop_frac})
        if bound:
            continue
        g_leaves = [p["router"]["w"]] + list(p["experts"].values())
        grads = torch.autograd.grad((y * r[rows]).sum(), g_leaves + [xs])
        tree = {"router": {"w": grads[0]},
                "experts": dict(zip(p["experts"], grads[1:-1]))}
        sync_grads(tree, mesh)
        for k, v in _flatten(tree).items():
            out[f"{key}/grad/{k}"] = v
        out[f"{key}/grad/x"] = grads[-1]
    # the psum mode: a model group holds the same tokens, its data row's
    # block of them where the mesh has a data axis
    data = mesh.shape["data"]
    token_axes = ("data",) if data > 1 else ()
    t = x.shape[0] // data
    d = mesh.coords()[0]
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            cfg = MoEConfig(dispatch=dispatch, **LAYER)
            dist = fmoe.DistConfig(mesh, token_axes)
            assert dist.mode == "psum"
            with torch.no_grad():
                y, m = fmoe.fmoe_apply(params, x[d * t:(d + 1) * t], cfg,
                                       act="swiglu", dist=dist, impl=impl)
            key = f"psum/{dispatch}/{impl}"
            out.update({f"{key}/y": y, f"{key}/load": m.load,
                        f"{key}/drop_frac": m.drop_frac})


def _model_task(spec, job, mesh, out):
    from repro_torch import interop
    from repro_torch.core.sync import sync_grads
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import global_norm

    params_np = _unflatten(dict(np.load(job / "model_params.npz")))
    for dispatch in DISPATCHES:
        impl = MODEL_IMPL[dispatch]
        cfg = _model_cfg(dispatch)
        dist = train.moe_dist(cfg, mesh, MODEL_B * MODEL_S)
        params = interop.from_jax(params_np, cfg, device="cpu", mesh=mesh)
        rows = train._rank_rows(torch.from_numpy(_tokens(0)), mesh)
        loss, aux, grads = train.loss_and_grads(
            params, cfg, {"tokens": rows}, impl=impl, device="cpu", dist=dist)
        sync_grads(grads, mesh)
        key = f"model/{dispatch}"
        out[f"{key}/loss"] = train._mean_over_ranks(loss, mesh)
        for k in ("aux_loss", "z_loss", "drop_frac", "load"):
            out[f"{key}/{k}"] = aux[k]
        out[f"{key}/grad_norm"] = global_norm(grads, mesh)
        for k, v in _flatten(interop.to_jax(grads)).items():
            out[f"{key}/grad/{k}"] = v
        opt = AdamW(lr=LR)
        step_fn = train.make_train_step(cfg, opt, dist=dist, warmup=WARMUP,
                                        total_steps=TOTAL, impl=impl,
                                        device="cpu")
        state = opt.init(params)
        losses = []
        for step in range(2):
            params, state, m = step_fn(
                params, state, {"tokens": torch.from_numpy(_tokens(step))},
                step)
            losses.append(float(m["loss"]))
        out[f"{key}/losses"] = np.asarray(losses)


def _bit_equal_task(spec, job, mesh, out):
    """At world size 1 the EP path must be the local path, bit for bit, and
    psum decode the local decode."""
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    for dispatch in DISPATCHES:
        cfg = _model_cfg(dispatch)
        dist = train.moe_dist(cfg, mesh, MODEL_B * MODEL_S)
        batch = {"tokens": torch.from_numpy(_tokens(0))}
        for impl in IMPLS:
            res = {}
            for name, d in (("local", None), ("ep", dist)):
                params = lm.init_params(cfg, seed=0, device="cpu",
                                        param_dtype=cfg.param_dtype)
                loss, _, grads = train.loss_and_grads(
                    params, cfg, batch, impl=impl, device="cpu", dist=d)
                opt = AdamW(lr=LR)
                step_fn = train.make_train_step(cfg, opt, dist=d, impl=impl,
                                                device="cpu")
                params, _, m = step_fn(params, opt.init(params), batch, 0)
                res[name] = ([loss] + tree_leaves(grads),
                             [m["grad_norm"]] + tree_leaves(params))
            key = f"bit_equal/{dispatch}/{impl}"
            out[f"{key}/grads"] = np.asarray(all(
                torch.equal(a, b) for a, b in zip(res["local"][0],
                                                  res["ep"][0])))
            out[f"{key}/step"] = np.asarray(all(
                torch.equal(a, b) for a, b in zip(res["local"][1],
                                                  res["ep"][1])))
            # serving: psum decode against local decode
            params = lm.init_params(cfg, seed=0, device="cpu")
            ddist = serve.decode_dist(cfg, mesh, MODEL_B)
            (l0, t0), (l1, t1) = (_decode_greedy(params, cfg, impl, d)
                                  for d in (None, ddist))
            out[f"{key}/psum_decode"] = np.asarray(
                ddist.mode == "psum" and torch.equal(l0, l1)
                and torch.equal(t0, t1))


def _decode_greedy(params, cfg, impl, dist, device="cpu"):
    """DECODE_STEPS greedy steps of ``lm.decode_step`` from the first
    token of ``_tokens(0)``: (logits (steps, B, V), fed tokens)."""
    from repro_torch.models import lm

    cache = lm.init_cache(cfg, MODEL_B, DECODE_CACHE, device=device)
    tok = torch.from_numpy(_tokens(0)[:, :1]).to(device)
    logits_all, toks = [], [tok]
    with torch.no_grad():
        for pos in range(DECODE_STEPS):
            logits, cache, _ = lm.decode_step(params, cfg, tok, pos, cache,
                                              impl=impl, device=device,
                                              dist=dist)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            logits_all.append(logits[:, 0])
            toks.append(tok)
    return torch.stack(logits_all), torch.cat(toks, 1)


def _decode_task(spec, job, mesh, out):
    """psum decode of the reduced model, each rank its expert shard."""
    from repro_torch import interop
    from repro_torch.launch import serve

    params_np = _unflatten(dict(np.load(job / "model_params.npz")))
    for dispatch in DISPATCHES:
        cfg = _model_cfg(dispatch)
        dist = serve.decode_dist(cfg, mesh, MODEL_B)
        assert dist.mode == "psum" and dist.token_axes == ("data",)
        params = interop.from_jax(params_np, cfg, device="cpu", mesh=mesh)
        logits, toks = _decode_greedy(params, cfg, MODEL_IMPL[dispatch], dist)
        out[f"decode/{dispatch}/logits"] = logits
        out[f"decode/{dispatch}/tokens"] = toks


RANK_TASKS = {"layer": _layer_task, "model": _model_task,
              "bit_equal": _bit_equal_task, "decode": _decode_task}


def _rank_main(job: Path, rank: int) -> None:
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    torch.set_num_threads(1)
    spec = json.loads((job / "job.json").read_text())
    data, model = spec["mesh"]
    world = data * model
    init_distributed("cpu", rank=rank, world_size=world,
                     store=tdist.FileStore(str(job / "store"), world),
                     timeout=STORE_TIMEOUT)
    mesh = make_local_mesh(data, model)
    out: dict = {}
    for task in spec["tasks"]:
        if task in RANK_TASKS:
            RANK_TASKS[task](spec, job, mesh, out)
    np.savez(job / f"rank{rank}.npz",
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in out.items()})
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# The test process: inputs, spawns, the JAX counterparts
# ---------------------------------------------------------------------------


def _spawn(job: Path, world: int):
    """Start ``world`` rank processes of this file on ``job``; returns a
    function that waits for them (at most SPAWN_TIMEOUT seconds from the
    start, killing any left) and returns (ok, log tail)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    start = time.monotonic()
    logs = [job / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:  # a file, so no rank blocks on a full pipe
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(job), str(r)], env=env,
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))

    def wait():
        ok = True
        for p in procs:
            left = max(1.0, SPAWN_TIMEOUT - (time.monotonic() - start))
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                p.wait()
                ok = False
            ok &= p.returncode == 0
        return ok, "\n".join(f"{log.name}: {log.read_text()[-3000:]}"
                              for log in logs)

    return wait


def _jax_layer_inputs(job: Path):
    import jax

    import dist_utils as du
    env = du.moe_env()
    r = jax.random.normal(jax.random.PRNGKey(7), env.x.shape)
    np.savez(job / "layer.npz", x=np.asarray(env.x), r=np.asarray(r),
             **_flatten(jax.tree.map(np.asarray, env.params)))
    return env, r


def _jax_layer_oracle(env, r):
    """JAX's single-rank layer per (dispatch, impl): y, load, drop_frac and
    the gradients of sum(y * r) w.r.t. router, experts and x."""
    import dataclasses

    import jax

    from repro.core import fmoe as jfmoe
    ref = {}
    for dispatch in DISPATCHES:
        cfg = dataclasses.replace(env.cfg, dispatch=dispatch)
        for impl in IMPLS:
            def f(p, x):
                y, m = jfmoe.fmoe_apply(p, x, cfg, impl=impl)
                return (y * r).sum(), (y, m)
            (_, (y, m)), (gp, gx) = jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True)(env.params, env.x)
            key = f"{dispatch}/{impl}"
            ref[key] = dict(y=np.asarray(y), load=np.asarray(m.load),
                            drop_frac=np.asarray(m.drop_frac),
                            grad={**_flatten(jax.tree.map(np.asarray, gp)),
                                  "x": np.asarray(gx)})
    return ref


JAX_DIST = """
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import dist_utils as du
import test_torch_ep as T
from repro import optim
from repro.core import fmoe
from repro.launch.mesh import make_local_mesh
from repro.models import lm
data, model = {mesh!r}
mesh = make_local_mesh(data, model)
dist = fmoe.DistConfig(mesh, ("data", "model"))
params = jax.tree.map(jnp.asarray, T._unflatten(dict(np.load({params!r}))))
out = {{}}
for dispatch in T.DISPATCHES:
    cfg = T._model_cfg(dispatch, "repro")
    vg = jax.jit(jax.value_and_grad(
        lambda p, t: lm.loss_fn(p, cfg, {{"tokens": t}}, dist=dist,
                                impl="einsum"), has_aux=True))
    with mesh:
        (loss, aux), grads = vg(params, jnp.asarray(T._tokens(0)))
    key = "model/" + dispatch
    out[key + "/loss"] = loss
    for k in ("aux_loss", "z_loss", "drop_frac", "load"):
        out[key + "/" + k] = aux[k]
    out[key + "/grad_norm"] = optim.global_norm(grads)
    for k, v in T._flatten(jax.tree.map(np.asarray, grads)).items():
        out[key + "/grad/" + k] = v
    opt = optim.AdamW(lr=T.LR)
    p1, _, _ = opt.update(grads, opt.init(params), params,
                          lr_scale=optim.warmup_cosine(0, warmup=T.WARMUP,
                                                       total=T.TOTAL))
    with mesh:
        (loss1, _), _ = vg(p1, jnp.asarray(T._tokens(1)))
    out[key + "/losses"] = np.asarray([float(loss), float(loss1)])
if {drops!r}:
    env = du.moe_env(dispatch="ragged")
    y, m = du.dist_apply(env, mesh, dist._replace(ragged_bound=T.DROP_BOUND),
                         impl="fused")
    out["drops/y"], out["drops/drop_frac"] = y, m.drop_frac
    out["drops/load"] = m.load
if {decode!r}:
    from repro.launch.serve import decode_dist
    for dispatch in T.DISPATCHES:
        cfg = T._model_cfg(dispatch, "repro")
        ddist = decode_dist(cfg, mesh, T.MODEL_B)
        assert ddist.mode == "psum", ddist
        step = jax.jit(lambda p, t, pos, c: lm.decode_step(p, cfg, t, pos, c,
                                                           dist=ddist))
        cache = lm.init_cache(cfg, T.MODEL_B, T.DECODE_CACHE)
        tok = jnp.asarray(T._tokens(0)[:, :1])
        logits_all, toks = [], [tok]
        with mesh:
            for pos in range(T.DECODE_STEPS):
                logits, cache, _ = step(params, tok, jnp.int32(pos), cache)
                tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
                logits_all.append(logits[:, 0])
                toks.append(tok)
        out["decode/" + dispatch + "/logits"] = jnp.stack(logits_all)
        out["decode/" + dispatch + "/tokens"] = jnp.concatenate(toks, 1)
np.savez({dest!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("jax distributed ok")
"""


def _jax_dist(job: Path, name: str, box: dict):
    """The JAX package's distributed runs of one mesh, on fake devices."""
    import dist_utils as du
    dest = job / f"jax_{name}.npz"
    try:
        du.run(JAX_DIST.format(tests=str(ROOT / "tests"), mesh=MESHES[name],
                               params=str(job / "model_params.npz"),
                               drops="drops" in TASKS[name],
                               decode="decode" in TASKS[name], dest=str(dest)),
               devices=4, timeout=SPAWN_TIMEOUT)
        box[name] = dict(np.load(dest))
    except Exception as e:  # reported by the tests that read it
        box[name] = e


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """Runs every spawn and the JAX counterparts once, concurrently."""
    jax = pytest.importorskip("jax")
    from repro.models import lm as jlm

    root = tmp_path_factory.mktemp("ep")
    jcfg = _model_cfg("capacity", "repro")
    np.savez(root / "model_params.npz", **_flatten(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))))
    env, r = _jax_layer_inputs(root)
    waits = {}
    for name, (data, model) in MESHES.items():
        job = root / name
        job.mkdir()
        for f in ("layer.npz", "model_params.npz"):
            (job / f).symlink_to(root / f)
        (job / "job.json").write_text(json.dumps(
            {"mesh": [data, model], "tasks": TASKS[name]}))
        waits[name] = (job, _spawn(job, data * model))
    jax_box: dict = {}
    threads = [threading.Thread(target=_jax_dist, args=(root / n, n, jax_box))
               for n in MESHES if "model" in TASKS[n]]
    for th in threads:
        th.start()
    oracle = _jax_layer_oracle(env, r)
    runs = {}
    for name, (job, wait) in waits.items():
        ok, log = wait()
        world = MESHES[name][0] * MESHES[name][1]
        runs[name] = dict(ok=ok, log=log, ranks=[
            dict(np.load(job / f"rank{i}.npz")) if ok else None
            for i in range(world)])
    for th in threads:
        th.join(SPAWN_TIMEOUT)
    return dict(runs=runs, jax=jax_box, oracle=oracle)


def _ranks(ep, name):
    run = ep["runs"][name]
    assert run["ok"], run["log"]
    return run["ranks"]


def _jax_dist_result(ep, name):
    res = ep["jax"].get(name)
    assert isinstance(res, dict), res
    return res


def _close_to_scale(got, ref, rel, msg):
    np.testing.assert_allclose(got, ref, rtol=rel,
                               atol=rel * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_layer_matrix_matches_jax_single_rank(ep, name):
    ranks = _ranks(ep, name)
    world = len(ranks)
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"{dispatch}/{impl}"
            ref = ep["oracle"][key]
            y = np.concatenate([r[f"layer/{key}/y"] for r in ranks])
            np.testing.assert_allclose(y, ref["y"].reshape(y.shape),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
            for r in ranks:
                np.testing.assert_allclose(r[f"layer/{key}/load"], ref["load"],
                                           rtol=1e-5, atol=1e-6, err_msg=key)
                np.testing.assert_allclose(r[f"layer/{key}/drop_frac"],
                                           ref["drop_frac"], atol=1e-6)
                if dispatch == "ragged":
                    assert float(r[f"layer/{key}/drop_frac"]) == 0.0
    assert world == MESHES[name][0] * MESHES[name][1]


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_psum_layer_matrix_matches_jax_single_rank(ep, name):
    """The psum mode: each model group's ranks agree exactly (the
    all-reduce hands every rank the same sum), and the data rows' outputs,
    concatenated, match the single-rank layer."""
    ranks = _ranks(ep, name)
    data, model = MESHES[name]
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"{dispatch}/{impl}"
            ref = ep["oracle"][key]
            for rank, r in enumerate(ranks):
                lead = ranks[rank - rank % model]
                np.testing.assert_array_equal(r[f"psum/{key}/y"],
                                              lead[f"psum/{key}/y"], key)
                np.testing.assert_allclose(r[f"psum/{key}/load"], ref["load"],
                                           rtol=1e-5, atol=1e-6, err_msg=key)
                np.testing.assert_allclose(r[f"psum/{key}/drop_frac"],
                                           ref["drop_frac"], atol=1e-6)
                if dispatch == "ragged":
                    assert float(r[f"psum/{key}/drop_frac"]) == 0.0
            y = np.concatenate([ranks[d * model][f"psum/{key}/y"]
                                for d in range(data)])
            np.testing.assert_allclose(y, ref["y"].reshape(y.shape),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_psum_decode_matches_jax_distributed(ep, dispatch):
    """Reduced fastmoe-gpt, 1x2, greedy psum decode: every step's logits
    against the JAX package's distributed decode_step at 1e-4, the greedy
    tokens equal, and both ranks equal."""
    ranks = _ranks(ep, "1x2")
    ref = _jax_dist_result(ep, "1x2")
    key = f"decode/{dispatch}"
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}/logits"], ref[f"{key}/logits"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r[f"{key}/tokens"], ref[f"{key}/tokens"])
        np.testing.assert_array_equal(r[f"{key}/logits"],
                                      ranks[0][f"{key}/logits"])


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_layer_grads_match_jax(ep, name):
    """sync_grads averages the ranks' gradients and the objective here is
    their sum, so the synced gradient times the world size is compared."""
    ranks = _ranks(ep, name)
    world = len(ranks)
    model = MESHES[name][1]
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"{dispatch}/{impl}"
            ref = ep["oracle"][key]["grad"]
            xg = np.concatenate([r[f"layer/{key}/grad/x"] for r in ranks])
            _close_to_scale(xg, ref["x"].reshape(xg.shape), 1e-5, f"{key} x")
            for rank, r in enumerate(ranks):
                m = rank % model
                _close_to_scale(world * r[f"layer/{key}/grad/router/w"],
                                ref["router/w"], 1e-5, f"{key} router")
                for leaf in ("wi_gate", "wi_up", "wo"):
                    full = ref[f"experts/{leaf}"]
                    e = full.shape[0] // model
                    _close_to_scale(world * r[f"layer/{key}/grad/experts/{leaf}"],
                                    full[m * e:(m + 1) * e], 1e-5,
                                    f"{key} rank {rank} {leaf}")


def test_forced_drops_match_jax_distributed(ep):
    ranks = _ranks(ep, "2x2")
    ref = _jax_dist_result(ep, "2x2")
    y = np.concatenate([r["drops/ragged/fused/y"] for r in ranks])
    np.testing.assert_allclose(y, ref["drops/y"].reshape(y.shape), rtol=1e-5,
                               atol=1e-5)
    for r in ranks:
        drop = float(r["drops/ragged/fused/drop_frac"])
        assert drop > 0.05, drop  # the bound really drops rows
        np.testing.assert_allclose(drop, float(ref["drops/drop_frac"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["drops/ragged/fused/load"],
                                   ref["drops/load"], rtol=1e-6)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_model_matches_jax_distributed(ep, name, dispatch):
    """Reduced fastmoe-gpt with remat: step-0 loss, aux and z loss, drop
    fraction, load, every synced gradient leaf (expert leaves held to
    their slice), and the losses of two AdamW steps."""
    ranks = _ranks(ep, name)
    ref = _jax_dist_result(ep, name)
    model = MESHES[name][1]
    key = f"model/{dispatch}"
    for rank, r in enumerate(ranks):
        for k in ("loss", "aux_loss", "z_loss", "drop_frac", "losses"):
            np.testing.assert_allclose(r[f"{key}/{k}"], ref[f"{key}/{k}"],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r[f"{key}/load"], ref[f"{key}/load"],
                                   atol=1e-6)
        grads = _sub(r, f"{key}/grad")
        jgrads = _sub(ref, f"{key}/grad")
        assert grads.keys() == jgrads.keys()
        m = rank % model
        for path, g in grads.items():
            want = jgrads[path]
            if "/experts/" in path:  # (L, E_local, ...) of (L, E, ...)
                e = want.shape[1] // model
                want = want[:, m * e:(m + 1) * e]
            _close_to_scale(g, want, 1e-4, f"{name} {key} rank {rank} {path}")


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_sync_semantics_and_grad_norm(ep, name):
    """After sync_grads: world leaves identical on every rank, expert
    leaves identical within a data group and different across model ranks;
    the global grad norm equals JAX's."""
    ranks = _ranks(ep, name)
    ref = _jax_dist_result(ep, name)
    model = MESHES[name][1]
    for dispatch in DISPATCHES:
        key = f"model/{dispatch}"
        grads = [_sub(r, f"{key}/grad") for r in ranks]
        for path in grads[0]:
            if "/experts/" not in path:
                for g in grads[1:]:
                    np.testing.assert_array_equal(g[path], grads[0][path], path)
                continue
            for rank, g in enumerate(grads):
                peer = (rank + model) % len(ranks)  # same m, next data index
                np.testing.assert_array_equal(g[path], grads[peer][path], path)
                other = rank - rank % model + (rank + 1) % model
                assert not np.allclose(g[path], grads[other][path]), path
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/grad_norm"],
                                       ref[f"{key}/grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_world_size_1_is_the_local_path_bit_for_bit(ep, dispatch, impl):
    r = _ranks(ep, "1x1")[0]
    assert bool(r[f"bit_equal/{dispatch}/{impl}/grads"]), "loss or a grad"
    assert bool(r[f"bit_equal/{dispatch}/{impl}/step"]), "norm or params"


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_world_size_1_psum_decode_is_local_decode(ep, dispatch, impl):
    r = _ranks(ep, "1x1")[0]
    assert bool(r[f"bit_equal/{dispatch}/{impl}/psum_decode"]), \
        "psum decode logits or tokens differ from the local path's"


REFUSED = {
    "overlap_chunks": (dict(overlap_chunks=2), "item 2"),
    "wire_dtype": (dict(wire_dtype="bf16"), "item 2"),
    "tp_axis": (dict(tp_axis="data"), "item 1"),
    "placement": (dict(placement=object()), "item 4"),
    "psum_mode": (dict(token_axes=("data",)),
                  "training through the psum mode"),
    "node_axis": (dict(node_axis="node"), "item 6"),
    "inter_bound": (dict(inter_bound=8), "item 6"),
    "fsdp_axis": (dict(fsdp_axis="data"), "item 9"),
    "router": (dict(router="gumbel"), "item 3"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_unsupported_options_raise(what):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe
    from repro_torch.launch.mesh import Mesh

    kw, item = REFUSED[what]
    kw = {"token_axes": ("data", "model"), **kw}
    dist = fmoe.DistConfig(Mesh(1, 2), **kw)
    cfg = MoEConfig(**LAYER)
    gen = torch.Generator().manual_seed(0)
    params = fmoe.fmoe_init(gen, 32, cfg, device="cpu")
    # the psum mode serves: it refuses autograd recording
    x = torch.zeros(8, 32, requires_grad=what == "psum_mode")
    with pytest.raises(NotImplementedError, match=item):
        fmoe.fmoe_apply(params, x, cfg, dist=dist)


def test_local_carrier_is_the_local_path():
    """``DistConfig.local()`` (no mesh) runs the single-worker path."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe

    cfg = MoEConfig(**LAYER)
    gen = torch.Generator().manual_seed(0)
    params = fmoe.fmoe_init(gen, 32, cfg, device="cpu")
    x = torch.randn(16, 32, generator=gen)
    y0, m0 = fmoe.fmoe_apply(params, x, cfg)
    y1, m1 = fmoe.fmoe_apply(params, x, cfg, dist=fmoe.DistConfig.local())
    assert torch.equal(y0, y1) and torch.equal(m0.load, m1.load)


def test_serial_exchange_refuses_chunks_and_psum_from_moe_dist():
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import pipeline
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh

    x = torch.zeros(2, 4, 3)
    with pytest.raises(NotImplementedError, match="item 2"):
        pipeline.chunked_all_to_all(x, None, 2, n_chunks=2)
    with pytest.raises(NotImplementedError, match="item 2"):
        pipeline.pipelined_expert_exchange(x[:, None], None, 2, 1,
                                           lambda b: b, wire_dtype="bf16")
    cfg = reduced(get_config("fastmoe-gpt"))
    mesh = Mesh(2, 2)
    assert train.moe_dist(cfg, mesh, 64).mode == "a2a"
    assert train.moe_dist(cfg, mesh, 62).mode == "psum"  # 62 % 4 != 0
    assert train.moe_dist(cfg, Mesh(1, 3), 63) is None  # 4 experts, 3 ranks


def test_train_cli_under_torchrun():
    """The README's command, 4 ranks of gloo on a 2x2 mesh: exits 0 with a
    falling loss."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "4", "-m", "repro_torch.launch.train",
           "--mesh", "2x2", "--device", "cpu", "--reduced", "--steps", "2",
           "--log_every", "1"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("step")]
    assert len(lines) == 2, out.stdout  # rank 0 logs alone
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    assert 5.0 < losses[0] < 8.0 and losses[1] < losses[0], losses


def test_batcher_refuses_a_data_axis():
    """Serving with a mesh takes 1xM meshes: a data axis needs a batcher
    per data group (ROADMAP §1 item 5)."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve_api import ServeConfig
    from repro_torch.models import lm

    cfg = _model_cfg("ragged")
    params = lm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        ContinuousBatcher(params, cfg, ServeConfig(slots=2), mesh=Mesh(2, 2),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        ContinuousBatcher(params, cfg, ServeConfig(slots=2, mesh="2x2"),
                          device="cpu")


@pytest.mark.parametrize("mode", ["continuous", "static"])
def test_serve_cli_under_torchrun(mode):
    """The README's command: serving over a 1x2 mesh of gloo ranks in the
    psum mode, continuous (every request served) or one static batch,
    rank 0 printing alone, the first sequence's greedy tokens those of the
    single-process run."""
    cmd = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--reduced",
           "--prompt_len", "8", "--gen", "4"]
    cmd += (["--continuous", "--slots", "2", "--requests", "3",
             "--block_size", "4"] if mode == "continuous" else ["--batch", "2"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    runs = [subprocess.run([sys.executable] + pre + cmd + post,
                           capture_output=True, text=True, env=env, cwd=ROOT,
                           timeout=SPAWN_TIMEOUT)
            for pre, post in (([], []),
                              (["-m", "torch.distributed.run", "--standalone",
                                "--nproc_per_node", "2"], ["--mesh", "1x2"]))]
    for out in runs:
        assert out.returncode == 0, out.stderr[-3000:]
    lines = [out.stdout.strip().splitlines() for out in runs]
    assert len(lines[0]) == len(lines[1]) == 2, [o.stdout for o in runs]
    assert "mesh 1x2 (psum)" in lines[1][0]
    if mode == "continuous":
        for ln in (lines[0][0], lines[1][0]):
            assert "3 requests, 12 tokens" in ln, ln
    assert lines[0][1] == lines[1][1]  # the first sequence's tokens


@pytest.mark.cuda
def test_world_size_1_bit_equal_on_the_card(tmp_path):
    """NCCL at world size 1 with the CUDA kernels: the EP path's loss and
    gradients equal the local path's bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU machine: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_ep.py, or python3 "
                    "chip_smoke.py, whose EP phase checks the same at full "
                    "width)")
    import torch.distributed as tdist
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    dev = init_distributed("cuda", rank=0, world_size=1,
                           store=tdist.FileStore(str(tmp_path / "store"), 1),
                           timeout=STORE_TIMEOUT)
    try:
        mesh = make_local_mesh(1, 1)
        for dispatch, impl in (("capacity", "fused"), ("ragged", "fused"),
                               ("ragged", "pallas")):
            cfg = _model_cfg(dispatch, d_model=256)  # heads of 64
            params = lm.init_params(cfg, seed=0, device=dev,
                                    param_dtype=cfg.param_dtype)
            batch = {"tokens": torch.from_numpy(_tokens(0)).to(dev)}
            res = [train.loss_and_grads(params, cfg, batch, impl=impl,
                                        device=dev, dist=d)
                   for d in (None, train.moe_dist(cfg, mesh, MODEL_B * MODEL_S))]
            (l0, _, g0), (l1, _, g1) = res
            assert torch.equal(l0, l1), (dispatch, impl)
            for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
                assert torch.equal(a, b), (dispatch, impl)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]), int(sys.argv[2]))
