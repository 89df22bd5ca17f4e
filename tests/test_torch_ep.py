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
* *model* (1x2, 2x2): reduced ``fastmoe-gpt`` with ``remat="full"``, its
  params in the train layout (``launch/sharding``), the step-0 loss, aux
  and z loss, every gradient leaf after ``sync_grads`` (the rank's block),
  the global grad norm, and two train steps' losses against the JAX
  package's distributed ``lm.loss_fn`` under the same ``DistConfig`` on
  fake CPU devices (``tests/dist_utils.run``) at 1e-4 (of the leaf's
  largest magnitude for gradients) — a sharded aux loss is the mean of
  per-shard losses and capacity drops are decided per rank, so the
  single-rank model is not the counterpart: a2a (``("data", "model")``)
  and the psum mode (``()`` on 1x2, ``("data",)`` on 2x2); and the sync
  semantics: every leaf equal on the ranks that hold the same block of it,
  expert leaves different between blocks;
* *tensor parallelism* (2x2, capacity, ``tp_axis="data"``): the layer for
  each impl (``y``, ``load``, the gradients of ``sum(y * r)``, each rank
  its hidden slice of its experts) against the JAX package's layer with
  the same ``tp_axis`` at 1e-5, the model against its distributed
  ``loss_fn`` at 1e-4, and the sync semantics (a tp expert leaf differs
  across data ranks; the grad norm is the whole gradient's);
* *world size 1* (1x1): the exchange is an identity, and the EP path's
  loss and every gradient equal the local path's bit for bit, as do the
  params after one train step — a2a, the psum mode, and tp (capacity);
  and psum decode equals local decode;
* *psum layer matrix* (1x2 and 1x4 with ``token_axes=()``, 2x2 with
  ``("data",)``): the same {capacity, ragged} x {einsum, pallas, fused}
  cases in the psum mode (every rank of a model group holds the same
  tokens), ``y``, ``load`` and ``drop_frac`` against JAX's single-rank
  layer at 1e-5 — the reference's own psum cell
  (``tests/test_distributed.py``) — and the gradients against
  ``jax.grad`` of it at 1e-5 of each leaf's largest magnitude;
* *psum decode* (1x2): reduced ``fastmoe-gpt`` decoding greedily through
  ``lm.decode_step(dist=serve.decode_dist(...))``, logits against the JAX
  package's distributed ``lm.decode_step`` on fake CPU devices at 1e-4,
  greedy tokens equal;
* *the routing zoo* (1x2, 2x2, 1x4): noisy_topk and gumbel with a seed,
  expert_choice and frozen, a2a and the psum mode, both dispatches
  (fused): ``y``, ``load``, ``drop_frac`` and the gradients (every router
  leaf) against the single-rank oracle at 1e-5 — the port's own local
  layer with the same seed for the exploration routers (a rank draws its
  rows of the whole token set's noise; that layer is held to JAX's with
  JAX's draw in ``tests/test_torch_routers.py``), JAX's single-rank layer
  for frozen, and JAX's layer applied to each token shard for
  expert-choice, whose experts pick from the tokens a rank holds; at 1x1
  each router's a2a and psum step (loss, gradients, params after AdamW)
  equals the local one bit for bit, and a noisy and an expert-choice step
  repeat bit for bit;
* placement (1x2, 1x4, the node mesh 1x2x2): the a2a layer under a plan
  with shadowed experts, shrunk capacities, migration across the ranks
  and the ReplanHook; and the psum mode under it (1x2, 1x4): the placed
  layer for each router, dispatch and impl against JAX's single-rank
  layer and, on 1x2, its placed psum layer, bit-equal to the identity
  plan's (the slot-wise reduction); the placed psum train step (1x2)
  against JAX's distributed ``loss_fn`` under the same plan;
* serving under placement: on 1x2 the reference's mid-stream replan cell
  (the same stream with a plan switched in at tick 3 gives the tokens of
  never switching, of the one-process batcher and of JAX's batcher), on
  2x2 a batcher per data group (the one-process batcher's completions,
  unplaced and switched, and JAX's 2x2 batcher's), and ``serve
  --continuous --mesh 2x2 --replan_every 2`` under ``torchrun``;
* telemetry and checkpoints: the seven counters of the reduced model's
  loss aux (a2a and the psum mode on 1x2 and 2x2) and of the two-level
  layer (1x2x2) against the JAX package's; the collective tally
  (``core.comm``) of a layer's forward and backward the same with the
  counters on and off (1x2, 2x2, 1x4); the ReplanHook's sink trail
  (monitor snapshots, the replan, the rollback verdict); a checkpoint
  saved on 1x2 in the train layout under a per-layer plan with shadowed
  experts restored at
  1x1 by both packages to the unplaced params, bit for bit;
* refusals of what the slice does not carry (ragged dispatch with tp
  among them), and the ``torchrun`` CLIs of training (a2a, and the psum
  mode where 2 rows do not split over 4 ranks) and of continuous
  serving.
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
SPAWN_TIMEOUT = 300  # seconds a spawn of ranks may take before it is killed
STORE_TIMEOUT = datetime.timedelta(seconds=150)  # a collective's own limit
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "1x4": (1, 4)}
# the node mesh of the two-level exchange: (data, node, model)
NODE_MESHES = {"1x2x2": (1, 2, 2)}
TASKS = {"1x1": ["bit_equal"],
         "1x2": ["layer", "model", "decode", "overlap", "zoo", "placement",
                 "serve"],
         "2x2": ["layer", "model", "drops", "tp", "overlap", "zoo", "serve"],
         "1x4": ["layer", "zoo", "placement"], "1x2x2": ["hier", "placement"]}
# the routers other than topk, and the exploration seed of the zoo task
ZOO = ("noisy_topk", "gumbel", "expert_choice", "frozen")
ZOO_SEED = 11
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
OVERLAP_CHUNKS = (2, 3, 4)  # the §5.2 schedule's depths (3 falls back to 2
# where the capacity or bound does not divide by it)
CHUNK_GRAD_ATOL = 1e-6  # chunked gradients against serial (dW summed a
# chunk at a time reassociates its f32 sums): the reference's own bound
WIRE_ATOL = 0.05  # the bf16 wire against f32, as the reference holds it
# inter bounds of the two-level exchange at these inputs: the tightest that
# drops nothing (40 of the 128 rows a slim shard may hold), and one that
# makes the forwarding agents drop (6.6% of the rows)
HIER_IB, HIER_DROP_IB = 40, 32
# placement: the layer's experts permuted by PLACE_SEED's permutation, the
# last mp of them shadowed; PLACE_SHRINK the exchange's capacity scale that
# makes the owned experts drop rows (main capacity 16 rows of 128 on 1x2, 8
# of 64 on 1x4, against ~16 and ~8 arrivals an expert)
PLACE_SEED, PLACE_SHRINK = 31, 0.1
# serving under placement: the reference's mid-stream replan cell
# (tests/test_scheduler.py): 8 requests over 4 slots, a per-layer plan
# (a permutation per layer, 2 shadowed experts) switched in at tick 3
SERVE_SWITCH, SERVE_PERMS = 3, ((1, 3, 0, 2), (2, 0, 3, 1))
HOOK_STEPS, HOOK_LOSSES = 8, (6.0, 6.0, 6.0, 9.0, 9.0, 9.0, 6.0, 6.0)
# serving on a mesh under the reference's layouts (the "serve" task, 1x2
# and 2x2): static decode of a dense and an MoE config under the train-
# and the serve-mode specs, each against the JAX package's jit_serve_step
SL_ARCHS = ("qwen2-72b", "fastmoe-gpt")
SL_OPTS = {"train": {}, "serve_tp": {"serve_tp": True}}
SL_PARAMS = {"qwen2-72b": "dense_params.npz",
             "fastmoe-gpt": "model_params.npz"}
# the telemetry counters of loss_fn's aux (both packages' keys)
COUNTERS = ("wire_elems", "wire_bytes", "wire_bytes_intra",
            "wire_bytes_inter", "dropped", "shadow_hits", "imbalance")


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


def _dense_cfg(package="repro_torch"):
    """Reduced qwen2-72b (2 layers, d 64: 4 heads and 4 kv heads of 16,
    QKV bias, SwiGLU FFN 224 wide, vocab 512) of ``package``'s configs."""
    import importlib

    configs = importlib.import_module(f"{package}.configs")
    return configs.reduced(configs.get_config("qwen2-72b"), num_layers=2,
                           d_model=64)


def _sl_cfg(arch, package="repro_torch"):
    """The serve layout's cases: reduced qwen2-72b (dense) or reduced
    fastmoe-gpt (ragged)."""
    return (_dense_cfg(package) if arch == "qwen2-72b"
            else _model_cfg("ragged", package))


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


def _layer_inputs(job, mesh):
    """The layer's inputs: x and r (T, d) whole, the whole router and
    expert params, and this rank's rows of the a2a mode."""
    inp = dict(np.load(job / "layer.npz"))
    d = inp["x"].shape[-1]
    x = torch.from_numpy(inp["x"]).reshape(-1, d)
    r = torch.from_numpy(inp["r"]).reshape(-1, d)
    t = x.shape[0] // mesh.size
    whole = _unflatten({k: torch.from_numpy(v) for k, v in inp.items()
                        if k.startswith(("router/", "experts/"))})
    return x, r, whole, slice(mesh.rank * t, (mesh.rank + 1) * t)


def _lone_layout(tree, mesh, tp=False):
    """The layout lone layers' params (one layer's, or a stack of them)
    are held in: the router whole, each expert stack its expert rows over
    the mesh's expert axes (under expert-internal TP its hidden units over
    data too)."""
    from repro_torch.core.sync import is_expert_path
    from repro_torch.launch.sharding import Layout, flat_paths
    axes = mesh.expert_axes
    ea, hidden = axes if len(axes) > 1 else axes[0], "data" if tp else None
    specs = {p: ((ea, hidden, None) if p.endswith("wo") else
                 (ea, None, hidden)) if is_expert_path(p) else (None,) * t.ndim
             for p, t in flat_paths(tree)}
    return Layout(mesh, specs)


def _lone_shard(tree, mesh, tp=False):
    """This rank's shard of whole lone-layer params under
    :func:`_lone_layout`."""
    from repro_torch import interop
    return interop.shard_params(tree, _lone_layout(tree, mesh, tp))


def _layer_layout(params, dist):
    """The lone layer's layout as :func:`_layer_run` holds its params."""
    return _lone_layout(params, dist.mesh, dist.expert_tp)


def _layer_run(key, params, dist, dispatch, impl, x, r, rows, out,
               grads=True, router="topk", noise_seed=None, l2p=None):
    """y, load, drop_frac and the synced gradients of sum(y * r) over the
    rank's rows (every router leaf; zeros for one the router leaves
    unused)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe
    from repro_torch.core.sync import sync_grads

    cfg = MoEConfig(dispatch=dispatch, router=router, **LAYER)
    p = {k: {n: t.clone().requires_grad_() for n, t in v.items()}
         for k, v in params.items()}
    xs = x[rows].clone().requires_grad_()
    y, m = fmoe.fmoe_apply(p, xs, cfg, act="swiglu", dist=dist, impl=impl,
                           noise_seed=noise_seed, l2p=l2p)
    out.update({f"{key}/y": y.detach(), f"{key}/load": m.load,
                f"{key}/drop_frac": m.drop_frac})
    for k, v in m.obs.as_dict().items():  # the telemetry counters
        out[f"{key}/obs/{k}"] = torch.as_tensor(v).detach().float()
    if not grads:
        return
    g_leaves = list(p["router"].values()) + list(p["experts"].values())
    g = torch.autograd.grad((y * r[rows]).sum(), g_leaves + [xs],
                            allow_unused=True, materialize_grads=True)
    nr = len(p["router"])
    tree = {"router": dict(zip(p["router"], g[:nr])),
            "experts": dict(zip(p["experts"], g[nr:-1]))}
    sync_grads(tree, dist._replace(layout=_layer_layout(params, dist)))
    for k, v in _flatten(tree).items():
        out[f"{key}/grad/{k}"] = v
    out[f"{key}/grad/x"] = g[-1]


def _layer_task(spec, job, mesh, out):
    from repro_torch.core import fmoe

    x, r, whole, rows = _layer_inputs(job, mesh)

    def run(key, params, dist, dispatch, impl, rows, grads=True):
        _layer_run(key, params, dist, dispatch, impl, x, r, rows, out, grads)

    params = _lone_shard(whole, mesh)
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            run(f"layer/{dispatch}/{impl}", params,
                fmoe.DistConfig(mesh, ("data", "model")), dispatch, impl, rows)
    _tally_on_off(params, x, r, rows, mesh, out)
    if "drops" in spec["tasks"]:
        run("drops/ragged/fused", params,
            fmoe.DistConfig(mesh, ("data", "model"), ragged_bound=DROP_BOUND),
            "ragged", "fused", rows, grads=False)
    # the psum mode: a model group holds the same tokens, its data row's
    # block of them where the mesh has a data axis
    data = mesh.shape["data"]
    dist = fmoe.DistConfig(mesh, ("data",) if data > 1 else ())
    assert dist.mode == "psum"
    t = x.shape[0] // data
    d = mesh.coords()[0]
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            run(f"psum/{dispatch}/{impl}", params, dist, dispatch, impl,
                slice(d * t, (d + 1) * t))
    if "tp" in spec["tasks"]:  # expert-internal tensor parallelism
        dist = fmoe.DistConfig(mesh, ("data", "model"), tp_axis="data")
        tp_params = _lone_shard(whole, mesh, tp=True)
        for impl in IMPLS:
            run(f"tp_layer/capacity/{impl}", tp_params, dist, "capacity", impl,
                rows)


TALLY_OPS = ("all-to-all", "collective-permute", "all-reduce", "all-gather",
             "reduce-scatter")
TALLY_CASES = {"capacity": ("capacity", {}),
               "capacity_chunks_bf16": ("capacity", dict(overlap_chunks=2,
                                                         wire_dtype="bf16")),
               "ragged": ("ragged", {}),
               "psum": ("capacity", None)}


def _tally_on_off(params, x, r, rows, mesh, out):
    """The collectives one layer's forward and backward issue (core.comm's
    tally: calls and bytes by op) with the telemetry counters on and off,
    for the a2a exchanges and the psum mode."""
    from repro_torch.core import comm, fmoe

    for name, (dispatch, kw) in TALLY_CASES.items():
        for obs in (True, False):
            if kw is None:  # the psum mode over (), every row
                dist = fmoe.DistConfig(mesh, (), obs=obs)
                take = slice(None)
            else:
                dist = fmoe.DistConfig(mesh, ("data", "model"), obs=obs, **kw)
                take = rows
            comm.tally_reset()
            _layer_run(f"tally/{name}/{obs}", params, dist, dispatch, "einsum",
                       x, r, take, out)
            calls, byts = comm.tallied_calls(), comm.tallied()
            out[f"tally/{name}/{obs}/calls"] = np.asarray(
                [calls.get(op, 0) for op in TALLY_OPS])
            out[f"tally/{name}/{obs}/bytes"] = np.asarray(
                [byts.get(op, 0) for op in TALLY_OPS], np.float64)


def _zoo_params(whole, job):
    """The whole layer params with the zoo's router leaves (w_noise,
    w_frozen) beside ``w``."""
    inp = np.load(job / "layer.npz")
    router = {**whole["router"],
              **{k: torch.from_numpy(inp[f"zoo/{k}"])
                 for k in ("w_noise", "w_frozen")}}
    return {**whole, "router": router}


def _zoo_task(spec, job, mesh, out):
    """Every router but topk, a2a and the psum mode, both dispatches: the
    layer's y, metrics and synced gradients (``_layer_run``)."""
    from repro_torch.core import fmoe

    x, r, whole, rows = _layer_inputs(job, mesh)
    params = _lone_shard(_zoo_params(whole, job), mesh)
    data = mesh.shape["data"]
    t = x.shape[0] // data
    d = mesh.coords()[0]
    modes = {"a2a": (fmoe.DistConfig(mesh, ("data", "model")), rows),
             "psum": (fmoe.DistConfig(mesh, ("data",) if data > 1 else ()),
                      slice(d * t, (d + 1) * t))}
    for router in ZOO:
        for dispatch in DISPATCHES:
            for mode, (dist, rws) in modes.items():
                _layer_run(f"zoo/{mode}/{router}/{dispatch}", params, dist,
                           dispatch, "fused", x, r, rws, out, router=router,
                           noise_seed=ZOO_SEED)


def _place_plan(P, mp: int, scale: float = 1.0, seed: int = PLACE_SEED,
                num_shadow: int | None = None):
    """The placement task's plan in package ``P`` (``repro.placement`` or
    ``repro_torch.placement``): a seeded permutation of the layer's
    experts, the last ``mp`` shadowed (``num_shadow`` to override)."""
    E = LAYER["num_experts"]
    perm = tuple(int(i) for i in np.random.default_rng(seed).permutation(E))
    return P.ExpertPlacement(E, mp, perm,
                             num_shadow=mp if num_shadow is None
                             else num_shadow, capacity_scale=scale)


def _rank_rows_of(whole_phys, plan, m: int):
    """Rank ``m``'s expert rows of a whole leaf in ``plan``'s physical
    order: its owned block, then the shadowed experts."""
    en = plan.num_owned // plan.num_ranks
    return np.concatenate([whole_phys[m * en:(m + 1) * en],
                           whole_phys[plan.num_owned:]])


def _placement_task(spec, job, mesh, out):
    """Expert placement across ranks: the a2a layer under a plan with mp
    shadowed experts (capacity and ragged, each impl, serial and at 2
    chunks, expert-choice; flat, and two-level on the node mesh), a shrunk
    exchange capacity that drops, migration between plans across the
    ranks, and (1x2) one ReplanHook replan and its rollback."""
    from repro_torch import placement as TP
    from repro_torch.core import fmoe

    x, r, whole, rows = _layer_inputs(job, mesh)
    mp = mesh.axes_size(mesh.expert_axes)
    m = mesh.axis_index(mesh.expert_axes)
    node = "node" in mesh.axis_names
    base = fmoe.DistConfig(mesh, tuple(mesh.axis_names),
                           expert_axis=mesh.expert_axes if node else "model",
                           node_axis="node" if node else None)

    def placed(params, plan):
        phys = TP.from_logical({k: {n: t.clone() for n, t in v.items()}
                                for k, v in params.items()}, plan)
        return {"router": phys["router"],
                "experts": {n: torch.from_numpy(_rank_rows_of(
                    t.numpy(), plan, m)) for n, t in phys["experts"].items()}}

    plan = _place_plan(TP, mp)
    params = placed(whole, plan)
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            for oc in (0, 2):
                _layer_run(f"place/{dispatch}/{impl}/{oc}", params,
                           base._replace(placement=plan, overlap_chunks=oc),
                           dispatch, impl, x, r, rows, out,
                           grads=oc == 0 or impl == "fused")
        zoo = placed(_zoo_params(whole, job), plan)
        _layer_run(f"place/ec/{dispatch}", zoo, base._replace(placement=plan),
                   dispatch, "fused", x, r, rows, out, router="expert_choice")
    if node:
        return
    # the psum mode (1xM: every rank holds every token) under the plan, and
    # under the identity plan with its table (the slot-wise reduction
    # too): each router, dispatch and impl
    psum = fmoe.DistConfig(mesh, ())
    ident = TP.identity_placement(LAYER["num_experts"], mp)
    for router in ("topk", "expert_choice"):
        src = whole if router == "topk" else _zoo_params(whole, job)
        p_plan, p_ident = placed(src, plan), placed(src, ident)
        for dispatch in DISPATCHES:
            for impl in IMPLS:
                key = f"place_psum/{router}/{dispatch}/{impl}"
                _layer_run(key, p_plan, psum._replace(placement=plan),
                           dispatch, impl, x, r, slice(None), out,
                           router=router)
                _layer_run(f"{key}/identity", p_ident,
                           psum._replace(placement=ident), dispatch, impl, x,
                           r, slice(None), out, grads=False, router=router,
                           l2p=torch.arange(LAYER["num_experts"]))
    shrunk = plan._replace(capacity_scale=PLACE_SHRINK)
    for impl in IMPLS:
        _layer_run(f"place/shrunk/{impl}", params,
                   base._replace(placement=shrunk), "capacity", impl, x, r,
                   rows, out, grads=False)

    # migration across the ranks: a 2-layer tree and its AdamW state, from
    # the identity shards through a per-layer plan with shadows to a shared
    # plan without, and back to logical order
    from repro_torch.optim import AdamWState
    tree = {"layers": [whole, {k: {n: t * 2 for n, t in v.items()}
                               for k, v in whole.items()}]}
    shard = _lone_shard(tree, mesh)
    state = AdamWState(3, _lone_shard(
        {"layers": [{k: {n: t + 1 for n, t in v.items()}
                     for k, v in layer.items()} for layer in tree["layers"]]},
        mesh), {"layers": [{}, {}]})
    plan_a = TP.per_layer_placement([_place_plan(TP, mp),
                                     _place_plan(TP, mp, seed=PLACE_SEED + 1)])
    plan_b = _place_plan(TP, mp, seed=PLACE_SEED + 2, num_shadow=0)
    ident = TP.identity_placement(LAYER["num_experts"], mp)
    for key, (old, new) in (("a", (ident, plan_a)), ("b", (plan_a, plan_b)),
                            ("back", (plan_b, ident))):
        for t in (shard, state):
            TP.migrate(t, old, new, mesh=mesh)
        for k, v in _flatten({"p": {str(i): l for i, l in
                                    enumerate(shard["layers"])},
                              "mu": {str(i): l for i, l in
                                     enumerate(state.mu["layers"])}}).items():
            if "/experts/" in k:  # a copy: a later step permutes in place
                out[f"migrate/{key}/{k}"] = v.copy()
    if mesh.shape == {"data": 1, "model": 2}:
        _hook_run(mesh, out)


def _hook_run(mesh, out):
    """One ReplanHook replan (forced: ``min_gain=-10``) and its rollback on
    a seeded skewed load and a loss series that regresses after the
    replan, with real train steps between them under the rebuilt steps."""
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.obs.sink import MemorySink
    from repro_torch.optim import AdamW

    cfg = _model_cfg("capacity")
    opt = AdamW(lr=LR)
    sink = MemorySink()
    hook = train.ReplanHook(cfg, opt, mesh, MODEL_B, MODEL_S, every=2,
                            opts=dict(impl="einsum", device="cpu"), sink=sink)
    hook.controller.min_gain = -10.0
    params = lm.init_params(cfg, device="cpu", param_dtype="float32",
                            layout=hook.opts["layout"])
    state = opt.init(params)
    step_fn = hook.build()
    skew = 1.0 / (np.arange(cfg.moe.num_experts) + 1) ** 1.5
    events, losses = [], []
    for step in range(HOOK_STEPS):
        params, state, m = step_fn(
            params, state, {"tokens": torch.from_numpy(_tokens(step))}, step)
        losses.append(float(m["loss"]))
        params, state, new_fn = hook.observe(
            step, {"load": skew, "drop_frac": 0.0}, params, state,
            loss=HOOK_LOSSES[step])
        if new_fn is not None:
            step_fn = new_fn
            events.append([step, hook.controller.replans,
                           hook.controller.rollbacks])
            if hook.controller.rollbacks == 0:
                p = hook.placement
                out["hook/plan"] = np.asarray([*p.physical_to_logical,
                                               p.num_shadow])
    out["hook/events"] = np.asarray(events)
    out["hook/losses"] = np.asarray(losses)
    out["hook/final_identity"] = np.asarray(hook.placement.is_identity)
    out["hook/sink"] = np.asarray([f"{r['kind']}@{r['step']}"
                                   for r in sink.records])


# options the port refused before the §5.2 schedule and the two-level
# exchange: each now runs (on a mesh without a node axis, node_axis and
# inter_bound keep the flat exchange, as the reference's)
FORMER_REFUSALS = {"overlap_chunks": dict(overlap_chunks=2),
                   "wire_dtype": dict(wire_dtype="bf16"),
                   "node_axis": dict(node_axis="node"),
                   "inter_bound": dict(inter_bound=8)}


def _overlap_task(spec, job, mesh, out):
    """The §5.2 schedule: the layer matrix at each of OVERLAP_CHUNKS, with
    the undecomposed exchange (one all-to-all a chunk) at 4, and with the
    bf16 wire; tp with chunks (2x2); the options the port refused before;
    the reduced model with chunks against the JAX package (2x2)."""
    from repro_torch.core import fmoe
    from repro_torch.launch import train

    x, r, whole, rows = _layer_inputs(job, mesh)
    params = _lone_shard(whole, mesh)
    base = fmoe.DistConfig(mesh, ("data", "model"))
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            runs = {f"overlap{n}": dict(overlap_chunks=n)
                    for n in OVERLAP_CHUNKS}
            runs["overlap4_undecomposed"] = dict(overlap_chunks=4,
                                                 decompose=False)
            runs["wire"] = dict(wire_dtype="bf16")
            for name, kw in runs.items():
                _layer_run(f"{name}/{dispatch}/{impl}", params,
                           base._replace(**kw), dispatch, impl, x, r, rows,
                           out)
    for what, kw in FORMER_REFUSALS.items():
        _layer_run(f"former/{what}", params, base._replace(**kw), "ragged",
                   "fused", x, r, rows, out)
    if "tp" in spec["tasks"]:
        tp_params = _lone_shard(whole, mesh, tp=True)
        for impl in IMPLS:
            _layer_run(f"tp_overlap/capacity/{impl}", tp_params,
                       base._replace(tp_axis="data", overlap_chunks=2),
                       "capacity", impl, x, r, rows, out)
        params_np = _unflatten(dict(np.load(job / "model_params.npz")))
        for dispatch in DISPATCHES:
            cfg = _model_cfg(dispatch)
            dist = train.moe_dist(cfg, mesh, MODEL_B, overlap_chunks=2)
            assert dist.mode == "a2a" and dist.overlap_chunks == 2
            _model_run(f"overlap_model/{dispatch}", params_np, cfg, dist,
                       MODEL_IMPL[dispatch], out)


def _hier_task(spec, job, mesh, out):
    """The two-level exchange on a (data, node, model) mesh: for each impl,
    the flat exchange and the two-level one at overlap_chunks 0 and 4 and
    inter bounds 0 and HIER_IB (ragged); capacity on the node mesh (a flat
    exchange over (node, model)); the agents' drops at HIER_DROP_IB; the
    bf16 wire over both levels against the flat exchange's."""
    from repro_torch.core import fmoe

    x, r, whole, rows = _layer_inputs(job, mesh)
    params = _lone_shard(whole, mesh)
    hier = fmoe.DistConfig(mesh, tuple(mesh.axis_names),
                           expert_axis=("node", "model"), node_axis="node")
    flat = hier._replace(node_axis=None)

    def run(key, dist, dispatch="ragged", impl="fused", grads=True):
        _layer_run(key, params, dist, dispatch, impl, x, r, rows, out, grads)

    for impl in IMPLS:
        for oc in (0, 4):
            run(f"flat/{oc}/{impl}", flat._replace(overlap_chunks=oc),
                impl=impl)
            for ib in (0, HIER_IB):
                run(f"hier/{oc}/{ib}/{impl}",
                    hier._replace(overlap_chunks=oc, inter_bound=ib),
                    impl=impl)
        run(f"hier_capacity/{impl}", hier, "capacity", impl)
    run("hier_drops", hier._replace(overlap_chunks=2,
                                    inter_bound=HIER_DROP_IB),
        impl="einsum", grads=False)
    run("hier_wire", hier._replace(wire_dtype="bf16", inter_bound=HIER_IB))
    run("flat_wire", flat._replace(wire_dtype="bf16"))
    # the comm helpers nothing calls: rank r's (n_nodes, n_inner, 3) block
    # of a seeded (ranks, n_nodes, n_inner, 3) array
    from repro_torch.core import comm
    buf = torch.from_numpy(_comm_input()[mesh.rank])
    out["comm/hierarchical"] = comm.hierarchical_all_to_all(
        buf, mesh.group("model"), mesh.group("node"))
    experts = mesh.group(("node", "model"))
    out["comm/bf16"] = comm.all_to_all_bf16(
        buf.reshape(4, -1), experts).reshape(buf.shape)
    # Fig 2's steps over (node, model): 8 experts' counts and (4, 2, 3)
    # capacity buffers of 4 experts, exchanged and returned
    tokens = buf.reshape(4, 1, 3).expand(4, 2, 3).contiguous()
    out["comm/counts"] = comm.exchange_counts(
        (buf.reshape(-1)[:8] * 10).round().to(torch.int32), experts)
    out["comm/tokens"] = comm.exchange_tokens(tokens, experts)
    out["comm/returned"] = comm.return_tokens(out["comm/tokens"], experts)


def _comm_input():
    return np.random.default_rng(5).standard_normal((4, 2, 2, 3)).astype(
        np.float32)


def _model_run(key, params_np, cfg, dist, impl, out):
    """Reduced fastmoe-gpt under ``dist`` and the train layout from the
    JAX params: the step-0 loss, aux, every synced gradient leaf (the
    rank's shard) and the grad norm, then two train steps' losses."""
    from repro_torch import interop
    from repro_torch.core.sync import sync_grads
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import global_norm

    dist = train.train_dist(cfg, dist)
    params = interop.from_jax(params_np, cfg, device="cpu",
                              layout=dist.layout)
    if dist.placement is not None:  # the identity shards -> the plan's
        from repro_torch import placement as TP
        TP.from_logical(params, dist.placement, mesh=dist.mesh)
    rows = train._rank_rows(torch.from_numpy(_tokens(0)), dist)
    loss, aux, grads = train.loss_and_grads(
        params, cfg, {"tokens": rows}, impl=impl, device="cpu", dist=dist)
    sync_grads(grads, dist)
    out[f"{key}/loss"] = train._mean_over_ranks(loss, dist.mesh)
    for k in ("aux_loss", "z_loss", "drop_frac", "load", *COUNTERS):
        out[f"{key}/{k}"] = aux[k]
    out[f"{key}/grad_norm"] = global_norm(grads, dist)
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
            params, state, {"tokens": torch.from_numpy(_tokens(step))}, step)
        losses.append(float(m["loss"]))
    out[f"{key}/losses"] = np.asarray(losses)


def _model_task(spec, job, mesh, out):
    """a2a (the rows split over every rank: ``moe_dist`` picks it) and the
    psum mode over the data axis's blocks, or over () without one."""
    from repro_torch.core import fmoe
    from repro_torch.launch import train

    params_np = _unflatten(dict(np.load(job / "model_params.npz")))
    psum = fmoe.DistConfig(mesh, ("data",) if mesh.shape["data"] > 1 else ())
    for dispatch in DISPATCHES:
        cfg = _model_cfg(dispatch)
        dist = train.moe_dist(cfg, mesh, MODEL_B)
        assert dist.mode == "a2a"
        _model_run(f"model/{dispatch}", params_np, cfg, dist,
                   MODEL_IMPL[dispatch], out)
        _model_run(f"psum_model/{dispatch}", params_np, cfg, psum,
                   MODEL_IMPL[dispatch], out)
        if mesh.shape["data"] == 1:  # the placed psum train step
            _model_run(f"place_psum_model/{dispatch}", params_np, cfg,
                       psum._replace(placement=_serve_plan(
                           mesh.shape["model"])),
                       MODEL_IMPL[dispatch], out)
    if mesh.shape["data"] == 1:
        _placed_checkpoint(params_np, job, mesh, out)
    if "tp" in spec["tasks"]:
        cfg = _model_cfg("capacity")
        dist = train.moe_dist(cfg, mesh, MODEL_B, expert_tp=True)
        assert dist.tp_axis == "data" and dist.expert_tp
        for impl in IMPLS:
            _model_run(f"tp_model/{impl}", params_np, cfg, dist, impl, out)


def _placed_checkpoint(params_np, job, mesh, out):
    """The reduced model's params in the train layout over the mesh and
    laid out under the serving cell's per-layer plan (two shadowed
    experts), saved with the plan and the layout: rank 0 writes the whole
    logical-order tree."""
    from repro_torch import interop
    from repro_torch import placement as TP
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch.sharding import make_layout

    cfg = _model_cfg("ragged")
    plan = _serve_plan(mesh.shape["model"])
    layout = make_layout(cfg, mesh)
    params = interop.from_jax(params_np, cfg, device="cpu", layout=layout)
    TP.from_logical(params, plan, mesh=mesh)
    ckpt.save(str(job / "ckpt_placed"), {"params": params}, step=3,
              placement=plan, layout=layout)
    # every rank restores its shard of it, in the plan's physical order
    from repro_torch.optim.adamw import tree_leaves, tree_map
    back = ckpt.restore(str(job / "ckpt_placed"),
                        {"params": tree_map(torch.zeros_like, params)},
                        placement=plan, layout=layout)["params"]
    out["ckpt/restored_shard_equal"] = np.asarray(all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                          tree_leaves(params))))


def _bit_equal_task(spec, job, mesh, out):
    """At world size 1 the EP path (a2a, the psum mode and, for capacity,
    expert-internal tensor parallelism) must be the local path, bit for
    bit, and psum decode the local decode."""
    from repro_torch.core import fmoe
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    for dispatch in DISPATCHES:
        cfg = _model_cfg(dispatch)
        dists = {"local": None, "ep": train.moe_dist(cfg, mesh, MODEL_B),
                 "psum": fmoe.DistConfig(mesh, ("data",))}
        if dispatch == "capacity":
            dists["tp"] = train.moe_dist(cfg, mesh, MODEL_B, expert_tp=True)
        # the §5.2 schedule at world size 1: no collective (decomposed), or
        # one all-to-all a chunk
        chunked = train.moe_dist(cfg, mesh, MODEL_B, overlap_chunks=2)
        dists["overlap"] = chunked
        dists["overlap_undecomposed"] = chunked._replace(decompose=False)
        batch = {"tokens": torch.from_numpy(_tokens(0))}
        for impl in IMPLS:
            res = {}
            for name, d in dists.items():
                params = lm.init_params(
                    cfg, seed=0, device="cpu", param_dtype=cfg.param_dtype,
                    layout=None if d is None
                    else train.train_dist(cfg, d).layout)
                loss, _, grads = train.loss_and_grads(
                    params, cfg, batch, impl=impl, device="cpu", dist=d)
                opt = AdamW(lr=LR)
                step_fn = train.make_train_step(cfg, opt, dist=d, impl=impl,
                                                device="cpu")
                params, _, m = step_fn(params, opt.init(params), batch, 0)
                res[name] = ([loss] + tree_leaves(grads),
                             [m["grad_norm"]] + tree_leaves(params))
            key = f"bit_equal/{dispatch}/{impl}"
            for name in list(dists)[1:]:
                sub = key if name == "ep" else f"{key}/{name}"
                out[f"{sub}/grads"] = np.asarray(all(
                    torch.equal(a, b) for a, b in zip(res["local"][0],
                                                      res[name][0])))
                out[f"{sub}/loss_equal"] = np.asarray(torch.equal(
                    res["local"][0][0], res[name][0][0]))
                out[f"{sub}/grad_diff"] = np.asarray(max(
                    float((a - b).abs().max()) for a, b in
                    zip(res["local"][0][1:], res[name][0][1:])))
                out[f"{sub}/step"] = np.asarray(all(
                    torch.equal(a, b) for a, b in zip(res["local"][1],
                                                      res[name][1])))
            # serving: psum decode under the serving layout (at 1x1 the
            # identity) against local decode
            params = lm.init_params(cfg, seed=0, device="cpu")
            _, ddist = serve.serve_setup(cfg, mesh, MODEL_B)
            (l0, t0), (l1, t1) = (_decode_greedy(params, cfg, impl, d)
                                  for d in (None, ddist))
            out[f"{key}/psum_decode"] = np.asarray(
                ddist.mode == "psum" and torch.equal(l0, l1)
                and torch.equal(t0, t1))
        _zoo_bit_equal(cfg, mesh, dispatch, out)


def _zoo_bit_equal(cfg, mesh, dispatch, out):
    """Each router of the zoo at world size 1 (fused): the a2a and psum
    train steps' loss and gradients, then the grad norm and params after
    one AdamW step, equal the local step's bit for bit; the local step run
    twice too (the exploration routers draw from the step's seed)."""
    import dataclasses

    from repro_torch.core import fmoe
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    batch = {"tokens": torch.from_numpy(_tokens(0))}
    for router in ZOO:
        rcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router=router))
        dists = {"local": None, "again": None,
                 "ep": train.moe_dist(rcfg, mesh, MODEL_B),
                 "psum": fmoe.DistConfig(mesh, ("data",))}
        res = {}
        for name, d in dists.items():
            params = lm.init_params(rcfg, seed=0, device="cpu",
                                    param_dtype=rcfg.param_dtype,
                                    layout=None if d is None
                                    else train.train_dist(rcfg, d).layout)
            opt = AdamW(lr=LR)
            step_fn = train.make_train_step(rcfg, opt, dist=d, impl="fused",
                                            device="cpu")
            loss, _, grads = train.loss_and_grads(
                params, rcfg, batch, impl="fused", device="cpu", dist=d,
                router_seed=fmoe.expert_seed(17, 0, 0))
            params, _, m = step_fn(params, opt.init(params), batch, 0)
            res[name] = [loss, *tree_leaves(grads), m["grad_norm"],
                         *tree_leaves(params)]
        for name in ("again", "ep", "psum"):
            out[f"zoo_bit_equal/{router}/{dispatch}/{name}"] = np.asarray(
                len(res[name]) == len(res["local"]) and all(
                    torch.equal(a, b) for a, b in zip(res["local"],
                                                      res[name])))


def _decode_greedy(params, cfg, impl, dist, device="cpu"):
    """DECODE_STEPS greedy steps of ``lm.decode_step`` from the first
    token of ``_tokens(0)`` (the rank's data block of its rows under
    ``dist``, the cache in ``dist``'s layout): (logits (steps, B, V), fed
    tokens)."""
    from repro_torch.launch import serve
    from repro_torch.models import lm

    tok = serve.data_rows(torch.from_numpy(_tokens(0)[:, :1]), dist).to(device)
    cache = lm.init_cache(cfg, tok.shape[0], DECODE_CACHE, device=device,
                          layout=None if dist is None else dist.layout)
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
    """psum decode of the reduced model, each rank its shard under the
    serving layout (the train-mode specs)."""
    from repro_torch import interop
    from repro_torch.launch import serve

    params_np = _unflatten(dict(np.load(job / "model_params.npz")))
    for dispatch in DISPATCHES:
        cfg = _model_cfg(dispatch)
        layout, dist = serve.serve_setup(cfg, mesh, MODEL_B)
        assert dist.mode == "psum" and dist.token_axes == ("data",)
        params = interop.from_jax(params_np, cfg, device="cpu", layout=layout)
        logits, toks = _decode_greedy(params, cfg, MODEL_IMPL[dispatch], dist)
        out[f"decode/{dispatch}/logits"] = logits
        out[f"decode/{dispatch}/tokens"] = toks


def _serve_plan(M: int, P=None):
    """The serving cell's per-layer plan for ``M`` model ranks in package
    ``P`` (default ``repro_torch.placement``)."""
    if P is None:
        from repro_torch import placement as P
    E = len(SERVE_PERMS[0])
    return P.per_layer_placement([P.ExpertPlacement(E, M, perm, num_shadow=2)
                                  for perm in SERVE_PERMS])


def _serve_requests(cfg):
    rng = np.random.RandomState(0)
    return [dict(id=i, prompt=rng.randint(0, cfg.vocab_size,
                                          5 + (i % 6)).astype(np.int64),
                 max_new_tokens=4 + (i % 5)) for i in range(8)]


def _batcher_tokens(params, cfg, mesh, switch_at, placed, opts=None):
    """The port's batcher (4 slots, paged) on ``_serve_requests``: under the
    identity per-layer plan from tick 0 where ``placed`` (switched to
    ``_serve_plan`` after tick ``switch_at`` unless None), else unplaced;
    ``opts`` the serving layout's options.  Returns the completions'
    tokens as an (8, 8) array padded with -1."""
    from repro_torch import placement as TP
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve_api import Request, ServeConfig

    M = mesh.shape["model"] if mesh is not None else 2
    plan = (TP.identity_per_layer(cfg.moe.num_experts, M, cfg.num_layers)
            if placed else None)
    b = ContinuousBatcher(params, cfg, ServeConfig(slots=4, max_len=24,
                                                   block_size=8),
                          mesh=mesh, impl="fused", device="cpu",
                          placement=plan, opts=opts)
    for r in _serve_requests(cfg):
        b.submit(Request(arrival=0.0, **r))
    while b.queue or any(s is not None for s in b.slots):
        b.step()
        if b.ticks == switch_at:
            b.apply_placement(_serve_plan(M))
    toks = np.full((8, 8), -1, np.int64)
    for c in b.completions:
        toks[c.request_id, :len(c.tokens)] = c.tokens
    return toks


def _serve_task(spec, job, mesh, out):
    """The continuous batcher under placement, ragged (dropless), its
    params in the serving layout (the train-mode specs): on 1xM the
    identity plan kept, or switched at tick SERVE_SWITCH; on DxM (a batcher
    per data group) unplaced, and switched; and unplaced under
    ``serve_tp``.  Then static decode under the serving layout
    (:func:`_serve_layout_decode`)."""
    from repro_torch import interop
    from repro_torch.launch.sharding import serve_layout

    params_np = _unflatten(dict(np.load(job / "model_params.npz")))
    cfg = _model_cfg("ragged")
    runs = ({"base": (None, True, None), "moved": (SERVE_SWITCH, True, None)}
            if mesh.shape["data"] == 1 else
            {"plain": (None, False, None), "moved": (SERVE_SWITCH, True, None)})
    runs["tp"] = (None, False, SL_OPTS["serve_tp"])
    for key, (switch_at, placed, opts) in runs.items():
        layout = serve_layout(cfg, mesh, 4, opts)
        params = interop.from_jax(params_np, cfg, device="cpu", layout=layout)
        out[f"serve/{key}"] = _batcher_tokens(params, cfg, mesh, switch_at,
                                              placed, opts)
    _serve_layout_decode(job, mesh, out)


def _serve_layout_decode(job, mesh, out):
    """Greedy static decode (DECODE_STEPS steps) of reduced qwen2-72b and
    reduced fastmoe-gpt through ``serve.make_serve_step`` under the train-
    and the serve-mode specs: each rank's logits and tokens (its data
    block's rows), its params' and first cache's shapes."""
    from repro_torch import interop
    from repro_torch.launch import serve
    from repro_torch.launch.sharding import flat_paths
    from repro_torch.models import lm

    for arch in SL_ARCHS:
        cfg = _sl_cfg(arch)
        params_np = _unflatten(dict(np.load(job / SL_PARAMS[arch])))
        for name, opts in SL_OPTS.items():
            step, layout, dist = serve.make_serve_step(
                cfg, mesh, MODEL_B, opts=opts, impl="fused", device="cpu")
            params = interop.from_jax(params_np, cfg, device="cpu",
                                      layout=layout)
            key = f"sl/{arch}/{name}"
            tok = serve.data_rows(torch.from_numpy(_tokens(0)[:, :1]), dist)
            cache = lm.init_cache(cfg, tok.shape[0], DECODE_CACHE,
                                  device="cpu", layout=layout)
            out[f"{key}/cache_k"] = np.asarray(cache[0].k.shape)
            logits_all, toks = [], [tok]
            with torch.no_grad():
                for pos in range(DECODE_STEPS):
                    logits, cache, _ = step(params, tok, pos, cache)
                    tok = torch.argmax(logits[:, -1], -1)[:, None]
                    logits_all.append(logits[:, 0])
                    toks.append(tok)
            out[f"{key}/logits"] = torch.stack(logits_all)
            out[f"{key}/tokens"] = torch.cat(toks, 1)
            for path, t in flat_paths(params):
                out[f"{key}/shape/{path}"] = np.asarray(t.shape)


RANK_TASKS = {"layer": _layer_task, "model": _model_task,
              "bit_equal": _bit_equal_task, "decode": _decode_task,
              "overlap": _overlap_task, "hier": _hier_task, "zoo": _zoo_task,
              "placement": _placement_task, "serve": _serve_task}


def _rank_main(job: Path, rank: int) -> None:
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    torch.set_num_threads(1)
    spec = json.loads((job / "job.json").read_text())
    data, model, node = spec["mesh"]
    world = data * node * model
    init_distributed("cpu", rank=rank, world_size=world,
                     store=tdist.FileStore(str(job / "store"), world),
                     timeout=STORE_TIMEOUT)
    mesh = make_local_mesh(data, model, node)
    out: dict = {}
    for task in spec["tasks"]:
        if task in RANK_TASKS:
            RANK_TASKS[task](spec, job, mesh, out)
    np.savez(job / f"rank{rank}.npz",
             **{k: (v.detach().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in out.items()})
    tdist.barrier()  # no rank tears down a group a peer still receives on
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
    d, e = env.params["router"]["w"].shape
    g = np.random.default_rng(23)
    zoo = {"zoo/w_noise": (g.standard_normal((d, e)) * 0.1 * d ** -0.5),
           "zoo/w_frozen": g.standard_normal((d, e)) * d ** -0.5}
    np.savez(job / "layer.npz", x=np.asarray(env.x), r=np.asarray(r),
             **{k: v.astype(np.float32) for k, v in zoo.items()},
             **_flatten(jax.tree.map(np.asarray, env.params)))
    return env, r


def _zoo_oracle(root: Path):
    """The single-rank oracles of the zoo task, per (router, dispatch,
    token shards): y, load, drop_frac and the gradients of sum(y * r) —
    the port's local layer with the task's seed (noisy_topk, gumbel), JAX's
    single-rank layer (frozen), and JAX's layer on each of 1, 2 or 4 token
    shards (expert_choice)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    import dist_utils as du
    from repro.core import fmoe as jfmoe
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe as tfmoe

    inp = dict(np.load(root / "layer.npz"))
    d = inp["x"].shape[-1]
    x, r = inp["x"].reshape(-1, d), inp["r"].reshape(-1, d)
    params = _unflatten({k: v for k, v in inp.items()
                         if k.startswith(("router/", "experts/"))})
    params["router"].update({k: inp[f"zoo/{k}"]
                             for k in ("w_noise", "w_frozen")})
    env = du.moe_env()
    ref = {}
    for dispatch in DISPATCHES:
        for router in ("noisy_topk", "gumbel"):
            cfg = MoEConfig(dispatch=dispatch, router=router, **LAYER)
            p = {k: {n: torch.from_numpy(np.array(t)).requires_grad_()
                     for n, t in v.items()} for k, v in params.items()}
            xs = torch.from_numpy(x).requires_grad_()
            y, m = tfmoe.fmoe_apply(p, xs, cfg, act="swiglu", impl="fused",
                                    noise_seed=ZOO_SEED)
            leaves = [t for v in p.values() for t in v.values()]
            g = torch.autograd.grad((y * torch.from_numpy(r)).sum(),
                                    leaves + [xs], allow_unused=True,
                                    materialize_grads=True)
            names = [f"{k}/{n}" for k, v in p.items() for n in v]
            ref[(router, dispatch, 1)] = dict(
                y=y.detach().numpy(), load=m.load.numpy(),
                drop_frac=m.drop_frac.numpy(),
                grad={**{k: t.numpy() for k, t in zip(names, g)},
                      "x": g[-1].numpy()})
        jcfg = dataclasses.replace(env.cfg, dispatch=dispatch)
        jp = jax.tree.map(jnp.asarray, params)
        for router, shards in (("frozen", (1,)),
                               ("expert_choice", (1, 2, 4))):
            rc = dataclasses.replace(jcfg, router=router)
            for n in shards:
                def f(p, xx):
                    xs = xx.reshape(n, -1, d)
                    outs = [jfmoe.fmoe_apply(p, xs[i], rc, act="swiglu")
                            for i in range(n)]
                    y = jnp.concatenate([o[0] for o in outs])
                    return (y * r).sum(), (y, outs[0][1])
                (_, (y, m)), (gp, gx) = jax.value_and_grad(
                    f, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
                ref[(router, dispatch, n)] = dict(
                    y=np.asarray(y), load=np.asarray(m.load),
                    drop_frac=np.asarray(m.drop_frac),
                    grad={**_flatten(jax.tree.map(np.asarray, gp)),
                          "x": np.asarray(gx)})
    return ref


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


def model_run(key, cfg, dist, params=params):
    vg = jax.jit(jax.value_and_grad(
        lambda p, t: lm.loss_fn(p, cfg, {{"tokens": t}}, dist=dist,
                                impl="einsum"), has_aux=True))
    with mesh:
        (loss, aux), grads = vg(params, jnp.asarray(T._tokens(0)))
    out[key + "/loss"] = loss
    for k in ("aux_loss", "z_loss", "drop_frac", "load", *T.COUNTERS):
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


parts = {parts!r}
psum = fmoe.DistConfig(mesh, ("data",) if data > 1 else ())
for dispatch in T.DISPATCHES:
    cfg = T._model_cfg(dispatch, "repro")
    if "a2a" in parts:
        model_run("model/" + dispatch, cfg, dist)
    if "psum" in parts:
        model_run("psum_model/" + dispatch, cfg, psum)
        if data == 1:  # the placed psum train step, params in its order
            from repro import placement as JP
            plan = T._serve_plan(model, JP)
            model_run("place_psum_model/" + dispatch, cfg,
                      psum._replace(placement=plan),
                      JP.from_logical(params, plan))
if "psum" in parts and data == 1:  # JAX's placed psum layer (einsum)
    from repro import placement as JP
    plan = T._place_plan(JP, model)
    for dispatch in T.DISPATCHES:
        env = du.moe_env(dispatch=dispatch)
        y, m = du.dist_apply(env, mesh, psum._replace(placement=plan),
                             params=JP.from_logical(env.params, plan))
        key = "place_psum/" + dispatch
        out[key + "/y"], out[key + "/load"] = y, m.load
        out[key + "/drop_frac"] = m.drop_frac
if "tp" in parts:
    tp = dist._replace(tp_axis="data")
    model_run("tp_model", T._model_cfg("capacity", "repro"), tp)
    env = du.moe_env()
    r = jnp.asarray(np.load({layer!r})["r"])

    def f(p, x):
        y, m = fmoe.fmoe_apply(p, x, env.cfg, dist=tp)
        return (y * r).sum(), (y, m)
    with mesh:
        (_, (y, m)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(env.params, env.x)
    out["tp_layer/y"], out["tp_layer/load"] = y, m.load
    out["tp_layer/drop_frac"], out["tp_layer/grad/x"] = m.drop_frac, gx
    for k, v in T._flatten(jax.tree.map(np.asarray, gp)).items():
        out["tp_layer/grad/" + k] = v
if "drops" in parts:
    env = du.moe_env(dispatch="ragged")
    y, m = du.dist_apply(env, mesh, dist._replace(ragged_bound=T.DROP_BOUND),
                         impl="fused")
    out["drops/y"], out["drops/drop_frac"] = y, m.drop_frac
    out["drops/load"] = m.load
if "decode" in parts:
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


# The JAX package's distributed runs per mesh, each tuple one process (so
# that they run concurrently): the a2a model, the psum model, the tp model
# and layer, forced drops, psum decode
JAX_PARTS = {"1x2": (("a2a", "decode"), ("psum",)),
             "2x2": (("a2a", "drops"), ("psum",), ("tp",))}


def _jax_dist(job: Path, name: str, parts: tuple, box: dict):
    """One process of the JAX package's distributed runs of one mesh, on
    fake devices."""
    import dist_utils as du
    dest = job / f"jax_{name}_{'_'.join(parts)}.npz"
    try:
        du.run(JAX_DIST.format(tests=str(ROOT / "tests"), mesh=MESHES[name],
                               params=str(job / "model_params.npz"),
                               layer=str(job / "layer.npz"), parts=parts,
                               dest=str(dest)),
               devices=4, timeout=SPAWN_TIMEOUT)
        box[(name, parts)] = dict(np.load(dest))
    except Exception as e:  # reported by the tests that read it
        box[(name, parts)] = e


JAX_HIER = """
import sys
import numpy as np, jax
sys.path.insert(0, {tests!r})
import dist_utils as du
import test_torch_ep as T
from repro.core import fmoe
env = du.moe_env(dispatch="ragged")
mesh = du.make_mesh(1, 2, node=2)  # (data, node, model) = (1, 2, 2)
hier = fmoe.DistConfig(mesh, ("data", "node", "model"),
                       expert_axis=("node", "model"), node_axis="node")
out = {{}}
# chunked, so that every leg is a ppermute (XLA:CPU has no ragged
# all-to-all for the serial inter leg)
for key, oc, ib in (("tight", 4, T.HIER_IB), ("drops", 2, T.HIER_DROP_IB)):
    y, m = du.dist_apply(env, mesh, hier._replace(overlap_chunks=oc,
                                                  inter_bound=ib))
    out["hier_" + key + "/y"], out["hier_" + key + "/drop_frac"] = y, m.drop_frac
    for k, v in m.obs.as_dict().items():
        out["hier_" + key + "/obs/" + k] = v
# the comm helpers, each rank its block (rank = node * 2 + model)
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core import comm
spec = P(("data", "node", "model"))
for key, fn in (("hierarchical",
                 lambda b: comm.hierarchical_all_to_all(b, "model", "node")),
                ("bf16", lambda b: comm.all_to_all_bf16(
                    b.reshape(4, -1), ("node", "model")).reshape(b.shape))):
    f = compat.shard_map(lambda b, fn=fn: fn(b[0])[None], mesh=mesh,
                         in_specs=spec, out_specs=spec)
    with mesh:
        out["comm/" + key] = jax.jit(f)(T._comm_input())
EXP = ("node", "model")


def fig2(b):
    b = b[0]
    tokens = jnp.broadcast_to(b.reshape(4, 1, 3), (4, 2, 3))
    counts = jnp.round(b.reshape(-1)[:8] * 10).astype(jnp.int32)
    sent = comm.exchange_tokens(tokens, EXP)
    return (comm.exchange_counts(counts, EXP)[None], sent[None],
            comm.return_tokens(sent, EXP)[None])


import jax.numpy as jnp
f = compat.shard_map(fig2, mesh=mesh, in_specs=spec,
                     out_specs=(spec, spec, spec))
with mesh:
    out["comm/counts"], out["comm/tokens"], out["comm/returned"] = (
        jax.jit(f)(T._comm_input()))
np.savez({dest!r}, **{{k: np.asarray(v) for k, v in out.items()}})
print("jax hier ok")
"""


def _jax_hier(root: Path, box: dict):
    """The JAX package's two-level layer on a 1x2x2 mesh of fake devices
    (einsum experts, the ragged dispatch), where every leg is a ppermute:
    HIER_IB at 4 chunks, HIER_DROP_IB at 2."""
    import dist_utils as du
    dest = root / "jax_hier.npz"
    try:
        du.run(JAX_HIER.format(tests=str(ROOT / "tests"), dest=str(dest)),
               devices=4, timeout=SPAWN_TIMEOUT)
        box["hier"] = dict(np.load(dest))
    except Exception as e:  # reported by the tests that read it
        box["hier"] = e


JAX_SERVE = """
import sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
import test_torch_ep as T
from repro import placement as JP
from repro.launch.scheduler import ContinuousBatcher
from repro.launch.serve_api import Request, ServeConfig
cfg = T._model_cfg("ragged", "repro")
params = jax.tree.map(jnp.asarray, T._unflatten(dict(np.load({params!r}))))
out = {{}}
TP = T.SL_OPTS["serve_tp"]
for key, mesh, switch_at, placed, opts in (
        ("1x2/base", "1x2", None, True, None),
        ("1x2/moved", "1x2", T.SERVE_SWITCH, True, None),
        ("2x2/plain", "2x2", None, False, None),
        ("2x2/moved", "2x2", T.SERVE_SWITCH, True, None),
        ("1x2/tp", "1x2", None, False, TP), ("2x2/tp", "2x2", None, False, TP)):
    plan = (JP.identity_per_layer(cfg.moe.num_experts, 2, cfg.num_layers)
            if placed else None)
    b = ContinuousBatcher(params, cfg, ServeConfig(
        slots=4, max_len=24, block_size=8, mesh=mesh), placement=plan,
        opts=opts)
    for r in T._serve_requests(cfg):
        b.submit(Request(arrival=0.0, **{{**r, "prompt": r["prompt"].astype(
            np.int32)}}))
    while b.queue or any(s is not None for s in b.slots):
        b.step()
        if b.ticks == switch_at:
            b.apply_placement(T._serve_plan(2, JP))
    toks = np.full((8, 8), -1, np.int64)
    for c in b.completions:
        toks[c.request_id, :len(c.tokens)] = c.tokens
    out["serve/" + key] = toks
# static decode under the serving layouts: jit_serve_step's shardings
from repro.launch.mesh import make_local_mesh
from repro.launch.serve import jit_serve_step
from repro.models import lm
for arch in T.SL_ARCHS:
    jcfg = T._sl_cfg(arch, "repro")
    jp = jax.tree.map(jnp.asarray, T._unflatten(dict(np.load(
        {root!r} + "/" + T.SL_PARAMS[arch]))))
    for name, (d, m) in (("1x2", (1, 2)), ("2x2", (2, 2))):
        mesh = make_local_mesh(d, m)
        for oname, opts in T.SL_OPTS.items():
            fn, _ = jit_serve_step(jcfg, mesh, T.MODEL_B, T.DECODE_CACHE,
                                   opts=opts)
            cache = lm.init_cache(jcfg, T.MODEL_B, T.DECODE_CACHE)
            tok = jnp.asarray(T._tokens(0)[:, :1])
            logits_all, toks = [], [tok]
            with mesh:
                for pos in range(T.DECODE_STEPS):
                    logits, cache, _ = fn(jp, tok, jnp.int32(pos), cache)
                    tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(
                        jnp.int32)
                    logits_all.append(logits[:, 0])
                    toks.append(tok)
            key = "sl/" + name + "/" + arch + "/" + oname
            out[key + "/logits"] = np.asarray(jnp.stack(logits_all))
            out[key + "/tokens"] = np.asarray(jnp.concatenate(toks, 1))
np.savez({dest!r}, **out)
print("jax serve ok")
"""


def _jax_serve(root: Path, box: dict):
    """The JAX package's continuous batcher on the serving cell (the
    reference's mid-stream replan test at 1x2, and a 2x2 mesh unplaced
    and switched) on fake devices."""
    import dist_utils as du
    dest = root / "jax_serve.npz"
    try:
        du.run(JAX_SERVE.format(tests=str(ROOT / "tests"),
                                params=str(root / "model_params.npz"),
                                root=str(root), dest=str(dest)),
               devices=4, timeout=SPAWN_TIMEOUT)
        box["serve"] = dict(np.load(dest))
    except Exception as e:  # reported by the tests that read it
        box["serve"] = e


@pytest.fixture(scope="module")
def ep(tmp_path_factory):
    """Runs every spawn and the JAX counterparts once, concurrently."""
    jax = pytest.importorskip("jax")
    from repro.models import lm as jlm

    root = tmp_path_factory.mktemp("ep")
    jcfg = _model_cfg("capacity", "repro")
    np.savez(root / "model_params.npz", **_flatten(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))))
    np.savez(root / "dense_params.npz", **_flatten(jax.tree.map(
        np.asarray, jlm.init_params(jax.random.PRNGKey(1), _dense_cfg(
            "repro")))))
    env, r = _jax_layer_inputs(root)
    waits = {}
    shapes = {**{n: (d, m, 1) for n, (d, m) in MESHES.items()},
              **{n: (d, m, k) for n, (d, k, m) in NODE_MESHES.items()}}
    for name, (data, model, node) in shapes.items():
        job = root / name
        job.mkdir()
        for f in ("layer.npz", "model_params.npz", "dense_params.npz"):
            (job / f).symlink_to(root / f)
        (job / "job.json").write_text(json.dumps(
            {"mesh": [data, model, node], "tasks": TASKS[name]}))
        waits[name] = (job, _spawn(job, data * model * node))
    jax_box: dict = {}
    threads = [threading.Thread(target=_jax_dist,
                                args=(root / n, n, parts, jax_box))
               for n, jobs in JAX_PARTS.items() for parts in jobs]
    threads.append(threading.Thread(target=_jax_hier, args=(root, jax_box)))
    threads.append(threading.Thread(target=_jax_serve, args=(root, jax_box)))
    for th in threads:
        th.start()
    oracle = _jax_layer_oracle(env, r)
    zoo = _zoo_oracle(root)
    runs = {}
    for name, (job, wait) in waits.items():
        ok, log = wait()
        world = int(np.prod(shapes[name]))
        runs[name] = dict(ok=ok, log=log, ranks=[
            dict(np.load(job / f"rank{i}.npz")) if ok else None
            for i in range(world)])
    for th in threads:
        th.join(SPAWN_TIMEOUT)
    return dict(runs=runs, jax=jax_box, oracle=oracle, zoo=zoo, root=root)


def _ranks(ep, name):
    run = ep["runs"][name]
    assert run["ok"], run["log"]
    return run["ranks"]


def _jax_dist_result(ep, name):
    res = {}
    for parts in JAX_PARTS[name]:
        part = ep["jax"].get((name, parts))
        assert isinstance(part, dict), (parts, part)
        res.update(part)
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


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_psum_layer_grads_match_jax(ep, name):
    """The psum mode's gradients of sum(y * r) against jax.grad of the
    single-rank layer, at 1e-5 of each leaf's largest magnitude.  The M
    ranks of a model group share one objective (their data block's), and
    the all-reduce's backward hands each M times its part: so the synced
    router and expert gradients are the whole objective's divided by the
    D data blocks, and a block's input gradient is its model group's sum
    divided by M."""
    ranks = _ranks(ep, name)
    data, model = MESHES[name]
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"psum/{dispatch}/{impl}"
            ref = ep["oracle"][f"{dispatch}/{impl}"]["grad"]
            xg = np.concatenate([
                sum(ranks[d * model + m][f"{key}/grad/x"]
                    for m in range(model)) / model for d in range(data)])
            _close_to_scale(xg, ref["x"].reshape(xg.shape), 1e-5, f"{key} x")
            for rank, r in enumerate(ranks):
                _close_to_scale(data * r[f"{key}/grad/router/w"],
                                ref["router/w"], 1e-5, f"{key} router")
                for leaf in ("wi_gate", "wi_up", "wo"):
                    want = _expert_slice(ref[f"experts/{leaf}"], leaf, rank,
                                         MESHES[name])
                    _close_to_scale(data * r[f"{key}/grad/experts/{leaf}"],
                                    want, 1e-5, f"{key} rank {rank} {leaf}")


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


def _expert_slice(want, path, rank, mesh, tp=False):
    """The rank's shard of a whole expert leaf: its experts, and under
    ``tp`` its hidden slice (``wi*`` the last dim, ``wo`` the one before
    it)."""
    data, model = mesh
    d, m = divmod(rank, model)
    e = want.shape[0] // model
    want = want[m * e:(m + 1) * e]
    if tp:
        dim = want.ndim - (2 if path.endswith("wo") else 1)
        h = want.shape[dim] // data
        want = np.take(want, np.arange(d * h, (d + 1) * h), axis=dim)
    return want


_TRAIN_LAYOUTS: dict = {}


def _train_layout(name):
    """(the reduced model's train layout, its shape-only mesh) on mesh
    ``name``: what every rank's params and gradients are shards of."""
    if name not in _TRAIN_LAYOUTS:
        from repro_torch.launch.sharding import ShapeMesh, make_layout
        data, model = MESHES[name]
        mesh = ShapeMesh.of(data=data, model=model)
        _TRAIN_LAYOUTS[name] = (make_layout(_model_cfg("capacity"), mesh),
                                mesh)
    return _TRAIN_LAYOUTS[name]


def _stacked_spec(layout, path):
    """The spec of a JAX-tree path (``layers/...`` stacked on L)."""
    parts = path.split("/")
    if parts[0] != "layers":
        return layout.spec(path)
    return (None, *layout.spec("/".join(["layers", "0", *parts[1:]])))


def _rank_shard(want, path, rank, name):
    """The rank's block of a whole JAX-tree leaf under the train layout."""
    from repro_torch.launch.sharding import shard_leaf
    layout, mesh = _train_layout(name)
    return shard_leaf(torch.from_numpy(np.asarray(want)),
                      _stacked_spec(layout, path), mesh, rank).numpy()


def _assert_blocks_synced(grads, name, key):
    """After sync_grads each gradient leaf is bit-identical on the ranks
    that hold the same block of it under the train layout (it is
    replicated over the rest of the mesh), and an expert leaf differs
    between blocks."""
    from repro_torch.launch.sharding import entry_index, sharded_dims
    layout, mesh = _train_layout(name)
    for path in grads[0]:
        spec = _stacked_spec(layout, path)
        blocks = [tuple(entry_index(e, mesh, r) for _, e in
                        sharded_dims(spec)) for r in range(len(grads))]
        for rank, g in enumerate(grads):
            first = blocks.index(blocks[rank])
            if first < rank:
                np.testing.assert_array_equal(g[path], grads[first][path],
                                              f"{key} {path}")
            elif rank and "/experts/" in path:
                assert not np.allclose(g[path], grads[0][path]), (key, path)


def _assert_model(name, ranks, ref, key, ref_key=None):
    """Every rank's step-0 loss, aux and z loss, drop fraction, load, every
    synced gradient leaf (held to the rank's block of the whole under the
    train layout), and the losses of two AdamW steps against the JAX
    package's."""
    ref_key = ref_key or key
    for rank, r in enumerate(ranks):
        for k in ("loss", "aux_loss", "z_loss", "drop_frac", "losses"):
            np.testing.assert_allclose(r[f"{key}/{k}"], ref[f"{ref_key}/{k}"],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r[f"{key}/load"], ref[f"{ref_key}/load"],
                                   atol=1e-6)
        grads = _sub(r, f"{key}/grad")
        jgrads = _sub(ref, f"{ref_key}/grad")
        assert grads.keys() == jgrads.keys()
        for path, g in grads.items():
            want = _rank_shard(jgrads[path], path, rank, name)
            _close_to_scale(g, want, 1e-4, f"{name} {key} rank {rank} {path}")


@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_model_matches_jax_distributed(ep, name, dispatch):
    """Reduced fastmoe-gpt with remat: step-0 loss, aux and z loss, drop
    fraction, load, every synced gradient leaf (expert leaves held to
    their slice), and the losses of two AdamW steps."""
    _assert_model(name, _ranks(ep, name), _jax_dist_result(ep, name),
                  f"model/{dispatch}")


@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_psum_model_matches_jax_distributed(ep, name, dispatch):
    """Training through the psum mode: reduced fastmoe-gpt with remat over
    token_axes () on 1x2 (every rank holds every row) and ("data",) on
    2x2 (a model group shares its data row's block), against the JAX
    package's distributed loss_fn under the same DistConfig, as the
    a2a case."""
    _assert_model(name, _ranks(ep, name), _jax_dist_result(ep, name),
                  f"psum_model/{dispatch}")


@pytest.mark.parametrize("impl", IMPLS)
def test_tp_model_matches_jax_distributed(ep, impl):
    """Expert-internal tensor parallelism (capacity, 2x2, tp_axis "data"):
    each rank holds half of its experts' hidden units; the model against
    the JAX package's distributed loss_fn with the same tp_axis (its
    einsum experts)."""
    _assert_model("2x2", _ranks(ep, "2x2"), _jax_dist_result(ep, "2x2"),
                  f"tp_model/{impl}", "tp_model")


@pytest.mark.parametrize("impl", IMPLS)
def test_tp_layer_matches_jax(ep, impl):
    """The tp layer (capacity, 2x2) against the JAX package's layer with
    tp_axis="data" (einsum): y, load and drop fraction at 1e-5, and the
    gradients of sum(y * r) (the input rows; the router after sync_grads;
    each rank's hidden slice of its experts) times the world size, at 1e-5
    of each leaf's largest magnitude."""
    ranks = _ranks(ep, "2x2")
    ref = _sub(_jax_dist_result(ep, "2x2"), "tp_layer")
    key = f"tp_layer/capacity/{impl}"
    world = len(ranks)
    y = np.concatenate([r[f"{key}/y"] for r in ranks])
    np.testing.assert_allclose(y, ref["y"].reshape(y.shape), rtol=1e-5,
                               atol=1e-5)
    xg = np.concatenate([r[f"{key}/grad/x"] for r in ranks])
    _close_to_scale(xg, ref["grad/x"].reshape(xg.shape), 1e-5, "x")
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"{key}/load"], ref["load"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r[f"{key}/drop_frac"], ref["drop_frac"],
                                   atol=1e-6)
        _close_to_scale(world * r[f"{key}/grad/router/w"],
                        ref["grad/router/w"], 1e-5, f"rank {rank} router")
        for leaf in ("wi_gate", "wi_up", "wo"):
            want = _expert_slice(ref[f"grad/experts/{leaf}"], leaf, rank,
                                 MESHES["2x2"], tp=True)
            got = r[f"{key}/grad/experts/{leaf}"]
            assert got.shape == want.shape, (leaf, got.shape, want.shape)
            _close_to_scale(world * got, want, 1e-5, f"rank {rank} {leaf}")


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_sync_semantics_and_grad_norm(ep, name):
    """After sync_grads under the train layout: every leaf identical on
    the ranks holding the same block of it, expert leaves different
    between blocks; the global grad norm equals JAX's."""
    ranks = _ranks(ep, name)
    ref = _jax_dist_result(ep, name)
    for dispatch in DISPATCHES:
        key = f"model/{dispatch}"
        _assert_blocks_synced([_sub(r, f"{key}/grad") for r in ranks], name,
                              key)
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/grad_norm"],
                                       ref[f"{key}/grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_psum_sync_semantics_and_grad_norm(ep, name):
    """The psum mode after sync_grads under the train layout: every leaf
    identical on the ranks holding the same block of it, expert leaves
    different between blocks; the global grad norm equals JAX's."""
    ranks = _ranks(ep, name)
    ref = _jax_dist_result(ep, name)
    for dispatch in DISPATCHES:
        key = f"psum_model/{dispatch}"
        _assert_blocks_synced([_sub(r, f"{key}/grad") for r in ranks], name,
                              key)
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/grad_norm"],
                                       ref[f"{key}/grad_norm"], rtol=1e-5)


def test_tp_sync_semantics_and_grad_norm(ep):
    """Under expert-internal tensor parallelism (2x2) sync_grads leaves a
    tp expert leaf unreduced: it differs across data ranks (each holds
    another hidden slice) and across model ranks, while every other leaf
    is identical on the ranks holding the same block of it; the grad norm,
    summed over every rank's shard, is the whole gradient's (JAX's)."""
    ranks = _ranks(ep, "2x2")
    ref = _jax_dist_result(ep, "2x2")
    for impl in IMPLS:
        key = f"tp_model/{impl}"
        _assert_blocks_synced([_sub(r, f"{key}/grad") for r in ranks], "2x2",
                              key)
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/grad_norm"],
                                       ref["tp_model/grad_norm"], rtol=1e-5)


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_world_size_1_psum_train_is_local_bit_for_bit(ep, dispatch, impl):
    """At world size 1 the psum mode's train step is the local one: step-0
    loss and gradients, the grad norm and the params after one step."""
    r = _ranks(ep, "1x1")[0]
    assert bool(r[f"bit_equal/{dispatch}/{impl}/psum/grads"]), "loss or a grad"
    assert bool(r[f"bit_equal/{dispatch}/{impl}/psum/step"]), "norm or params"


@pytest.mark.parametrize("impl", IMPLS)
def test_world_size_1_tp_train_is_local_bit_for_bit(ep, impl):
    """At world size 1 the tp train step (capacity) is the local one: its
    all-gather and reduce-scatter are copies."""
    r = _ranks(ep, "1x1")[0]
    assert bool(r[f"bit_equal/capacity/{impl}/tp/grads"]), "loss or a grad"
    assert bool(r[f"bit_equal/capacity/{impl}/tp/step"]), "norm or params"


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


def _grads(r, key):
    return _sub(r, f"{key}/grad")


def _assert_same_run(r, key, ref_key, grad_atol=None):
    """``key``'s y, load and drop fraction equal ``ref_key``'s bit for bit;
    its gradients too, or within ``grad_atol``."""
    for k in ("y", "load", "drop_frac"):
        np.testing.assert_array_equal(r[f"{key}/{k}"], r[f"{ref_key}/{k}"],
                                      f"{key} {k}")
    got, want = _grads(r, key), _grads(r, ref_key)
    assert got.keys() == want.keys() and got
    for path, g in got.items():
        if grad_atol is None:
            np.testing.assert_array_equal(g, want[path], f"{key} {path}")
        else:
            np.testing.assert_allclose(g, want[path], rtol=0, atol=grad_atol,
                                       err_msg=f"{key} {path}")


@pytest.mark.parametrize("chunks", OVERLAP_CHUNKS)
@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_overlap_layer_equals_serial(ep, name, chunks):
    """The §5.2 schedule at each depth, for {capacity, ragged} x {einsum,
    pallas, fused} (plain versions on the CPU): y, load and drop fraction
    equal the serial exchange's bit for bit, and the gradients of sum(y *
    r) are within CHUNK_GRAD_ATOL (each chunk's dW adds in chunk order); y
    against JAX's single-rank layer at 1e-5."""
    ranks = _ranks(ep, name)
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"{dispatch}/{impl}"
            for r in ranks:
                _assert_same_run(r, f"overlap{chunks}/{key}", f"layer/{key}",
                                 CHUNK_GRAD_ATOL)
            y = np.concatenate([r[f"overlap{chunks}/{key}/y"] for r in ranks])
            ref = ep["oracle"][key]["y"]
            np.testing.assert_allclose(y, ref.reshape(y.shape), rtol=1e-5,
                                       atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_undecomposed_chunks_equal_the_shifts(ep, name):
    """At 4 chunks the exchange as one all-to-all a chunk (``decompose=
    False``) equals the point-to-point shifts bit for bit, forward and
    gradients."""
    for r in _ranks(ep, name):
        for dispatch in DISPATCHES:
            for impl in IMPLS:
                key = f"{dispatch}/{impl}"
                _assert_same_run(r, f"overlap4_undecomposed/{key}",
                                 f"overlap4/{key}")


@pytest.mark.parametrize("name", ["1x2", "2x2"])
def test_bf16_wire_is_near_f32_and_not_equal(ep, name):
    """The bf16 wire rounds the f32 payloads each way: y within WIRE_ATOL
    of the f32 wire's, and not equal to it."""
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"{dispatch}/{impl}"
            got = np.concatenate([r[f"wire/{key}/y"] for r in _ranks(ep, name)])
            want = np.concatenate([r[f"layer/{key}/y"]
                                   for r in _ranks(ep, name)])
            diff = float(np.abs(got - want).max())
            assert 0 < diff < WIRE_ATOL, (key, diff)


@pytest.mark.parametrize("what", list(FORMER_REFUSALS))
def test_formerly_refused_options_run(ep, what):
    """overlap_chunks, wire_dtype, node_axis and inter_bound run (ragged,
    fused, 1x2): the first equals the serial exchange bit for bit in the
    forward, the wire within WIRE_ATOL; on a mesh without a node axis the
    last two keep the flat exchange, bit for bit."""
    for r in _ranks(ep, "1x2"):
        key, ref = f"former/{what}", "layer/ragged/fused"
        if what == "wire_dtype":
            diff = float(np.abs(r[f"{key}/y"] - r[f"{ref}/y"]).max())
            assert 0 < diff < WIRE_ATOL, diff
        else:
            _assert_same_run(r, key, ref, None if what != "overlap_chunks"
                             else CHUNK_GRAD_ATOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_overlap_tp_layer_equals_serial(ep, impl):
    """Chunks under expert-internal tensor parallelism (capacity, 2x2): the
    rows of each chunk all-gathered over data and scattered back; equal to
    the serial tp layer, gradients within CHUNK_GRAD_ATOL."""
    for r in _ranks(ep, "2x2"):
        _assert_same_run(r, f"tp_overlap/capacity/{impl}",
                         f"tp_layer/capacity/{impl}", CHUNK_GRAD_ATOL)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_overlap_model_matches_jax_distributed(ep, dispatch):
    """Reduced fastmoe-gpt with remat at 2 chunks (2x2): the step-0 loss
    equals the serial exchange's bit for bit, and everything against the
    JAX package's serial distributed loss_fn as the serial case (1e-4)."""
    ranks = _ranks(ep, "2x2")
    _assert_model("2x2", ranks, _jax_dist_result(ep, "2x2"),
                  f"overlap_model/{dispatch}", f"model/{dispatch}")
    for r in ranks:
        np.testing.assert_array_equal(r[f"overlap_model/{dispatch}/loss"],
                                      r[f"model/{dispatch}/loss"])


@pytest.mark.parametrize("dispatch", DISPATCHES)
@pytest.mark.parametrize("impl", IMPLS)
def test_world_size_1_overlap_train_matches_local(ep, dispatch, impl):
    """At world size 1, 2 chunks (no collective: the shifts of one rank are
    a copy; or one all-to-all a chunk): the step-0 loss equals the local
    path's bit for bit, the gradients within CHUNK_GRAD_ATOL."""
    r = _ranks(ep, "1x1")[0]
    for name in ("overlap", "overlap_undecomposed"):
        key = f"bit_equal/{dispatch}/{impl}/{name}"
        assert bool(r[f"{key}/loss_equal"]), name
        assert float(r[f"{key}/grad_diff"]) <= CHUNK_GRAD_ATOL, name


def _hier_ranks(ep):
    return _ranks(ep, "1x2x2")


@pytest.mark.parametrize("ib", [0, HIER_IB])
@pytest.mark.parametrize("oc", [0, 4])
@pytest.mark.parametrize("impl", IMPLS)
def test_hier_equals_flat_bit_for_bit(ep, impl, oc, ib):
    """The two-level exchange on 1x2x2 (2 nodes x 2 inner ranks) equals
    the flat exchange over (node, model) bit for bit, forward and
    gradients, serial and at 4 chunks (pallas and fused: the expert
    compute per received chunk, its backward the serial leg's), with the
    slim shards at n_inner * bound and at the tightest bound that drops
    nothing; y against JAX's single-rank layer at 1e-5."""
    ranks = _hier_ranks(ep)
    for r in ranks:
        _assert_same_run(r, f"hier/{oc}/{ib}/{impl}", f"flat/{oc}/{impl}")
        assert float(r[f"hier/{oc}/{ib}/{impl}/drop_frac"]) == 0.0
        if oc:  # the flat exchange in chunks: serial's forward, grads near
            _assert_same_run(r, f"flat/{oc}/{impl}", f"flat/0/{impl}",
                             CHUNK_GRAD_ATOL)
    y = np.concatenate([r[f"hier/{oc}/{ib}/{impl}/y"] for r in ranks])
    ref = ep["oracle"][f"ragged/{impl}"]["y"]
    np.testing.assert_allclose(y, ref.reshape(y.shape), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_hier_grads_and_node_capacity_match_jax(ep, impl):
    """On 1x2x2, rank n * 2 + m holds expert block n * 2 + m: the
    two-level layer's gradients of sum(y * r) and the capacity dispatch
    (a flat exchange over (node, model)) against jax.grad of the
    single-rank layer at 1e-5 of each leaf's largest magnitude."""
    ranks = _hier_ranks(ep)
    world = len(ranks)
    for dispatch, key in (("ragged", f"hier/4/{HIER_IB}/{impl}"),
                          ("capacity", f"hier_capacity/{impl}")):
        ref = ep["oracle"][f"{dispatch}/{impl}"]
        y = np.concatenate([r[f"{key}/y"] for r in ranks])
        np.testing.assert_allclose(y, ref["y"].reshape(y.shape), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        xg = np.concatenate([r[f"{key}/grad/x"] for r in ranks])
        _close_to_scale(xg, ref["grad"]["x"].reshape(xg.shape), 1e-5, key)
        for rank, r in enumerate(ranks):
            _close_to_scale(world * r[f"{key}/grad/router/w"],
                            ref["grad"]["router/w"], 1e-5, f"{key} router")
            for leaf in ("wi_gate", "wi_up", "wo"):
                want = _expert_slice(ref["grad"][f"experts/{leaf}"], leaf,
                                     rank, (1, world))
                _close_to_scale(world * r[f"{key}/grad/experts/{leaf}"],
                                want, 1e-5, f"{key} rank {rank} {leaf}")


def test_hier_matches_jax_two_level_and_its_drops(ep):
    """Against the JAX package's two-level layer on the same 1x2x2 mesh
    where it runs here (chunked: every leg a ppermute): at HIER_IB and 4
    chunks y at 1e-5 and nothing dropped; at HIER_DROP_IB and 2 chunks the
    forwarding agents drop the same rows (drop fraction equal) and y
    agrees at 1e-5."""
    ranks = _hier_ranks(ep)
    ref = ep["jax"].get("hier")
    assert isinstance(ref, dict), ref
    y = np.concatenate([r[f"hier/4/{HIER_IB}/einsum/y"] for r in ranks])
    np.testing.assert_allclose(y, ref["hier_tight/y"].reshape(y.shape),
                               rtol=1e-5, atol=1e-5)
    assert float(ref["hier_tight/drop_frac"]) == 0.0
    y = np.concatenate([r["hier_drops/y"] for r in ranks])
    np.testing.assert_allclose(y, ref["hier_drops/y"].reshape(y.shape),
                               rtol=1e-5, atol=1e-5)
    for r in ranks:
        drop = float(r["hier_drops/drop_frac"])
        assert drop > 0.05, drop  # the inter bound really drops rows
        np.testing.assert_allclose(drop, float(ref["hier_drops/drop_frac"]),
                                   rtol=1e-6)


def _assert_counters(got, ref, msg):
    """Telemetry counters against the JAX package's: the wire sizes are
    host constants (equal to f32 rounding), the rest reduced values."""
    for k in COUNTERS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=f"{msg} {k}")


@pytest.mark.parametrize("name", ["1x2", "2x2"])
@pytest.mark.parametrize("mode", ["model", "psum_model"])
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_model_counters_match_jax_distributed(ep, name, mode, dispatch):
    """The telemetry counters in the reduced model's loss aux (summed over
    the layers, imbalance averaged), a2a and the psum mode, against the
    JAX package's distributed loss_fn on the same mesh: wire elements and
    bytes (a flat exchange: all inter), dropped rows, shadow hits and
    imbalance."""
    ref = _jax_dist_result(ep, name)
    key = f"{mode}/{dispatch}"
    for rank, r in enumerate(_ranks(ep, name)):
        got = {k: r[f"{key}/{k}"] for k in COUNTERS}
        _assert_counters(got, {k: ref[f"{key}/{k}"] for k in COUNTERS},
                         f"{name} {key} rank {rank}")
        assert float(got["wire_bytes"]) > 0.0
        assert float(got["wire_bytes_intra"]) == 0.0


@pytest.mark.parametrize("case", ["tight", "drops"])
def test_hier_counters_match_jax(ep, case):
    """The two-level exchange's counters (its intra- and inter-node wire
    bytes apart, the agents' drops) against the JAX package's two-level
    layer on the same 1x2x2 mesh: HIER_IB at 4 chunks, HIER_DROP_IB at 2."""
    ref = ep["jax"].get("hier")
    assert isinstance(ref, dict), ref
    key = f"hier/4/{HIER_IB}/einsum" if case == "tight" else "hier_drops"
    want = {k: ref[f"hier_{case}/obs/{k}"] for k in COUNTERS}
    for rank, r in enumerate(_hier_ranks(ep)):
        got = {k: r[f"{key}/obs/{k}"] for k in COUNTERS}
        _assert_counters(got, want, f"{case} rank {rank}")
        assert float(got["wire_bytes_intra"]) > 0.0
        np.testing.assert_allclose(
            float(got["wire_bytes"]),
            float(got["wire_bytes_intra"]) + float(got["wire_bytes_inter"]),
            rtol=1e-6)
    assert (float(want["dropped"]) > 0.0) == (case == "drops")


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
def test_counters_add_no_collective(ep, name):
    """The collective tally (core.comm: calls and output bytes by op) of a
    layer's forward and backward is the same with the telemetry counters
    on and off (DistConfig.obs), for the capacity exchange, its chunked
    bf16 wire, the ragged exchange and the psum mode; off, the counters
    are zero, and on, the wire bytes are the exchange's."""
    for rank, r in enumerate(_ranks(ep, name)):
        for case in TALLY_CASES:
            on, off = f"tally/{case}/True", f"tally/{case}/False"
            for what in ("calls", "bytes"):
                np.testing.assert_array_equal(
                    r[f"{on}/{what}"], r[f"{off}/{what}"],
                    err_msg=f"{name} rank {rank} {case} {what}")
            assert r[f"{on}/calls"].sum() > 0
            assert float(r[f"{off}/obs/wire_bytes"]) == 0.0
            assert float(r[f"{on}/obs/wire_bytes"]) > 0.0
            np.testing.assert_array_equal(r[f"{on}/y"], r[f"{off}/y"])


@pytest.mark.parametrize("fn", ["hierarchical", "bf16", "counts", "tokens",
                                "returned"])
def test_comm_helpers_match_jax(ep, fn):
    """``comm.hierarchical_all_to_all`` (the node-local hop over dim 1,
    then the aggregated one over dim 0 across nodes),
    ``comm.all_to_all_bf16`` and Fig 2's ``exchange_counts``,
    ``exchange_tokens`` and ``return_tokens`` over (node, model) on 1x2x2
    equal the JAX package's under shard_map on the same mesh, rank by
    rank, bit for bit; the returned tokens are the sent ones."""
    ref = ep["jax"].get("hier")
    assert isinstance(ref, dict), ref
    got = np.stack([r[f"comm/{fn}"] for r in _hier_ranks(ep)])
    np.testing.assert_array_equal(got, ref[f"comm/{fn}"])
    if fn == "bf16":  # rank r's slice s is rank s's slice r, rounded
        f32 = _comm_input().reshape(4, 4, 3).transpose(1, 0, 2)
        got = got.reshape(f32.shape)
        assert not np.array_equal(got, f32)
        np.testing.assert_allclose(got, f32, rtol=2 ** -8, atol=0)
    if fn == "returned":
        sent = np.broadcast_to(_comm_input().reshape(4, 4, 1, 3), got.shape)
        np.testing.assert_array_equal(got, sent)


def test_hier_bf16_wire_equals_flat_bf16_wire(ep):
    """Both levels cast at the same points: the two-level exchange with the
    bf16 wire (at HIER_IB) equals the flat exchange's bf16 wire bit for
    bit, and sits within WIRE_ATOL of the f32 wire, not equal to it."""
    for r in _hier_ranks(ep):
        _assert_same_run(r, "hier_wire", "flat_wire")
        diff = float(np.abs(r["hier_wire/y"] - r["flat/0/fused/y"]).max())
        assert 0 < diff < WIRE_ATOL, diff


# ---------------------------------------------------------------------------
# Expert placement across ranks
# ---------------------------------------------------------------------------


PLACE_MESHES = ["1x2", "1x4", "1x2x2"]


def _mesh_shape(name):
    if name in NODE_MESHES:
        d, n, m = NODE_MESHES[name]
        return d, n * m
    return MESHES[name]


def _physical(tree_logical: dict, plan) -> dict:
    """Whole logical gradient leaves in ``plan``'s physical order."""
    from repro_torch import placement as TP
    t = {k: torch.from_numpy(np.array(v)) for k, v in tree_logical.items()}
    TP.from_logical({"experts": t}, plan)
    return {k: v.numpy() for k, v in t.items()}


def _check_placed(ranks, key, ref, plan, rel=1e-5):
    """y, load, drop_frac and the synced gradients (times the world: the
    objective is the ranks' sum) against a whole-input oracle: each rank's
    expert rows against the oracle's in the plan's physical order."""
    world = len(ranks)
    y = np.concatenate([r[f"{key}/y"] for r in ranks])
    np.testing.assert_allclose(y, ref["y"].reshape(y.shape), rtol=rel,
                               atol=rel, err_msg=key)
    xg = np.concatenate([r[f"{key}/grad/x"] for r in ranks])
    _close_to_scale(xg, ref["grad"]["x"].reshape(xg.shape), rel, f"{key} x")
    phys = _physical({leaf: ref["grad"][f"experts/{leaf}"]
                      for leaf in ("wi_gate", "wi_up", "wo")}, plan)
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r[f"{key}/load"], ref["load"], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
        np.testing.assert_allclose(r[f"{key}/drop_frac"], ref["drop_frac"],
                                   atol=1e-6)
        _close_to_scale(world * r[f"{key}/grad/router/w"],
                        ref["grad"]["router/w"], rel, f"{key} router")
        m = rank % plan.num_ranks
        for leaf, whole in phys.items():
            _close_to_scale(world * r[f"{key}/grad/experts/{leaf}"],
                            _rank_rows_of(whole, plan, m), rel,
                            f"{key} rank {rank} {leaf}")


@pytest.mark.parametrize("name", PLACE_MESHES)
def test_placed_layer_matches_jax_single_rank(ep, name):
    """The a2a layer under a plan that permutes the experts and shadows mp
    of them (serial, and at 2 chunks with the filler in the first wire
    bubble), capacity and ragged, each impl; on the node mesh the ragged
    exchange is two-level: y, the load in logical order, drop_frac and
    the gradients against JAX's single-rank layer at 1e-5.  The shadowed
    experts' gradients agree on every rank (summed over the world)."""
    from repro_torch import placement as TP
    ranks = _ranks(ep, name)
    mp = len(ranks) // _mesh_shape(name)[0]
    plan = _place_plan(TP, mp)
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            for oc in (0, 2):
                key = f"place/{dispatch}/{impl}/{oc}"
                ref = ep["oracle"][f"{dispatch}/{impl}"]
                if oc == 0 or impl == "fused":
                    _check_placed(ranks, key, ref, plan)
                else:
                    y = np.concatenate([r[f"{key}/y"] for r in ranks])
                    np.testing.assert_allclose(
                        y, ref["y"].reshape(y.shape), rtol=1e-5, atol=1e-5)
            for leaf in ("wi_gate", "wi_up", "wo"):
                g = f"place/{dispatch}/{impl}/0/grad/experts/{leaf}"
                for r in ranks[1:]:
                    np.testing.assert_array_equal(r[g][-mp:], ranks[0][g][-mp:])


@pytest.mark.parametrize("name", PLACE_MESHES)
def test_placed_expert_choice_matches_its_shard_oracle(ep, name):
    """Expert-choice under the plan (both dispatches, fused): the token
    grid goes to physical order and the combine runs in logical order;
    against JAX's layer on each rank's token block."""
    from repro_torch import placement as TP
    ranks = _ranks(ep, name)
    mp = len(ranks) // _mesh_shape(name)[0]
    plan = _place_plan(TP, mp)
    for dispatch in DISPATCHES:
        ref = dict(ep["zoo"][("expert_choice", dispatch, len(ranks))])
        _check_placed(ranks, f"place/ec/{dispatch}", ref, plan)


def _jax_shardwise(ranks_n: int, plan, impl="einsum"):
    """JAX's shard-wise layer under ``plan``: on each rank's token block,
    the reference's gate, its capacity plan with the per-expert capacities
    (the owned experts at the plan's main capacity, the shadowed at the
    full one), the experts and the combine — what the a2a layer computes
    on a rank, without the exchange.  Returns (y, load, drop_frac)."""
    import jax.numpy as jnp

    import dist_utils as du
    from repro.core import dispatch as JD
    from repro.core import fmoe as jfmoe
    from repro.core.balance import load_metrics
    from repro.core.gate import route_tokens
    from repro.placement import from_logical, shadow_spec

    env = du.moe_env()
    cfg = env.cfg
    E, k = cfg.num_experts, cfg.top_k
    d = env.x.shape[-1]
    xs = env.x.reshape(ranks_n, -1, d)
    t = xs.shape[1]
    pp = from_logical(env.params, plan)
    table = jnp.asarray(plan.logical_to_physical)
    C = JD.expert_capacity(t, E, k, cfg.capacity_factor)
    spec = shadow_spec(plan, E, C)
    ys, loads, drops = [], 0, []
    for i in range(ranks_n):
        g = route_tokens(env.params["router"], xs[i], cfg)
        p = JD.make_capacity_plan(table[g.expert_ids], E,
                                  tuple(int(c) for c in spec.capacities))
        out = jfmoe.EXPERT_FNS[impl](pp["experts"],
                                     JD.dispatch_capacity(xs[i], p, E),
                                     "swiglu")
        ys.append(JD.combine_capacity(out, p, g.combine_weights))
        loads = loads + p.load
        drops.append(float(load_metrics(p.load, p.keep, t * k)[1]))
    load = np.asarray(loads, np.float64)[np.asarray(table)]
    return (np.concatenate([np.asarray(y) for y in ys]),
            load / load.sum(), float(np.mean(drops)))


@pytest.mark.parametrize("name", ["1x2", "1x4"])
def test_shrunk_capacity_matches_jax_shardwise(ep, name):
    """A shrunk exchange capacity (scale PLACE_SHRINK) drops the owned
    experts' rows past it, the shadowed experts keep the full capacity:
    y, the logical load and drop_frac against JAX's shard-wise layer."""
    from repro import placement as JP
    ranks = _ranks(ep, name)
    mp = len(ranks)
    y_ref, load_ref, drop_ref = _jax_shardwise(
        mp, _place_plan(JP, mp, scale=PLACE_SHRINK))
    assert drop_ref > 0.05, drop_ref  # the shrink really drops
    for impl in IMPLS:
        key = f"place/shrunk/{impl}"
        y = np.concatenate([r[f"{key}/y"] for r in ranks])
        np.testing.assert_allclose(y, y_ref.reshape(y.shape), rtol=1e-5,
                                   atol=1e-5, err_msg=impl)
        for r in ranks:
            np.testing.assert_allclose(r[f"{key}/drop_frac"], drop_ref,
                                       rtol=1e-6, err_msg=impl)
            np.testing.assert_allclose(r[f"{key}/load"], load_ref, rtol=1e-6,
                                       atol=1e-7, err_msg=impl)


@pytest.mark.parametrize("name", ["1x2", "1x4"])
def test_migration_across_ranks_is_the_single_process_migrate(ep, name):
    """Each rank's expert rows after migrating its shard (a 2-layer tree
    and the AdamW moments) from the identity layout to a per-layer plan
    with shadows, then to a shared plan without, then back to logical
    order: bit for bit the single-process migrate of the whole tree,
    restricted to the rank's rows."""
    from repro_torch import placement as TP
    ranks = _ranks(ep, name)
    mp = len(ranks)
    inp = dict(np.load(ep["root"] / "layer.npz"))
    whole = {k[len("experts/"):]: v for k, v in inp.items()
             if k.startswith("experts/")}
    trees = {"p": [whole, {n: v * 2 for n, v in whole.items()}]}
    trees["mu"] = [{n: v + 1 for n, v in layer.items()}
                   for layer in trees["p"]]
    plan_a = TP.per_layer_placement([_place_plan(TP, mp),
                                     _place_plan(TP, mp, seed=PLACE_SEED + 1)])
    plan_b = _place_plan(TP, mp, seed=PLACE_SEED + 2, num_shadow=0)
    ident = TP.identity_placement(LAYER["num_experts"], mp)
    for name_, layers in trees.items():
        t = {"layers": [{"experts": {n: torch.from_numpy(np.array(v))
                                     for n, v in layer.items()}}
                        for layer in layers]}
        for key, (old, new) in (("a", (ident, plan_a)), ("b", (plan_a, plan_b)),
                                ("back", (plan_b, ident))):
            TP.migrate(t, old, new)
            for i, layer in enumerate(t["layers"]):
                lp = new.layers[i] if hasattr(new, "layers") else new
                for n, v in layer["experts"].items():
                    want = v.numpy()
                    for rank, r in enumerate(ranks):
                        got = r[f"migrate/{key}/{name_}/{i}/experts/{n}"]
                        np.testing.assert_array_equal(
                            got, _rank_rows_of(want, lp, rank),
                            f"{key} {name_} {i} {n} rank {rank}")
    for rank, r in enumerate(ranks):  # back to the start
        e = LAYER["num_experts"] // mp
        np.testing.assert_array_equal(
            r["migrate/back/p/0/experts/wo"],
            whole["wo"][rank * e:(rank + 1) * e])


def test_replan_hook_replans_and_rolls_back_as_the_reference(ep):
    """1x2: the port's ReplanHook, forced to accept (min_gain -10) on a
    skewed load, replans at the reference's step to the reference's plan,
    migrates the live state and keeps training; the loss series that
    regresses after it rolls the plan back at the reference's step, and
    the blacklisted plan is not proposed again.  The reference's
    decisions come from its own LoadMonitor, PlacementController and
    ReplanProbation fed the same series (the port's default constants)."""
    from repro import placement as JP
    from repro.core import monitor as jmon
    from repro.core.balance import MoEMetrics
    from repro.resilience import ReplanProbation
    from repro_torch.core.dispatch import expert_capacity
    from repro_torch.placement import CostConstants

    ranks = _ranks(ep, "1x2")
    cfg = _model_cfg("capacity")
    moe = cfg.moe
    mon = jmon.LoadMonitor(moe.num_experts)
    cap = expert_capacity(MODEL_B * MODEL_S // 2, moe.num_experts, moe.top_k,
                          moe.capacity_factor)
    ctl = JP.PlacementController(
        mon, 2, d_model=cfg.d_model, d_hidden=moe.d_expert_hidden,
        capacity=cap, capacity_factor=moe.capacity_factor, every=2,
        constants=JP.CostConstants(*CostConstants()[:3]))
    ctl.min_gain = -10.0
    prob = ReplanProbation(window=4)
    skew = 1.0 / (np.arange(moe.num_experts) + 1) ** 1.5
    ema, events, plan = None, [], None
    for step in range(HOOK_STEPS):
        loss = HOOK_LOSSES[step]
        ema = loss if ema is None else 0.9 * ema + 0.1 * loss
        mon.update(MoEMetrics(0.0, 0.0, skew, 0.0))
        if prob.active:
            dec = prob.observe(step, loss=loss, drop=0.0)
            if dec.rollback:
                ctl.rollback(dec.old_plan, dec.new_plan)
                events.append([step, ctl.replans, ctl.rollbacks])
                continue
            if prob.active:
                continue
        old = ctl.current
        new = ctl.maybe_replan(step)
        if new is not None:
            prob.start(step, old, new, baseline_loss=ema, baseline_drop=0.0)
            events.append([step, ctl.replans, ctl.rollbacks])
            plan = new
    assert [e[2] for e in events] == [0, 1], events  # a replan, a rollback
    for r in ranks:
        np.testing.assert_array_equal(r["hook/events"], np.asarray(events))
        np.testing.assert_array_equal(
            r["hook/plan"], [*plan.physical_to_logical, plan.num_shadow])
        assert bool(r["hook/final_identity"])
        assert np.isfinite(r["hook/losses"]).all(), r["hook/losses"]


def test_hook_sink_takes_the_replan_trail(ep):
    """The hook's telemetry sink on 1x2: a snapshot of the monitor at each
    of its samples (every step here), the replan's record and the
    probation's rollback verdict, at the steps of the hook's events in
    test_replan_hook_replans_and_rolls_back_as_the_reference."""
    for r in _ranks(ep, "1x2"):
        trail = [str(t) for t in r["hook/sink"]]
        events = [t for t in trail if not t.startswith("load_monitor@")]
        (replan, _, _), (back, _, _) = r["hook/events"]
        assert events == [f"replan@{replan}", f"replan_rollback@{back}"], trail
        assert trail.count("load_monitor@1") == 1, trail
        assert len(trail) - len(events) == HOOK_STEPS, trail


def test_placed_checkpoint_from_1x2_restores_at_1x1(ep):
    """A checkpoint saved on 1x2 under a per-layer plan with shadowed
    experts is in logical order: restored with no mesh and no plan, by the
    port and by the JAX package, it is the unplaced whole params bit for
    bit; restored on the 1x2 mesh under the plan, each rank's shard is the
    one it saved."""
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro_torch import interop
    from repro_torch.checkpoint import ckpt

    for r in _ranks(ep, "1x2"):
        assert bool(r["ckpt/restored_shard_equal"])
    path = str(ep["root"] / "1x2" / "ckpt_placed")
    params_np = _unflatten(dict(np.load(ep["root"] / "model_params.npz")))
    cfg = _model_cfg("ragged")
    want = interop.from_jax(params_np, cfg, device="cpu")
    like = {"params": _zeros_like(want)}
    got = ckpt.restore(path, like)["params"]
    assert ckpt.load_manifest(path)["step"] == 3
    for (k, a), (_, b) in zip(_flatten(interop.to_jax(got)).items(),
                              _flatten(interop.to_jax(want)).items()):
        np.testing.assert_array_equal(a, b, err_msg=k)
    jlike = {"params": jax.tree.map(np.zeros_like, params_np)}
    jgot = jckpt.restore(path, jlike)["params"]
    for k, v in _flatten(jax.tree.map(np.asarray, jgot)).items():
        np.testing.assert_array_equal(v, _flatten(params_np)[k], err_msg=k)


def _zeros_like(tree):
    """A port tree of zeros shaped like ``tree`` (dicts and lists)."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree)


def test_train_cli_replan_hook_under_torchrun():
    """``train --mesh 1x2 --replan_every 2 --per_layer_plans --ragged_bound
    auto`` (ragged) runs: the cold monitor resolves the bound to the
    dropless 0, and the hook reports its replans."""
    lines, losses = _train_cli("--mesh", "1x2", "--dispatch", "ragged",
                               "--replan_every", "2", "--per_layer_plans",
                               "--ragged_bound", "auto", ranks=2)
    assert ("mesh 1x2 (a2a over ('data', 'model'), ragged bound 0)"
            in lines), lines
    assert any(ln.startswith("placement: 0 replans") for ln in lines), lines
    assert all(5.0 < v < 8.0 for v in losses), losses


@pytest.mark.parametrize("router", ["topk", "expert_choice"])
@pytest.mark.parametrize("name", ["1x2", "1x4"])
def test_placed_psum_layer_matches_jax(ep, name, router):
    """The psum mode (1xM, every rank holds every token) under a plan that
    permutes the experts and shadows mp of them, each dispatch and impl:
    every rank's y equal, y, the logical load and drop_frac against the
    JAX package's single-rank layer at 1e-5 (expert-choice's: its zoo
    oracle), and on 1x2 against its placed psum layer on fake devices
    (einsum) at 1e-5; the gradients of sum(y * r) after sync_grads (each
    rank's owned block and shadowed tail held to the oracle's rows in the
    plan's order; a token's input gradient is its model group's mean)."""
    from repro_torch import placement as TP
    ranks = _ranks(ep, name)
    mp = len(ranks)
    plan = _place_plan(TP, mp)
    jax_placed = _jax_dist_result(ep, "1x2") if name == "1x2" else {}
    for dispatch in DISPATCHES:
        for impl in IMPLS:
            key = f"place_psum/{router}/{dispatch}/{impl}"
            ref = (ep["oracle"][f"{dispatch}/{impl}"] if router == "topk"
                   else ep["zoo"][("expert_choice", dispatch, 1)])
            y = ranks[0][f"{key}/y"]
            for r in ranks:
                np.testing.assert_array_equal(r[f"{key}/y"], y, key)
                np.testing.assert_allclose(r[f"{key}/load"], ref["load"],
                                           rtol=1e-5, atol=1e-6, err_msg=key)
                np.testing.assert_allclose(r[f"{key}/drop_frac"],
                                           ref["drop_frac"], atol=1e-6)
            np.testing.assert_allclose(y, ref["y"].reshape(y.shape),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
            if router == "topk" and jax_placed:
                jk = f"place_psum/{dispatch}"
                np.testing.assert_allclose(
                    y, jax_placed[f"{jk}/y"].reshape(y.shape), rtol=1e-5,
                    atol=1e-5, err_msg=key)
                np.testing.assert_allclose(ranks[0][f"{key}/load"],
                                           jax_placed[f"{jk}/load"],
                                           rtol=1e-5, atol=1e-6)
            xg = sum(r[f"{key}/grad/x"] for r in ranks) / mp
            _close_to_scale(xg, ref["grad"]["x"].reshape(xg.shape), 1e-5,
                            f"{key} x")
            phys = _physical({leaf: ref["grad"][f"experts/{leaf}"]
                              for leaf in ("wi_gate", "wi_up", "wo")}, plan)
            for m, r in enumerate(ranks):
                _close_to_scale(r[f"{key}/grad/router/w"],
                                ref["grad"]["router/w"], 1e-5,
                                f"{key} router")
                for leaf, whole in phys.items():
                    _close_to_scale(r[f"{key}/grad/experts/{leaf}"],
                                    _rank_rows_of(whole, plan, m), 1e-5,
                                    f"{key} rank {m} {leaf}")


@pytest.mark.parametrize("name", ["1x2", "1x4"])
def test_placed_psum_layer_is_layout_invariant(ep, name):
    """The slot-wise reduction: the layer under the plan (a permutation,
    mp shadowed experts computed outside the all-reduce) gives bit for bit
    the output of the identity plan, for each router, dispatch and impl
    (on the CPU the plain kernels compute each expert's rows alone, so a
    row's sums do not depend on the launch that holds it)."""
    for r in _ranks(ep, name):
        for router in ("topk", "expert_choice"):
            for dispatch in DISPATCHES:
                for impl in IMPLS:
                    key = f"place_psum/{router}/{dispatch}/{impl}"
                    np.testing.assert_array_equal(
                        r[f"{key}/y"], r[f"{key}/identity/y"], key)
                    np.testing.assert_array_equal(
                        r[f"{key}/load"], r[f"{key}/identity/load"], key)


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_placed_psum_train_step_matches_jax(ep, dispatch):
    """1x2, the psum mode (every rank holds every row) under the serving
    cell's per-layer plan (a permutation per layer, 2 shadowed experts):
    reduced fastmoe-gpt with remat, the step-0 loss, aux and z loss, the
    load, every gradient leaf after sync_grads (each rank's expert rows
    against the JAX package's whole gradient in the plan's order, layer by
    layer), the grad norm and two AdamW steps' losses, against the JAX
    package's distributed loss_fn under the same plan at 1e-4."""
    from repro_torch import placement as TP
    ranks = _ranks(ep, "1x2")
    ref = _jax_dist_result(ep, "1x2")
    plan = _serve_plan(2, TP)
    key = f"place_psum_model/{dispatch}"
    for m, r in enumerate(ranks):
        for k in ("loss", "aux_loss", "z_loss", "drop_frac", "losses",
                  "grad_norm"):
            np.testing.assert_allclose(r[f"{key}/{k}"], ref[f"{key}/{k}"],
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(r[f"{key}/load"], ref[f"{key}/load"],
                                   atol=1e-6)
        grads, jgrads = _sub(r, f"{key}/grad"), _sub(ref, f"{key}/grad")
        assert grads.keys() == jgrads.keys()
        for path, g in grads.items():
            want = jgrads[path]
            if "/experts/" in path:  # (L, own + shadowed, ...) of (L, E, ...)
                want = np.stack([_rank_rows_of(w, lp, m) for w, lp in
                                 zip(want, plan.layers)])
            else:  # the rank's block under the train layout
                want = _rank_shard(want, path, m, "1x2")
            _close_to_scale(g, want, 1e-4, f"{key} rank {m} {path}")


def _serve_tokens(ep):
    """The one-process batcher's tokens on the serving cell (unplaced),
    made in the test process from the JAX package's params."""
    from repro_torch import interop
    cfg = _model_cfg("ragged")
    params_np = _unflatten(dict(np.load(ep["root"] / "model_params.npz")))
    return _batcher_tokens(interop.from_jax(params_np, cfg, device="cpu"),
                           cfg, None, None, False)


def test_replan_mid_stream_is_invisible_in_the_tokens(ep):
    """The reference's tests/test_scheduler.py cell on 1x2 (gloo): the
    same stream under the identity per-layer plan, and with the serving
    cell's plan (a permutation per layer, 2 shadowed experts) switched in
    after tick 3 (apply_placement: the params migrated across the ranks),
    gives the same tokens on every rank, those of the one-process batcher,
    and the JAX package's batcher's under both (greedy, f32)."""
    ranks = _ranks(ep, "1x2")
    jax_serve = ep["jax"].get("serve")
    assert isinstance(jax_serve, dict), jax_serve
    single = _serve_tokens(ep)
    assert (single >= 0).sum() == 45, single
    for r in ranks:
        np.testing.assert_array_equal(r["serve/moved"], r["serve/base"])
        np.testing.assert_array_equal(r["serve/base"], single)
    np.testing.assert_array_equal(jax_serve["serve/1x2/moved"],
                                  jax_serve["serve/1x2/base"])
    np.testing.assert_array_equal(ranks[0]["serve/base"],
                                  jax_serve["serve/1x2/base"])


def test_batcher_per_data_group_matches_one_process(ep):
    """2x2 (gloo): a batcher per data group, each decoding 2 of the 4
    slots and exchanging its tokens over the data axis, gives the
    completions of the port's one-process batcher, unplaced and with the
    plan switched in after tick 3, on every rank; and the JAX package's
    batcher's on the same 2x2 mesh of fake devices."""
    ranks = _ranks(ep, "2x2")
    jax_serve = ep["jax"].get("serve")
    assert isinstance(jax_serve, dict), jax_serve
    single = _serve_tokens(ep)
    for r in ranks:
        for key in ("plain", "moved"):
            np.testing.assert_array_equal(r[f"serve/{key}"], single, key)
            np.testing.assert_array_equal(jax_serve[f"serve/2x2/{key}"],
                                          single, key)


SL_MESHES = ("1x2", "2x2")


@pytest.mark.parametrize("opts", list(SL_OPTS))
@pytest.mark.parametrize("arch", SL_ARCHS)
@pytest.mark.parametrize("name", SL_MESHES)
def test_serve_layout_decode_matches_jax_serve_step(ep, name, arch, opts):
    """Serving on a mesh (gloo) under the reference's layouts: greedy
    static decode of reduced qwen2-72b (dense: GQA attention, the SwiGLU
    FFN, the embedding and the head tensor-parallel over model) and of
    reduced fastmoe-gpt (attention tensor-parallel, experts in the psum
    mode) through ``serve.make_serve_step``, under the train-mode specs
    (FSDP over data gathered at use) and under ``serve_tp``: every step's
    logits against the JAX package's ``jit_serve_step`` on the same mesh
    of fake devices with the same opts at 1e-4, the greedy tokens equal,
    and the model ranks of a data group bit-equal (the vocab-parallel
    logits gathered)."""
    ranks = _ranks(ep, name)
    jax_serve = ep["jax"].get("serve")
    assert isinstance(jax_serve, dict), jax_serve
    data, model = MESHES[name]
    key, ref = f"sl/{arch}/{opts}", f"sl/{name}/{arch}/{opts}"
    lead = [ranks[g * model] for g in range(data)]
    logits = np.concatenate([r[f"{key}/logits"] for r in lead], axis=1)
    np.testing.assert_allclose(logits, jax_serve[f"{ref}/logits"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(
        np.concatenate([r[f"{key}/tokens"] for r in lead]),
        jax_serve[f"{ref}/tokens"])
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r[f"{key}/logits"],
                                      lead[i // model][f"{key}/logits"])


@pytest.mark.parametrize("name", SL_MESHES)
def test_serve_layout_ranks_hold_their_blocks(ep, name):
    """A serving rank holds only its spec blocks, checked by shape: reduced
    qwen2-72b (d 64, 4 heads and kv heads of 16, FFN 224, vocab 512) with
    heads, FFN columns and vocab rows over model, and under the train-mode
    specs the embed dim over data too; its ring the rank's KV heads and
    data block of the rows; reduced fastmoe-gpt's experts over model,
    their hidden dim over data under the train-mode specs only, the router
    whole."""
    ranks = _ranks(ep, name)
    D, M = MESHES[name]
    d, H, KV, hd, F, V = 64, 4, 4, 16, 224, 512
    moe = _model_cfg("ragged").moe
    E, h = moe.num_experts, moe.d_expert_hidden
    for opts in SL_OPTS:
        f = D if opts == "train" else 1  # the embed dim's FSDP split
        dense = {"embed/table": (V // M, d // f), "lm_head/w": (d // f, V // M),
                 "layers/0/attn/wq/w": (d // f, H * hd // M),
                 "layers/0/attn/wq/b": (H * hd // M,),
                 "layers/0/attn/wk/w": (d // f, KV * hd // M),
                 "layers/1/attn/wo/w": (H * hd // M, d // f),
                 "layers/1/ffn/wi_gate": (d // f, F // M),
                 "layers/1/ffn/wo": (F // M, d // f),
                 "layers/0/norm1/scale": (d,)}
        moe_want = {"layers/0/ffn/experts/wi": (E // M, d, h // f),
                    "layers/0/ffn/experts/wo": (E // M, h // f, d),
                    "layers/0/ffn/router/w": (d, E),
                    "layers/0/attn/wv/w": (d // f, 4 * 16 // M)}
        for r in ranks:
            for arch, want in (("qwen2-72b", dense), ("fastmoe-gpt", moe_want)):
                for path, shape in want.items():
                    got = tuple(r[f"sl/{arch}/{opts}/shape/{path}"])
                    assert got == shape, (name, opts, arch, path, got)
            assert tuple(r[f"sl/qwen2-72b/{opts}/cache_k"]) == (
                MODEL_B // D, DECODE_CACHE, KV // M, hd)


@pytest.mark.parametrize("name", SL_MESHES)
def test_paged_batcher_under_serve_tp_matches_jax(ep, name):
    """The paged continuous batcher with ``opts={"serve_tp": True}`` on 1x2
    and 2x2 (gloo; params in the serve-mode specs, attention tensor-
    parallel): every rank's completions are the one-process batcher's and
    the JAX package's ``ContinuousBatcher(opts=...)`` on the same mesh of
    fake devices."""
    ranks = _ranks(ep, name)
    jax_serve = ep["jax"].get("serve")
    assert isinstance(jax_serve, dict), jax_serve
    single = _serve_tokens(ep)
    for r in ranks:
        np.testing.assert_array_equal(r["serve/tp"], single)
    np.testing.assert_array_equal(jax_serve[f"serve/{name}/tp"], single)


REFUSED = {
    # placement is carried in every mode (ROADMAP §1 items 4 and 5, done);
    # shadowing under expert-internal TP is refused, as the reference does
    "placement": (dict(tp_axis="data", placement="shadowed"),
                  "expert-internal TP"),
    # as the reference: tp takes the capacity dispatch
    "ragged_tp": (dict(tp_axis="data"), "ragged dispatch"),
    # fsdp_axis="data" is carried (the train layout, ROADMAP §1 item 9,
    # done); the hidden dim shards over no other axis
    "fsdp_axis": (dict(fsdp_axis="model"), "hidden dim over 'data'"),
    # the zoo is carried (ROADMAP §1 item 3, done): a router outside it
    # is what the dist channel refuses
    "router": (dict(router="switch"), "unknown router"),
}


@pytest.mark.parametrize("what", list(REFUSED))
def test_unsupported_options_raise(what):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe
    from repro_torch.launch.mesh import Mesh

    from repro_torch.placement import ExpertPlacement

    kw, item = REFUSED[what]
    kw = {"token_axes": ("data", "model"), **kw}
    if kw.get("placement") == "shadowed":
        E = LAYER["num_experts"]
        kw["placement"] = ExpertPlacement(E, 2, tuple(range(E)), num_shadow=2)
    dist = fmoe.DistConfig(Mesh(1, 2), **kw)
    cfg = MoEConfig(dispatch="ragged" if what == "ragged_tp" else "capacity",
                    **LAYER)
    gen = torch.Generator().manual_seed(0)
    params = fmoe.fmoe_init(gen, 32, cfg, device="cpu")
    x = torch.zeros(8, 32)
    error = ValueError if what in ("router", "fsdp_axis") else \
        NotImplementedError
    with pytest.raises(error, match=item):
        fmoe.fmoe_apply(params, x, cfg, dist=dist)


@pytest.mark.parametrize("name", ["1x2", "2x2", "1x4"])
@pytest.mark.parametrize("router", ZOO)
def test_zoo_layer_matches_single_rank_oracle(ep, name, router):
    """Each router in the a2a and psum modes, both dispatches: y, load and
    drop_frac at 1e-5, and the gradients (synced, as the layer matrix's)
    at 1e-5 of each leaf's scale, against the oracle of ``_zoo_oracle``:
    expert-choice's a2a against its layer on each rank's token block, its
    psum mode against the layer on each data block."""
    ranks = _ranks(ep, name)
    data, model = MESHES[name]
    world = data * model
    for dispatch in DISPATCHES:
        for mode in ("a2a", "psum"):
            key = f"zoo/{mode}/{router}/{dispatch}"
            shards = 1
            if router == "expert_choice":
                shards = world if mode == "a2a" else data
            ref = ep["zoo"][(router, dispatch, shards)]
            if mode == "a2a":
                y = np.concatenate([r[f"{key}/y"] for r in ranks])
                xg = np.concatenate([r[f"{key}/grad/x"] for r in ranks])
                scale = world
            else:
                y = np.concatenate([ranks[d * model][f"{key}/y"]
                                    for d in range(data)])
                xg = np.concatenate([
                    sum(ranks[d * model + m][f"{key}/grad/x"]
                        for m in range(model)) / model for d in range(data)])
                scale = data
            np.testing.assert_allclose(y, ref["y"].reshape(y.shape),
                                       rtol=1e-5, atol=1e-5, err_msg=key)
            _close_to_scale(xg, ref["grad"]["x"].reshape(xg.shape), 1e-5,
                            f"{key} x")
            for rank, r in enumerate(ranks):
                np.testing.assert_allclose(r[f"{key}/load"], ref["load"],
                                           rtol=1e-5, atol=1e-6, err_msg=key)
                np.testing.assert_allclose(r[f"{key}/drop_frac"],
                                           ref["drop_frac"], atol=1e-6)
                for leaf in ("w", "w_noise", "w_frozen"):
                    _close_to_scale(scale * r[f"{key}/grad/router/{leaf}"],
                                    ref["grad"][f"router/{leaf}"], 1e-5,
                                    f"{key} router {leaf}")
                for leaf in ("wi_gate", "wi_up", "wo"):
                    want = _expert_slice(ref["grad"][f"experts/{leaf}"], leaf,
                                         rank, MESHES[name])
                    _close_to_scale(scale * r[f"{key}/grad/experts/{leaf}"],
                                    want, 1e-5, f"{key} rank {rank} {leaf}")
            if router == "expert_choice":
                for r in ranks:
                    np.testing.assert_array_equal(r[f"{key}/load"],
                                                  np.full(8, 1 / 8, np.float32))
                    assert float(r[f"{key}/drop_frac"]) == 0.0


@pytest.mark.parametrize("router", ZOO)
@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_world_size_1_zoo_is_the_local_path_bit_for_bit(ep, router,
                                                        dispatch):
    """At world size 1 each router's a2a and psum train steps equal the
    local one bit for bit (loss, gradients, grad norm and params after
    AdamW), and the local step repeats bit for bit."""
    r = _ranks(ep, "1x1")[0]
    for name in ("again", "ep", "psum"):
        assert bool(r[f"zoo_bit_equal/{router}/{dispatch}/{name}"]), name


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
    """moe_dist's modes by the rows; the bounds' calibration from the load
    monitor (item 4, carried) resolves to the dropless 0 without a
    monitor."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    from repro_torch.launch.mesh import Mesh

    cfg = reduced(get_config("fastmoe-gpt"))
    assert train.moe_dist(cfg, Mesh(2, 2), 64,
                          ragged_bound="auto").ragged_bound == 0
    mesh = Mesh(2, 2)
    assert train.moe_dist(cfg, mesh, 64).mode == "a2a"
    assert train.moe_dist(cfg, mesh, 62).mode == "psum"  # 62 % 4 != 0
    assert train.moe_dist(cfg, Mesh(1, 3), 63) is None  # 4 experts, 3 ranks


def _train_cli(*args, ranks=4):
    """The train CLI (under torchrun with ``ranks`` gloo ranks when ``ranks
    > 1``): (stdout lines, the logged losses)."""
    pre = (["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(ranks)] if ranks > 1 else [])
    cmd = [sys.executable, *pre, "-m", "repro_torch.launch.train",
           "--device", "cpu", "--reduced", "--steps", "2", "--log_every", "1",
           *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == 2, out.stdout  # rank 0 logs alone
    return lines, [float(ln.split("loss")[1].split()[0]) for ln in steps]


def test_train_cli_under_torchrun():
    """The README's command, 4 ranks of gloo on a 2x2 mesh: 8 rows split
    over every rank (a2a); exits 0 with a falling loss.  At the default
    learning rate the first step's update (warmup: 1/100 of 3e-4) moves the
    loss less than the next batch does, so the step is taken at 3e-2,
    where it falls by ~0.4."""
    lines, losses = _train_cli("--mesh", "2x2", "--lr", "0.03")
    assert "mesh 2x2 (a2a over ('data', 'model'))" in lines, lines
    assert 5.0 < losses[0] < 8.0 and losses[1] < losses[0], losses


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_train_cli_psum_under_torchrun(mesh):
    """A batch of 2 rows does not split over 4 ranks: the train CLI takes
    the psum mode over ("data",), as the reference's moe_dist does.  On
    1x4 the data axis has one rank, so every rank holds every row and the
    logged losses are the single-process run's (ragged, so dropless) to
    1e-4 and the 4-decimal print; on 2x2 a model group shares its data
    row's one row."""
    args = ["--batch", "2", "--seq", "16", "--dispatch", "ragged"]
    lines, losses = _train_cli("--mesh", mesh, *args)
    assert f"mesh {mesh} (psum over ('data',))" in lines, lines
    assert all(5.0 < v < 8.0 for v in losses), losses
    if mesh == "1x4":
        _, single = _train_cli(*args, ranks=1)
        np.testing.assert_allclose(losses, single, rtol=0, atol=1e-4 + 1e-6)


_FLAT_LOSSES: dict = {}


@pytest.mark.parametrize("extra", [[], ["--overlap_chunks", "2", "--impl",
                                       "fused", "--inter_bound", "256"]])
def test_train_cli_node_mesh_matches_flat(extra):
    """The README's two-level command at sequences of 64: 4 ranks on a
    1x2x2 mesh (ragged) print the same losses as on 1x4, serially and at 2
    chunks with slim shards of 256 rows (half the default n_inner * bound,
    dropless at these batches)."""
    args = ["--dispatch", "ragged", "--seq", "64"]
    lines, hier = _train_cli("--mesh", "1x2x2", *args, *extra)
    assert "mesh 1x2x2 (a2a over ('data', 'node', 'model'))" in lines, lines
    if not _FLAT_LOSSES:
        _FLAT_LOSSES["1x4"] = _train_cli("--mesh", "1x4", *args)[1]
    assert hier == _FLAT_LOSSES["1x4"], (hier, _FLAT_LOSSES)


def test_moe_dist_modes_and_expert_tp():
    """moe_dist: a2a where the rows split over every rank, carrying
    tp_axis="data" under expert_tp; the psum fallbacks (over data, or
    over ()) leave tp_axis None; a tp_axis in the psum mode shards
    nothing."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import fmoe
    from repro_torch.launch.mesh import Mesh

    cfg = reduced(get_config("fastmoe-gpt"))
    mesh = Mesh(2, 2)
    dist = fmoe.moe_dist(cfg, mesh, 4, expert_tp=True)
    assert (dist.mode, dist.tp_axis, dist.expert_tp) == ("a2a", "data", True)
    assert fmoe.moe_dist(cfg, mesh, 4).tp_axis is None
    for rows, axes in ((2, ("data",)), (3, ())):
        dist = fmoe.moe_dist(cfg, mesh, rows, expert_tp=True)
        assert (dist.mode, dist.token_axes, dist.tp_axis) == ("psum", axes, None)
    assert not fmoe.DistConfig(mesh, ("data",), tp_axis="data").expert_tp


def test_batcher_refuses_a_data_axis():
    """A data axis serves now (ROADMAP §1 item 5: a batcher per data
    group): on a 2x2 mesh rank 2 (data group 1) holds slots 2 and 3 of 4,
    and 3 slots, which do not split, are every group's.  What the batcher
    still refuses is a node axis (the reference's serving has none), from
    a mesh or from ServeConfig.mesh."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve_api import ServeConfig
    from repro_torch.models import lm

    cfg = _model_cfg("ragged")
    params = lm.init_params(cfg, seed=0, device="cpu")
    for slots, mine in ((4, range(2, 4)), (3, range(0, 3))):
        b = ContinuousBatcher(params, cfg, ServeConfig(slots=slots),
                              mesh=Mesh(2, 2, rank=2), device="cpu")
        assert b.mine == mine, (slots, b.mine)
    with pytest.raises(NotImplementedError, match="node axis"):
        ContinuousBatcher(params, cfg, ServeConfig(slots=2),
                          mesh=Mesh(1, 2, node=2), device="cpu")
    with pytest.raises(NotImplementedError, match="node axis"):
        ContinuousBatcher(params, cfg, ServeConfig(slots=2, mesh="1x2x2"),
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


def _serve_cli(*args, ranks=1):
    """The serve CLI, under torchrun with ``ranks`` gloo ranks when ``ranks
    > 1``: its stdout lines."""
    pre = (["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
            str(ranks)] if ranks > 1 else [])
    cmd = [sys.executable, *pre, "-m", "repro_torch.launch.serve", "--device",
           "cpu", "--reduced", "--prompt_len", "8", "--gen", "4", *args]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=SPAWN_TIMEOUT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_serve_cli_replans_under_torchrun():
    """``serve --continuous --mesh 2x2 --replan_every 2`` on 4 gloo ranks (a
    batcher per data group, the serve-time replan hook on the identity
    plan from tick 0) serves every request with rank 0 printing alone, the
    first request's tokens those of the one-process run; and the static
    batch over 1x2 with --per_layer_plans serves under a plan measured on
    its prompt (rank 0 prints it) with the one-process run's tokens."""
    cont = ["--continuous", "--slots", "4", "--requests", "6",
            "--block_size", "4", "--replan_every", "2"]
    lines = _serve_cli(*cont, "--mesh", "2x2", ranks=4)
    assert len(lines) == 2, lines  # rank 0 prints alone
    assert "mesh 2x2 (psum)" in lines[0] and "6 requests, 24 tokens" in lines[0]
    assert "replans=" in lines[0], lines
    assert lines[1] == _serve_cli(*cont)[1]
    static = _serve_cli("--batch", "2", "--mesh", "1x2", "--per_layer_plans",
                        ranks=2)
    assert len(static) == 3 and static[0].startswith("serving plan: shadow="), (
        static)
    assert static[2] == _serve_cli("--batch", "2")[1]


@pytest.mark.cuda
def test_world_size_1_bit_equal_on_the_card(tmp_path):
    """NCCL at world size 1 with the CUDA kernels: the EP paths' loss and
    gradients, and the grad norm and params after one train step, equal
    the local path's bit for bit — a2a, the psum mode and, for capacity,
    expert-internal tensor parallelism."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU machine: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_ep.py, or python3 "
                    "chip_smoke.py, whose EP phase checks the same at full "
                    "width)")
    import torch.distributed as tdist
    from repro_torch.core import fmoe
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    dev = init_distributed("cuda", rank=0, world_size=1,
                           store=tdist.FileStore(str(tmp_path / "store"), 1),
                           timeout=STORE_TIMEOUT)
    try:
        mesh = make_local_mesh(1, 1)
        for dispatch, impl in (("capacity", "fused"), ("ragged", "fused"),
                               ("ragged", "pallas"), ("capacity", "pallas")):
            cfg = _model_cfg(dispatch, d_model=256)  # heads of 64
            dists = {"local": None, "a2a": train.moe_dist(cfg, mesh, MODEL_B),
                     "psum": fmoe.DistConfig(mesh, ("data",))}
            if dispatch == "capacity":
                dists["tp"] = train.moe_dist(cfg, mesh, MODEL_B, expert_tp=True)
            batch = {"tokens": torch.from_numpy(_tokens(0)).to(dev)}
            res = {}
            for name, d in dists.items():
                params = lm.init_params(
                    cfg, seed=0, device=dev, param_dtype=cfg.param_dtype,
                    layout=None if d is None
                    else train.train_dist(cfg, d).layout)
                loss, _, grads = train.loss_and_grads(
                    params, cfg, batch, impl=impl, device=dev, dist=d)
                opt = AdamW(lr=LR)
                step_fn = train.make_train_step(cfg, opt, dist=d, impl=impl,
                                                device=dev)
                params, _, m = step_fn(params, opt.init(params), batch, 0)
                res[name] = ([loss, *tree_leaves(grads), m["grad_norm"],
                              *tree_leaves(params)])
            for name in list(dists)[1:]:
                assert len(res[name]) == len(res["local"])
                for i, (a, b) in enumerate(zip(res["local"], res[name])):
                    assert torch.equal(a, b), (dispatch, impl, name, i)
    finally:
        tdist.destroy_process_group()


def _leaf_paths(tree, path=""):
    """The paths of a params tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in _leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{path}/{i}")]
    return [path]


@pytest.mark.cuda
def test_chunked_step_on_the_card(tmp_path):
    """The §5.2 schedule at world size 1 on the card (NCCL), reduced
    fastmoe-gpt at d_model 256 with the CUDA kernels: at 2 and 4 chunks,
    the undecomposed exchange (one async NCCL all-to-all a chunk) among
    them, the step-0 loss equals the serial exchange's bit for bit, and so
    does every gradient leaf but the expert leaves of a chunked capacity
    step, which take a chunk's dW at a time: those are held to a relative
    L2 distance of 1e-2 to serial's (chip_smoke.py's OVERLAP_EXPERT_L2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on the GPU machine: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_ep.py, or python3 "
                    "chip_smoke.py, whose ep_overlap phase checks the same "
                    "at full width)")
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
        for dispatch, impl in (("capacity", "fused"), ("capacity", "pallas"),
                               ("ragged", "fused")):
            cfg = _model_cfg(dispatch, d_model=256)
            batch = {"tokens": torch.from_numpy(_tokens(0)).to(dev)}
            serial = train.moe_dist(cfg, mesh, MODEL_B)
            params = lm.init_params(cfg, seed=0, device=dev,
                                    param_dtype=cfg.param_dtype,
                                    layout=serial.layout)
            loss0, _, g0 = train.loss_and_grads(params, cfg, batch, impl=impl,
                                                device=dev, dist=serial)
            for n in (2, 4):
                for decompose in (None, False):
                    d = serial._replace(overlap_chunks=n, decompose=decompose)
                    loss, _, g = train.loss_and_grads(
                        params, cfg, batch, impl=impl, device=dev, dist=d)
                    assert torch.equal(loss, loss0), (dispatch, impl, n)
                    for path, a, b in zip(_leaf_paths(g), tree_leaves(g),
                                          tree_leaves(g0)):
                        if dispatch == "capacity" and "/experts/" in path:
                            dist = float((a.float() - b.float()).norm()
                                         / b.float().norm().clamp_min(1e-30))
                            assert dist <= 1e-2, (impl, n, path, dist)
                        else:
                            assert torch.equal(a, b), (dispatch, impl, n, path)
    finally:
        tdist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]), int(sys.argv[2]))
