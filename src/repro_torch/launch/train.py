"""Training: a train step (loss, backward, FastMoE's gradient sync under
expert parallelism, AdamW, with optional microbatch gradient
accumulation) and its CLI.

    python -m repro_torch.launch.train --arch fastmoe-gpt [--reduced] \
        [--num_layers 10] --steps 50 --batch 8 --seq 256 --impl fused \
        --dispatch capacity [--device cpu] [--seed 0]

Expert parallelism over a (data, model) mesh of ranks, one process each:

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --mesh 2x2 \
        --device cpu --reduced --steps 2
    torchrun --nproc_per_node 4 -m repro_torch.launch.train --mesh 1x4 \
        --device cpu --reduced --batch 2      # the psum mode
    torchrun --nproc_per_node 4 -m repro_torch.launch.train --mesh 2x2 \
        --device cpu --reduced --overlap_chunks 2 --wire_dtype bf16
    torchrun --nproc_per_node 4 -m repro_torch.launch.train --mesh 1x2x2 \
        --device cpu --reduced --dispatch ragged --impl fused \
        --overlap_chunks 2 --inter_bound 64   # two-level exchange

(gloo on the CPU, NCCL with one card a rank on the GPU).  The params and
AdamW moments are held in the reference's train layout
(``launch/sharding``, the reference's ``jit_train_step``): each rank draws
its shard of every leaf from the seed (``lm.init_params(layout=...)``):
leaves FSDP-sharded over ``data`` on their embed dim and over ``model`` on
heads, ffn and vocab, the routed expert stacks over the expert axes and
their hidden dim over ``data``.  Each layer gathers its leaves at its
entry (inside the remat region, so the recompute gathers again) and the
gather's backward reduce-scatters the gradient.  When
the batch's rows split over every rank, each rank takes its contiguous
block of them and the MoE layers exchange tokens (a2a); otherwise the
psum mode: the ranks of a model group share their data row's block (or,
where the rows do not split over data either, every row).  The logged
loss is the mean over the ranks.  ``--mesh DxNxM`` adds a node axis: the
experts shard over (node, model) and the ragged exchange runs two-level.
``--overlap_chunks`` runs the §5.2 smart schedule, ``--wire_dtype bf16``
narrows the exchange payloads, ``--ragged_bound`` and ``--inter_bound``
size the ragged and slim inter-node shards (0 = never drop); the psum
mode ignores these, as the reference does.

``--router`` overrides the MoE routing variant (topk, noisy_topk, gumbel,
expert_choice, frozen); the exploration routers draw their noise from
(17, step, microbatch, layer).  ``--freeze_router_at N`` is StableMoE's
second stage: at step N a distilling router (noisy_topk or gumbel) hands
the routing to its distilled ``w_frozen`` (the config flips to
``frozen`` and the step is rebuilt).

Expert placement (the paper's §6 load-balance loop): ``--replan_every N``
feeds a ``LoadMonitor`` from the steps' loads and every N steps asks the
``PlacementController`` for a plan whose modeled step time pays for its
migration; a plan it takes migrates the live params and AdamW state
(``placement.migrate``) and rebuilds the step under it, on probation
(``ReplanProbation``): a loss or drop regression rolls it back and
blacklists it.  ``--per_layer_plans`` plans each layer from its own load;
``--ragged_bound auto`` sizes the ragged shards from the monitor's EMAs at
every rebuild (needs ``--replan_every``).  The hook runs in the a2a mode:

    torchrun --nproc_per_node 4 -m repro_torch.launch.train --mesh 1x4 \
        --device cpu --reduced --dispatch ragged --replan_every 4 \
        --ragged_bound auto

At one rank no plan pays (shadowing saves no wire there), so the planner
keeps the identity layout.

``--impl`` picks the expert kernels (einsum = plain PyTorch, pallas = the
grouped-GEMM kernel in both directions, fused = the fused FFN kernel
forward and the fused dX / grouped dW kernels backward); ``--dispatch``
overrides the config's MoE dispatch (capacity | ragged).  Runs on the GPU
unless ``--device cpu``.  Params are f32 masters cast to ``cfg.dtype`` at
use; ``--num_layers`` cuts the depth (full-width ``fastmoe-gpt`` with f32
params, grads and AdamW moments needs 16 B per param: 10 layers, 66.8 GB,
fit one 80 GB card; 12, 79.8 GB, do not).

Resilience, as the JAX CLI's: ``--ckpt_dir`` holds atomic verified
checkpoints (``step_<N>/``, the state after step N, in the reference's
format and in logical expert order), written every ``--save_every`` steps
and at the end, ``--keep_ckpts`` of them kept; ``--resume`` restores the
newest one that verifies and replays the data stream to its step, so the
run continues as an uninterrupted one would.  The step guard
(``--max_bad_steps``, 0 = off) reads each step's loss, grad norm and drop
fraction on the host, skips a non-finite step and retries it from a host
snapshot of the last good state (``--snapshot_every``); a drop fraction
above ``--drop_spike`` for ``--drop_patience`` steps rebuilds the step
with the dropless ragged bound once.  ``REPRO_FAULTS`` (a JSON list of
``resilience.faults`` specs) arms fault drills:

    REPRO_FAULTS='[{"kind": "nonfinite", "point": "train_step", "step": 2}]' \
        python -m repro_torch.launch.train --device cpu --reduced --steps 4

Telemetry: ``--metrics_out`` writes JSONL records (a ``train_step`` record
a step with its wall time, the MoE counters and the collective bytes the
step issued, and every resilience and replan event), ``--trace`` a Chrome
trace of the host spans (``train_step``, ``ckpt_save``, ...).  With either,
each step is synchronized so its wall time is real.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.balance import MoEMetrics
from repro_torch.core.dispatch import expert_capacity
from repro_torch.core import fmoe
from repro_torch.core.fmoe import expert_seed
from repro_torch.core.gate import EXPLORING, ROUTERS
from repro_torch.core.monitor import LoadMonitor
from repro_torch.core.sync import sync_grads
from repro_torch.data import SyntheticLM
from repro_torch.device import resolve
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.launch.sharding import make_layout
from repro_torch.models import lm
from repro_torch.obs import JsonlSink, StepStats
from repro_torch.obs import events as obs_events
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.resilience import (CheckpointManager, StepGuard,
                                    TrainingAborted, faults)
from repro_torch.placement import (PlacementController, ReplanProbation,
                                   load_calibration, migrate)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_rows(tokens: torch.Tensor, dist) -> torch.Tensor:
    """This rank's contiguous block of the global batch's rows over
    ``dist.token_axes``: with ("data", "model") the rank's own block, with
    ("data",) its data coordinate's (the same on every model rank), with
    () every row."""
    mesh = dist.mesh
    n = mesh.axes_size(dist.token_axes)
    if tokens.shape[0] % n:
        raise ValueError(f"batch {tokens.shape[0]} does not split over "
                         f"{n} ranks of {dist.token_axes}")
    i = 0  # the rank's index over the token axes, in mesh order
    for a, c in zip(mesh.axis_names, mesh.coords()):
        if a in dist.token_axes:
            i = i * mesh.shape[a] + c
    b = tokens.shape[0] // n
    return tokens[i * b:(i + 1) * b]


def _mean_over_ranks(t: torch.Tensor, mesh) -> torch.Tensor:
    t = t.clone()
    comm.all_reduce_(t, mesh.group(mesh.axis_names))
    return t / mesh.size


def loss_and_grads(params, cfg: ModelConfig, batch: dict, *,
                   impl: str = "einsum", device="cuda", timings=None,
                   dist=None, router_seed: int | None = None):
    """(loss, aux, grads): ``lm.loss_fn`` and its gradient with respect to
    every param leaf (a tree like ``params``; zeros for a leaf the loss
    does not reach, as ``jax.grad`` gives: the frozen router's ``w``).  A ``timings`` dict, when
    given, gains the forward and backward seconds (``fwd_s``, ``bwd_s``),
    each taken after a device synchronize.  With ``dist``, ``batch`` holds
    this rank's rows and the loss and grads are the rank's own, unsynced
    (``core.sync.sync_grads``), the params its shards under the train
    layout (:func:`train_dist`).  ``router_seed``: ``lm.forward``'s."""
    dev = resolve(device)
    dist = train_dist(cfg, dist)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    t0 = time.perf_counter()
    loss, aux = lm.loss_fn(params, cfg, batch, impl=impl, device=dev,
                           dist=dist, router_seed=router_seed)
    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
        timings["fwd_s"] = timings.get("fwd_s", 0.0) + t1 - t0
    flat = torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)
    if timings is not None:
        _sync(dev)
        timings["bwd_s"] = timings.get("bwd_s", 0.0) + time.perf_counter() - t1
    it = iter(flat)
    grads = tree_map(lambda _: next(it), params)
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, grads


def train_dist(cfg: ModelConfig, dist):
    """``dist`` for training: on a mesh the params and AdamW moments are
    held in the train layout (``launch.sharding.make_layout(cfg, mesh,
    "train")``, the reference's ``jit_train_step``), so a ``dist`` without
    a layout takes it (``DistConfig.with_layout``); one with a layout, or
    without a mesh, stays as it is."""
    if dist is None or dist.mesh is None or dist.layout is not None:
        return dist
    return dist.with_layout(make_layout(cfg, dist.mesh, "train"))


def moe_dist(cfg: ModelConfig, mesh, num_rows: int, *, layout=None,
             **opts):
    """``core.fmoe.moe_dist`` for training: under ``layout``, by default
    the train layout of ``cfg`` on ``mesh`` (:func:`train_dist`)."""
    return train_dist(cfg, fmoe.moe_dist(cfg, mesh, num_rows, layout=layout,
                                         **opts))


def make_train_step(cfg: ModelConfig, opt: AdamW, *, dist=None,
                    num_microbatches: int = 1, warmup: int = 100,
                    total_steps: int = 10000, impl: str = "einsum",
                    device="cuda"):
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    ``impl`` picks the expert kernels (einsum | pallas | fused).  Params and
    the optimizer state are updated in place.  The step also takes
    ``timings=``, a dict that gains ``fwd_s``, ``bwd_s`` and ``opt_s``.

    ``dist`` (:func:`moe_dist`) runs expert parallelism: every rank is
    given the global batch and takes its rows over ``dist.token_axes``,
    its params are its shards under the train layout (:func:`train_dist`;
    ``lm.init_params(layout=dist.layout)``), the gradients are synced as
    FastMoE does (``core.sync.sync_grads``) before AdamW, and the metrics
    are the means over the ranks.

    The exploration routers (noisy_topk, gumbel) draw their noise from
    ``expert_seed(17, step, microbatch)`` (per layer from that,
    ``lm.forward``): deterministic and the same on a resumed run; every
    other router runs without a draw."""
    dev = resolve(device)
    dist = train_dist(cfg, dist)
    mesh = dist.mesh if dist is not None else None
    explore = cfg.moe is not None and cfg.moe.router in EXPLORING

    def train_step(params, opt_state, batch, step, *, timings=None):
        tokens = torch.as_tensor(batch["tokens"])
        if mesh is not None:
            tokens = _rank_rows(tokens, dist)
        if tokens.shape[0] % num_microbatches:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{num_microbatches} equal microbatches")
        micro = tokens.reshape(num_microbatches, -1, *tokens.shape[1:])
        grads = loss = aux = None
        for j, mb in enumerate(micro):
            seed = expert_seed(17, step, j) if explore else None
            l, a, g = loss_and_grads(params, cfg, {"tokens": mb}, impl=impl,
                                     device=dev, timings=timings, dist=dist,
                                     router_seed=seed)
            if grads is None:
                grads, loss, aux = g, l, a
            else:
                for acc, new in zip(tree_leaves(grads), tree_leaves(g)):
                    acc.add_(new)
                loss = loss + l
                aux = {k: aux[k] + a[k] for k in aux}
        if num_microbatches > 1:
            inv = 1.0 / num_microbatches
            for g in tree_leaves(grads):
                g.mul_(inv)
            loss, aux = loss * inv, {k: v * inv for k, v in aux.items()}
        t0 = time.perf_counter()
        if mesh is not None:
            sync_grads(grads, dist)
            loss = _mean_over_ranks(loss, mesh)
            aux["ce"] = _mean_over_ranks(aux["ce"], mesh)
        lr_scale = warmup_cosine(step, warmup=warmup, total=total_steps)
        params, opt_state, gnorm = opt.update(grads, opt_state, params,
                                              lr_scale=lr_scale, dist=dist)
        if timings is not None:
            _sync(dev)
            timings["opt_s"] = timings.get("opt_s", 0.0) + time.perf_counter() - t0
        return params, opt_state, {"loss": loss, "grad_norm": gnorm,
                                   "lr_scale": lr_scale, **aux}

    return train_step


def build_train_step(cfg: ModelConfig, opt: AdamW, mesh, global_batch: int,
                     seq_len: int, *, num_microbatches: int = 1,
                     opts: dict | None = None, placement=None):
    """The train step for ``mesh`` under ``placement`` (the reference's
    ``jit_train_step``, which re-jits; here the step is rebuilt).

    ``opts``: ``moe_dist``'s options (``overlap_chunks``, ``wire_dtype``,
    ``ragged_bound`` ("auto" calibrates from ``load_monitor``),
    ``inter_bound``, ``expert_tp``, ``load_monitor``, ``layout``: the
    params' ``launch.sharding.Layout``, by default the train layout) and
    the step's ``impl`` and ``device``.  Returns (step_fn, dist)."""
    opts = dict(opts or {})
    impl = opts.pop("impl", "einsum")
    device = opts.pop("device", "cuda")
    dist = moe_dist(cfg, mesh, global_batch, seq_len=seq_len,
                    placement=placement, **opts)
    return make_train_step(cfg, opt, dist=dist,
                           num_microbatches=num_microbatches, impl=impl,
                           device=device), dist


class ReplanHook:
    """Closes the load-balance loop: LoadMonitor -> PlacementController ->
    migrate the params and AdamW state -> rebuild the train step under the
    new layout.

    Call :meth:`observe` every step with the step's metrics; when the
    controller decides a placement pays for its migration, the hook
    permutes the live trees (in place, one leaf at a time; across the
    ranks over the expert axes) and returns the rebuilt step.  The monitor
    takes the loads every ``sync_every`` steps (one host transfer then).

    Rollback: every accepted replan opens a probation window
    (:class:`~repro_torch.placement.ReplanProbation`).  If the loss or the
    drop fraction after it regresses against the EMAs from before it, the
    migration is inverted, the step rebuilt under the old plan, and the
    plan blacklisted in the controller.  No replan is taken while a
    probation is open.  ``rollback=False`` opts out; ``probation`` is the
    window in steps (default a quarter of ``every``, within 4-64), judged
    at ``probation_loss_tol`` and ``probation_drop_tol``.  ``sink``: the
    telemetry sink, which takes the monitor's sampled snapshots, the
    probation's verdicts and a record per replan.

    ``opts``: :func:`build_train_step`'s; with ``ragged_bound="auto"`` the
    caller puts ``load_monitor=hook.monitor`` in the same dict, so every
    rebuild re-sizes the bounds."""

    def __init__(self, cfg: ModelConfig, opt: AdamW, mesh, global_batch: int,
                 seq_len: int, *, every: int = 200,
                 num_microbatches: int = 1, opts: dict | None = None,
                 per_layer: bool = False, sink=None, rollback: bool = True,
                 probation: int | None = None,
                 probation_loss_tol: float = 1.05,
                 probation_drop_tol: float = 0.05):
        self.cfg, self.opt, self.mesh = cfg, opt, mesh
        self.global_batch, self.seq_len = global_batch, seq_len
        self.num_microbatches = num_microbatches
        self.opts = opts if opts is not None else {}
        # every rebuild holds the params in one layout
        self.opts.setdefault("layout", make_layout(cfg, mesh, "train"))
        self.per_layer = per_layer
        moe = cfg.moe
        # as the reference's: the hook replans only in the a2a mode (the
        # psum mode runs a given plan; serving replans it,
        # launch/scheduler.ServeReplanHook)
        probe = fmoe.moe_dist(cfg, mesh, global_batch)
        self.enabled = probe is not None and probe.mode == "a2a"
        ranks = probe.expert_parallelism if self.enabled else 1
        # the tokens one gate sees: the rank's rows of a microbatch
        t_local = max(1, global_batch * seq_len // mesh.size
                      // num_microbatches)
        cap = expert_capacity(t_local, moe.num_experts, moe.top_k,
                              moe.capacity_factor)
        L = cfg.num_layers if per_layer else 0
        self.sink = sink
        # the loads arrive sampled (every sync_every steps): record each
        self.monitor = LoadMonitor(moe.num_experts, num_layers=L, sink=sink,
                                   record_every=1 if sink is not None else 0)
        wire_bytes = 2 if self.opts.get("wire_dtype") == "bf16" else 4
        self.controller = PlacementController(
            self.monitor, ranks, d_model=cfg.d_model,
            d_hidden=moe.d_expert_hidden, capacity=cap,
            capacity_factor=moe.capacity_factor,
            every=every if self.enabled else 0, bytes_per_elem=wire_bytes,
            num_layers=L, constants=load_calibration())
        self.sync_every = max(1, every // 16)
        self.probation = (ReplanProbation(
            window=probation if probation else max(4, min(64, every // 4)),
            loss_tol=probation_loss_tol, drop_tol=probation_drop_tol,
            sink=sink) if rollback else None)
        # the host-side loss and drop EMAs: the baselines probation judges
        self._loss_ema: float | None = None
        self._drop_ema: float | None = None

    @property
    def placement(self):
        return self.controller.current

    def build(self, placement=None):
        """The train step under ``placement`` (default: the current)."""
        return build_train_step(
            self.cfg, self.opt, self.mesh, self.global_batch, self.seq_len,
            num_microbatches=self.num_microbatches, opts=self.opts,
            placement=self.placement if placement is None else placement)[0]

    def _switch(self, old, new, params, opt_state):
        """Permute the live state from ``old``'s physical order into
        ``new``'s and rebuild the step under ``new`` (replan and rollback
        alike)."""
        for tree in (params, opt_state.mu, opt_state.nu):
            migrate(tree, old, new, mesh=self.mesh)
        return params, opt_state, self.build(new)

    def observe(self, step: int, metrics: dict, params, opt_state, *,
                loss: float | None = None, drop: float | None = None):
        """Returns (params, opt_state, the rebuilt step or None).  ``loss``
        and ``drop`` are the step's host scalars where the caller has them,
        else they are read from ``metrics``; they feed the probation."""
        if (self.per_layer and self.controller.every
                and "load_layers" not in metrics and "load" in metrics):
            raise ValueError(
                "ReplanHook(per_layer=True) needs metrics['load_layers'] "
                "(the (L, E) stack loss_fn returns); got only 'load'")
        if loss is None and "loss" in metrics:
            loss = float(metrics["loss"])
        if drop is None and "drop_frac" in metrics:
            drop = float(metrics["drop_frac"])
        ema = lambda old, v: v if old is None else 0.9 * old + 0.1 * v
        if loss is not None:
            self._loss_ema = ema(self._loss_ema, loss)
        if drop is not None:
            self._drop_ema = ema(self._drop_ema, drop)
        load_key = "load_layers" if self.per_layer else "load"
        if (load_key in metrics and self.controller.every
                and step % self.sync_every == 0):
            self.monitor.update(MoEMetrics(
                0.0, 0.0, _host(metrics[load_key]),
                _host(metrics.get("drop_frac", 0.0))))
        if self.probation is not None and self.probation.active:
            decision = self.probation.observe(step, loss=loss, drop=drop)
            if decision.rollback:
                params, opt_state, step_fn = self._switch(
                    decision.new_plan, decision.old_plan, params, opt_state)
                self.controller.rollback(decision.old_plan, decision.new_plan)
                if self.mesh.rank == 0:
                    print(f"step {step:5d} replan ROLLBACK: {decision.reason} "
                          f"(plan blacklisted)", flush=True)
                return params, opt_state, step_fn
            if self.probation.active:  # still on probation: no replan
                return params, opt_state, None
        old = self.controller.current
        new = self.controller.maybe_replan(step)
        if new is None:
            return params, opt_state, None
        params, opt_state, step_fn = self._switch(old, new, params, opt_state)
        if self.probation is not None:
            # a replan must not introduce drops, even where none were seen
            self.probation.start(
                step, old, new, baseline_loss=self._loss_ema,
                baseline_drop=self._drop_ema if self._drop_ema is not None
                else 0.0)
        if self.sink is not None:
            self.sink.emit({"kind": "replan", "step": step,
                            "num_shadow": int(new.num_shadow),
                            "capacity_scale": float(new.capacity_scale),
                            "imbalance": self.monitor.imbalance})
        return params, opt_state, step_fn


def _host(v):
    """A metric as host numpy (one device transfer)."""
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="fastmoe-gpt")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced CPU-scale variant")
    ap.add_argument("--num_layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = the config's)")
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--impl", default="fused",
                    choices=["einsum", "pallas", "fused"])
    ap.add_argument("--dispatch", default="", choices=["", "capacity", "ragged"],
                    help="override the MoE dispatch mode")
    ap.add_argument("--router", default="", choices=["", *ROUTERS],
                    help="override the MoE routing variant")
    ap.add_argument("--freeze_router_at", type=int, default=0,
                    help="StableMoE's second stage: at this step the "
                         "distilled router w_frozen takes over the routing "
                         "(needs --router noisy_topk or gumbel)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="DATAxMODEL or DATAxNODExMODEL expert parallelism, "
                         "one rank a process (run under torchrun)")
    ap.add_argument("--overlap_chunks", type=int, default=0,
                    help="§5.2 pipelined exchange micro-shards (0/1 = serial)")
    ap.add_argument("--wire_dtype", default="", choices=["", "bf16"],
                    help="exchange payload dtype across the wire")
    ap.add_argument("--ragged_bound", default="0",
                    help="rows per peer shard of the ragged exchange "
                         "(0 = never drop; 'auto' = from the load monitor's "
                         "EMAs at every replan rebuild, needs "
                         "--replan_every)")
    ap.add_argument("--replan_every", type=int, default=0,
                    help="steps between expert-placement replans (0 = off; "
                         "needs --mesh and the a2a mode)")
    ap.add_argument("--per_layer_plans", action="store_true",
                    help="plan the placement per layer, each from its own "
                         "load (needs --replan_every)")
    ap.add_argument("--inter_bound", type=int, default=0,
                    help="rows per slim inter-node shard (0 = never drop)")
    ap.add_argument("--ckpt_dir", default="",
                    help="checkpoint root: atomic verified checkpoints in "
                         "step_<N>/ dirs (the state after step N, in logical "
                         "expert order whatever the live placement)")
    ap.add_argument("--save_every", type=int, default=0,
                    help="checkpoint every N completed steps (0 = only the "
                         "final save; needs --ckpt_dir)")
    ap.add_argument("--keep_ckpts", type=int, default=3,
                    help="retention: newest complete checkpoints kept by GC")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint under --ckpt_dir "
                         "that verifies (corrupt ones are skipped) and "
                         "continue from its step; the data stream replays "
                         "so the run matches an uninterrupted one")
    ap.add_argument("--max_bad_steps", type=int, default=3,
                    help="step guard: tolerated consecutive non-finite "
                         "steps (each skipped and retried from the last "
                         "good snapshot; more abort; 0 disables the guard "
                         "and its per-step host read)")
    ap.add_argument("--snapshot_every", type=int, default=1,
                    help="guard snapshot cadence (1 = copy the params and "
                         "AdamW state to host memory after every good step; "
                         "higher amortizes the copy and replays more)")
    ap.add_argument("--drop_spike", type=float, default=0.25,
                    help="guard: a drop fraction above this for "
                         "--drop_patience consecutive steps rebuilds the "
                         "step with the dropless ragged bound")
    ap.add_argument("--drop_patience", type=int, default=4)
    ap.add_argument("--metrics_out", default="",
                    help="write telemetry records (JSONL): per step the wall "
                         "time, the MoE wire/drop/shadow counters and the "
                         "collective bytes issued, monitor snapshots, "
                         "replans and the resilience events (faults, guard "
                         "skips and restores, checkpoints, resumes)")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace (chrome://tracing, perfetto) "
                         "of the host spans: train_step, ckpt_save, ...")
    args = ap.parse_args(argv)
    if args.ragged_bound == "auto" and not args.replan_every:
        raise SystemExit("--ragged_bound auto calibrates from the load "
                         "monitor: it needs --replan_every")
    if (args.replan_every or args.per_layer_plans) and not args.mesh:
        raise SystemExit("--replan_every / --per_layer_plans need --mesh")
    if args.per_layer_plans and not args.replan_every:
        raise SystemExit("--per_layer_plans needs --replan_every")
    if not args.mesh:
        return _run(args, resolve(args.device), None)
    dims = [int(v) for v in args.mesh.lower().split("x")]
    if len(dims) not in (2, 3):
        raise ValueError(f"--mesh {args.mesh}: DxM or DxNxM")
    data, model, node = dims[0], dims[-1], dims[1] if len(dims) == 3 else 1
    dev = init_distributed(args.device)
    try:
        _run(args, dev, make_local_mesh(data, model, node))
    finally:
        torch.distributed.destroy_process_group()


def _host_floats(*values) -> list:
    """Scalars (tensors or floats) as host floats, in one transfer."""
    ts = [v for v in values if isinstance(v, torch.Tensor)]
    got = iter(torch.stack([t.detach().float().reshape(()) for t in ts])
               .tolist() if ts else ())
    return [next(got) if isinstance(v, torch.Tensor) else float(v)
            for v in values]


STEP_COUNTERS = ("loss", "drop_frac", *lm.COUNTER_KEYS)


def _run(args, dev: torch.device, mesh) -> None:
    lead = mesh is None or mesh.rank == 0
    # one sink (rank 0's): every rank takes the same decisions
    sink = JsonlSink(args.metrics_out) if args.metrics_out and lead else None
    if args.trace:
        obs_trace.configure(enabled=True)
    faults.arm_from_env()  # REPRO_FAULTS drills
    faults.set_sink(sink)
    try:
        _train(args, dev, mesh, sink)
    finally:
        faults.set_sink(None)
        if sink is not None:
            sink.close()
    if lead and sink is not None:
        print(f"metrics written to {args.metrics_out}", flush=True)
    if lead and args.trace:
        obs_trace.export(args.trace)
        print(f"trace written to {args.trace}", flush=True)


def _train(args, dev: torch.device, mesh, sink) -> None:
    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    lm.check_tokens_only(cfg)
    if args.reduced:
        cfg = reduced(cfg, num_layers=4, d_model=256)
    if args.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    if args.dispatch and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.dispatch))
    if args.router and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, router=args.router))
    if args.freeze_router_at and (cfg.moe is None
                                  or cfg.moe.router not in EXPLORING):
        raise SystemExit("--freeze_router_at needs a distilling router "
                         "(--router noisy_topk or gumbel) so params carry "
                         "w_frozen")
    opt = AdamW(lr=args.lr)
    hook = None
    opts = dict(impl=args.impl, device=dev)
    if mesh is not None:
        # a rank takes whole sequences, so the mode follows the row count:
        # rows that split over every rank exchange tokens (a2a), others
        # fall back to the psum mode
        rb = args.ragged_bound
        opts.update(overlap_chunks=args.overlap_chunks,
                    wire_dtype=args.wire_dtype or None,
                    ragged_bound=rb if rb == "auto" else int(rb),
                    inter_bound=args.inter_bound,
                    layout=make_layout(cfg, mesh, "train"))
        if args.replan_every and cfg.moe is not None:
            hook = ReplanHook(cfg, opt, mesh, args.batch, args.seq,
                              every=args.replan_every,
                              num_microbatches=args.microbatches, opts=opts,
                              per_layer=args.per_layer_plans, sink=sink)
            if not hook.enabled:
                if lead:
                    print("replan disabled: placement needs the a2a expert "
                          "path", flush=True)
                hook = None
            else:
                # ragged_bound=auto: every rebuild re-sizes from the monitor
                opts["load_monitor"] = hook.monitor

    def placement():
        return hook.placement if hook is not None else None

    def build(cfg):  # every rebuild keeps the live placement
        if mesh is None:
            return make_train_step(cfg, opt, num_microbatches=args.microbatches,
                                   impl=args.impl, device=dev), None
        return build_train_step(
            cfg, opt, mesh, args.batch, args.seq,
            num_microbatches=args.microbatches, opts=opts,
            placement=placement())
    step_fn, dist = build(cfg)
    if mesh is not None and dist is None:
        raise ValueError(f"{cfg.name}: {cfg.moe.num_experts if cfg.moe else 0}"
                         f" experts do not split over the expert axes of "
                         f"{args.mesh}, and data parallelism without "
                         f"experts is not ported")
    # each rank makes its own shard of the train layout from the seed
    layout = opts.get("layout")
    params = lm.init_params(cfg, seed=args.seed, device=dev,
                            param_dtype=cfg.param_dtype, layout=layout)
    if lead and dist is not None:
        auto = (f", ragged bound {dist.ragged_bound}"
                if args.ragged_bound == "auto" else "")
        print(f"mesh {args.mesh} ({dist.mode} over {dist.token_axes}{auto})",
              flush=True)
    opt_state = opt.init(params)

    # -- resilience: checkpoints, auto-resume and the step guard -----------
    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(
            args.ckpt_dir, save_every=args.save_every, keep=args.keep_ckpts,
            sink=sink, layout=layout)
    start_step = 0
    if args.resume and manager is not None:
        # checkpoints are in logical order and a fresh run starts on the
        # identity placement: no placement on the restore side
        res = manager.restore_latest({"params": params, "opt": opt_state},
                                     inplace=True)
        if res is not None:
            tree, last = res
            params, opt_state = tree["params"], tree["opt"]
            start_step = last + 1
            if lead:
                print(f"resumed from step {last} ({manager.step_dir(last)}); "
                      f"continuing at {start_step}", flush=True)
        elif lead:
            print(f"no restorable checkpoint under {args.ckpt_dir}; "
                  f"starting fresh", flush=True)
    guard = None
    if args.max_bad_steps > 0:
        guard = StepGuard(max_bad_steps=args.max_bad_steps,
                          drop_threshold=args.drop_spike,
                          drop_patience=args.drop_patience,
                          snapshot_every=args.snapshot_every, sink=sink)
    telemetry = sink is not None or obs_trace.enabled()
    batches = SyntheticLM(cfg.vocab_size, args.seq, seed=args.seed).batches(
        args.batch)
    for _ in range(start_step):  # deterministic resume: replay the stream
        next(batches)
    if guard is not None:  # a seed snapshot: step 0 itself may go bad
        guard.commit(start_step - 1, params, opt_state)
    t0 = time.time()
    tw, since = time.perf_counter(), 0  # the window since the last log line
    step = start_step
    try:
        while step < args.steps:
            batch = {"tokens": torch.from_numpy(next(batches)["tokens"]).to(dev)}
            if (args.freeze_router_at and step >= args.freeze_router_at
                    and cfg.moe.router != "frozen"):
                # StableMoE stage 2: route through w_frozen from here on, a
                # config flip (the params already carry the distilled
                # router); the step is rebuilt under the live placement
                cfg = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, router="frozen"))
                step_fn, _ = build(cfg)
                if hook is not None:
                    hook.cfg = cfg  # later rebuilds keep the frozen gate
                obs_events.emit(sink, obs_events.ROUTER_FROZEN, step=step)
                if lead:
                    print(f"step {step:5d} router frozen: gate-id tables are "
                          f"now stable", flush=True)
            loss = drop = None
            while True:  # the retry loop, bounded by the guard
                ts = time.perf_counter()
                comm.tally_reset()
                with obs_trace.span("train_step", step=step):
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch, step)
                    if telemetry:  # real wall times: don't run ahead
                        _sync(dev)
                wall = time.perf_counter() - ts
                modeled = comm.tallied()
                params, opt_state, metrics = faults.apply_step(
                    params, opt_state, metrics, step=step)
                if guard is None:
                    verdict = None
                    break
                loss, gnorm, drop = _host_floats(
                    metrics["loss"], metrics["grad_norm"],
                    metrics.get("drop_frac", 0.0))
                verdict = guard.check(step, loss=loss, grad_norm=gnorm,
                                      drop=drop)
                if verdict.ok:
                    break
                # a non-finite step: its state is poisoned; reinstate the
                # last good snapshot and retry this batch
                params, opt_state = guard.restore()
                if lead:
                    print(f"step {step:5d} non-finite ({verdict.reason}); "
                          f"restored step-{guard.snapshot_step} state, "
                          f"retrying", flush=True)
            if verdict is not None and verdict.fallback_dropless:
                applied = False
                if mesh is not None and opts.get("ragged_bound") not in (0, None):
                    opts["ragged_bound"] = 0  # never-dropping shards
                    mon = opts.get("load_monitor")
                    if mon is not None:  # keep auto mode from re-shrinking
                        mon.force_dropless = True
                    step_fn, _ = build(cfg)
                    applied = True
                obs_events.emit(sink, obs_events.DROP_FALLBACK, step=step,
                                applied=applied)
                if lead:
                    print(f"step {step:5d} sustained drop spike: "
                          + ("forced dropless ragged bound" if applied else
                             "no bounded ragged exchange active (event only)"),
                          flush=True)
            if sink is not None:
                keys = [k for k in STEP_COUNTERS if k in metrics]
                counters = dict(zip(keys, _host_floats(
                    *(metrics[k] for k in keys))))
                sink.emit(StepStats("train_step", step, wall,
                                    counters=counters,
                                    modeled=modeled).record())
            new_fn = None
            if hook is not None:
                params, opt_state, new_fn = hook.observe(
                    step, metrics, params, opt_state, loss=loss, drop=drop)
                if new_fn is not None:
                    step_fn = new_fn
                    p = hook.placement
                    if lead:
                        print(f"step {step:5d} replan: shadow={p.num_shadow} "
                              f"cap_scale={p.capacity_scale:.2f} "
                              f"imbalance={hook.monitor.imbalance:.2f}",
                              flush=True)
            if guard is not None:
                # after the hook, so the snapshot is in the live layout;
                # forced after a migration for the same reason
                guard.commit(step, params, opt_state, force=new_fn is not None)
            if manager is not None:
                manager.maybe_save(step, {"params": params, "opt": opt_state},
                                   placement=placement())
            since += 1
            if lead and step % args.log_every == 0:
                # the mean wall ms of the steps since the last line: the
                # host floats below wait for the card to finish them all
                lossf, gnorm = _host_floats(metrics["loss"],
                                            metrics["grad_norm"])
                now = time.perf_counter()
                print(f"step {step:5d} loss {lossf:.4f} gnorm {gnorm:.3f} "
                      f"({time.time() - t0:.1f}s, "
                      f"{(now - tw) * 1e3 / since:.1f} ms/step)", flush=True)
                tw, since = now, 0
            step += 1
    except TrainingAborted as e:
        # persist the last good state so --resume can pick the run up
        # (a snapshot before start_step is only the seed: nothing done)
        if (manager is not None and guard is not None
                and guard.snapshot_step is not None
                and guard.snapshot_step >= start_step):
            p_good, o_good = guard.load_snapshot()
            manager.save(guard.snapshot_step, {"params": p_good, "opt": o_good},
                         placement=placement())
        if lead:
            print(f"aborted: {e}", flush=True)
        raise SystemExit(1)
    if manager is not None and step > start_step:
        # a final save, so a finished run can always be resumed or extended
        manager.maybe_save(step - 1, {"params": params, "opt": opt_state},
                           placement=placement(), force=True)
    if lead:
        if hook is not None:
            c = hook.controller
            print(f"placement: {c.replans} replans, {c.rollbacks} rollbacks, "
                  f"{c.flat_skips} flat skips", flush=True)
        print(f"done: {args.steps} steps in {time.time() - t0:.1f}s",
              flush=True)


if __name__ == "__main__":
    main()
