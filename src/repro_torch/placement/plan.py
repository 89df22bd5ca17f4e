"""Expert placement plans: turning measured load into an executable
layout (the reference's ``placement/plan.py``).

From a :class:`repro_torch.core.monitor.LoadMonitor` load vector, compute
an :class:`ExpertPlacement` that

* permutes logical experts into a *physical* order so each rank owns a
  load-balanced contiguous block (the greedy placer of ``core/monitor``);
* marks the hottest experts as **shadowed**: replicated on every rank,
  computed locally, and skipped in the exchanged payload
  (``placement/shadow.py``);
* optionally shrinks the exchange's capacity buffer to the residual
  (non-shadow) load peak.

The shadow set is chosen by a roofline cost model
(:class:`~repro_torch.placement.calibrate.CostConstants`, the card's own
numbers by default): exchange bytes saved per step against the cost of
keeping the replicas in sync (their gradients' all-reduce, a broadcast per
replan, the extra HBM reads).

Routing is unchanged: the router still scores *logical* experts, and
``logical_to_physical`` is the table the gate's ids go through
(``core/fmoe``); ``placement/migrate.py`` moves params and optimizer
state between layouts.  Given the same load and the same explicit
constants, every function returns the reference's plan and costs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.monitor import expert_placement as greedy_placement
from repro_torch.placement.calibrate import CostConstants


def _round8(n: float) -> int:
    return max(8, int(-(-int(n) // 8) * 8))


class ExpertPlacement(NamedTuple):
    """A physical expert layout for ``num_ranks`` expert-parallel ranks.

    Physical slots ``[0, E - num_shadow)`` are owned experts, laid out as
    contiguous per-rank blocks of ``(E - num_shadow) // num_ranks``; slots
    ``[E - num_shadow, E)`` are shadowed (replicated on every rank, hottest
    first).  ``num_shadow`` is always a multiple of ``num_ranks`` so the
    owned block stays divisible for the all-to-all reshape.
    """

    num_experts: int
    num_ranks: int
    physical_to_logical: tuple  # len E — logical expert in each physical slot
    num_shadow: int = 0
    capacity_scale: float = 1.0  # a2a buffer capacity multiplier (<= 1)

    @property
    def num_owned(self) -> int:
        return self.num_experts - self.num_shadow

    @property
    def logical_to_physical(self) -> np.ndarray:
        l2p = np.empty(self.num_experts, np.int32)
        l2p[np.asarray(self.physical_to_logical, np.int32)] = np.arange(
            self.num_experts, dtype=np.int32)
        return l2p

    @property
    def expert_to_rank(self) -> np.ndarray:
        """Owning rank per *logical* expert; -1 for shadowed (all ranks)."""
        per_rank = self.num_owned // self.num_ranks
        rank_of_phys = np.full(self.num_experts, -1, np.int32)
        rank_of_phys[:self.num_owned] = (
            np.arange(self.num_owned, dtype=np.int32) // per_rank)
        return rank_of_phys[self.logical_to_physical]

    @property
    def replication(self) -> np.ndarray:
        """Replication degree per logical expert (1 owned, num_ranks shadow)."""
        rep = np.where(self.expert_to_rank < 0, self.num_ranks, 1)
        return rep.astype(np.int32)

    @property
    def is_identity(self) -> bool:
        return (self.num_shadow == 0 and self.capacity_scale == 1.0
                and list(self.physical_to_logical)
                == list(range(self.num_experts)))

    def main_capacity(self, capacity: int) -> int:
        """a2a buffer capacity after the planner's shrink (multiple of 8)."""
        if self.capacity_scale >= 1.0:
            return capacity
        return min(capacity, _round8(capacity * self.capacity_scale))


def identity_placement(num_experts: int, num_ranks: int) -> ExpertPlacement:
    """The seed layout: logical == physical, contiguous blocks, no shadows."""
    return ExpertPlacement(num_experts, num_ranks,
                           tuple(range(num_experts)))


class PerLayerPlacement(NamedTuple):
    """One :class:`ExpertPlacement` per MoE layer, sharing a *geometry*.

    Expert load skew is per layer (DeepSpeed's multitask MoE measurements),
    so each layer gets its own permutation and its own shadowed hot set.
    Every layer's plan shares the *geometry* ``(num_experts, num_ranks,
    num_shadow, capacity_scale)`` (the reference's layer scan needs it;
    here it keeps one ``DistConfig`` for the stack), while each layer's
    logical->physical table is threaded to its MoE layer
    (``models/lm.py``).  ``migrate.py`` permutes each layer's expert
    leaves with that layer's table.
    """

    layers: tuple  # tuple[ExpertPlacement, ...], geometry-identical

    def validate(self) -> "PerLayerPlacement":
        if not self.layers:
            raise ValueError("PerLayerPlacement needs at least one layer")
        g = self.layers[0]
        for i, p in enumerate(self.layers):
            if ((p.num_experts, p.num_ranks, p.num_shadow, p.capacity_scale)
                    != (g.num_experts, g.num_ranks, g.num_shadow,
                        g.capacity_scale)):
                raise ValueError(
                    f"layer {i} geometry {p[:2] + p[3:]} differs from layer 0 "
                    f"{g[:2] + g[3:]} — scan needs one shared geometry")
        return self

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def num_experts(self) -> int:
        return self.layers[0].num_experts

    @property
    def num_ranks(self) -> int:
        return self.layers[0].num_ranks

    @property
    def num_shadow(self) -> int:
        return self.layers[0].num_shadow

    @property
    def num_owned(self) -> int:
        return self.layers[0].num_owned

    @property
    def capacity_scale(self) -> float:
        return self.layers[0].capacity_scale

    @property
    def geometry(self) -> ExpertPlacement:
        """A representative single-layer plan carrying the shared geometry
        (what ``DistConfig.placement`` holds inside the layer loop)."""
        return self.layers[0]

    @property
    def is_identity(self) -> bool:
        return all(p.is_identity for p in self.layers)

    @property
    def logical_to_physical(self) -> np.ndarray:
        """(L, E) stacked gate-id tables (one row per layer)."""
        return np.stack([p.logical_to_physical for p in self.layers])

    @property
    def physical_to_logical(self) -> np.ndarray:
        return np.stack([np.asarray(p.physical_to_logical, np.int32)
                         for p in self.layers])

    def layer(self, i: int) -> ExpertPlacement:
        return self.layers[i]


def per_layer_placement(layers) -> PerLayerPlacement:
    """Validated constructor for a geometry-shared per-layer plan."""
    return PerLayerPlacement(tuple(layers)).validate()


def identity_per_layer(num_experts: int, num_ranks: int,
                       num_layers: int) -> PerLayerPlacement:
    return PerLayerPlacement(
        (identity_placement(num_experts, num_ranks),) * num_layers)


# ---------------------------------------------------------------------------
# Cost model (seconds per train step)
# ---------------------------------------------------------------------------


class PlacementCost(NamedTuple):
    a2a_s: float  # all-to-all payload time
    sync_s: float  # shadow-weight grad all-reduce + amortized broadcast
    hbm_s: float  # extra HBM reads for replicated shadow weights
    drop_frac: float  # modeled dropped-token fraction (quality proxy)

    @property
    def total_s(self) -> float:
        return self.a2a_s + self.sync_s + self.hbm_s


def placement_cost(place: ExpertPlacement, load: np.ndarray, *,
                   d_model: int, d_hidden: int, capacity: int,
                   capacity_factor: float = 1.0, bytes_per_elem: int = 4,
                   train: bool = True, replan_every: int = 200,
                   constants: Optional[CostConstants] = None) -> PlacementCost:
    """Modeled per-step cost of executing under ``place`` with ``load``.

    a2a term: dispatch + return payload of the *owned* buffer, forward and
    (in training) backward.  sync term: shadow experts become replicated
    parameters, so their grads all-reduce every step and their weights
    broadcast once per replan interval.  hbm term: every rank streams the
    shadow weights in addition to its own shard.

    ``constants`` prices the terms (default: the card's datasheet numbers,
    ``calibrate.CostConstants()``).
    """
    c = constants if constants is not None else CostConstants()
    load = np.asarray(load, np.float64)
    load = load / max(load.sum(), 1e-12)
    E, S = place.num_experts, place.num_shadow
    c_main = place.main_capacity(capacity)
    dirs = 4.0 if train else 2.0  # dispatch+return, x2 for backward
    a2a_bytes = place.num_owned * c_main * d_model * bytes_per_elem
    a2a_s = dirs * a2a_bytes / c.ici_bw

    w_elems = 3 * d_model * d_hidden  # swiglu-shaped expert: 3 projections
    sync_s = 0.0
    hbm_s = 0.0
    if S:
        shadow_w_bytes = S * w_elems * bytes_per_elem
        if train:  # replicated weights => grad all-reduce (2 hops of a ring)
            sync_s += 2.0 * shadow_w_bytes / c.ici_bw
        sync_s += shadow_w_bytes / c.ici_bw / max(replan_every, 1)
        hbm_s += shadow_w_bytes / c.hbm_bw
    # quality proxy: tokens beyond an expert's capacity are dropped.  Owned
    # experts see the (possibly shrunk) a2a capacity; shadowed experts keep
    # the full per-rank buffer.
    owned = place.expert_to_rank >= 0
    caps = np.where(owned, c_main, capacity).astype(np.float64)
    # capacity = cf * t*k / E, so per-rank arrivals to expert e are
    # load_e * t*k = load_e * E * capacity / cf (cf=1 -> conservative)
    per_rank_arrivals = load * capacity * E / max(capacity_factor, 1e-9)
    over = np.maximum(per_rank_arrivals - caps, 0.0).sum()
    drop = float(over / max(per_rank_arrivals.sum(), 1e-12))
    # no peak_flops charge: shadow compute per rank replaces the owner's
    # mp-fanned buffer rows one-for-one (E*C slots per rank either way), so
    # the FLOP term cancels; c.peak_flops is there for future cost models.
    return PlacementCost(a2a_s, sync_s, hbm_s, drop)


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


def _residual_scale(load: np.ndarray, owned: np.ndarray, capacity: int) -> float:
    """Capacity multiplier covering the residual (non-shadow) load peak.

    Baseline C is capacity_factor x the fair share 1/E, so an expert at load
    fraction f needs f*E*C slots for the same headroom; size the a2a buffer
    to the residual peak.
    """
    E = load.size
    f_max = float(load[owned].max()) if owned.size else 0.0
    return min(1.0, max(f_max * E, 8.0 / max(capacity, 8)))


def _build_plan(load: np.ndarray, num_ranks: int, S: int,
                scale: float) -> ExpertPlacement:
    """Shadow the S hottest experts, greedy-balance the rest into contiguous
    per-rank blocks (the shared build step of both planners)."""
    E = load.size
    hot_first = np.argsort(-load, kind="stable")
    shadow = hot_first[:S]
    owned = np.sort(hot_first[S:])
    # balanced contiguous blocks: greedy-assign owned experts to ranks,
    # then lay each rank's experts out contiguously (physical order)
    ranks = np.asarray(greedy_placement(owned.size, num_ranks,
                                        load[owned]), np.int64)
    phys = [int(e) for r in range(num_ranks)
            for e in owned[ranks == r]]
    phys += [int(e) for e in shadow]
    return ExpertPlacement(E, num_ranks, tuple(phys), int(S), float(scale))


def _norm_load(load: np.ndarray) -> np.ndarray:
    load = np.asarray(load, np.float64)
    return load / max(load.sum(), 1e-12)


def plan_placement(load: np.ndarray, num_ranks: int, *, d_model: int,
                   d_hidden: int, capacity: int, capacity_factor: float = 1.0,
                   bytes_per_elem: int = 4, train: bool = True,
                   replan_every: int = 200, max_shadow_frac: float = 0.5,
                   shrink_capacity: bool = True,
                   constants: Optional[CostConstants] = None) -> ExpertPlacement:
    """Choose shadow set + permutation minimizing the modeled step cost.

    Scans shadow counts S in multiples of ``num_ranks`` (so the owned block
    stays divisible), shadowing the hottest experts first.  For each S the
    a2a capacity may shrink to the residual load peak (no worse drop rate
    than the baseline buffer).  Falls back to a pure load-balancing
    permutation (S=0) when shadowing doesn't pay.
    """
    load = _norm_load(load)
    E = load.size
    if E % num_ranks:
        raise ValueError(f"num_experts {E} not divisible by ranks {num_ranks}")
    hot_first = np.argsort(-load, kind="stable")

    def build(S: int) -> ExpertPlacement:
        scale = 1.0
        if shrink_capacity and S:
            scale = _residual_scale(load, np.sort(hot_first[S:]), capacity)
        return _build_plan(load, num_ranks, S, scale)

    kw = dict(d_model=d_model, d_hidden=d_hidden, capacity=capacity,
              capacity_factor=capacity_factor, bytes_per_elem=bytes_per_elem,
              train=train, replan_every=replan_every, constants=constants)
    base = build(0)
    # drops are a quality regression, not a time cost: never trade them
    base_drop = placement_cost(base, load, **kw).drop_frac
    best, best_cost = None, np.inf
    max_s = int(max_shadow_frac * E) // num_ranks * num_ranks
    for S in range(0, max_s + 1, num_ranks):
        cand = base if S == 0 else build(S)
        cost = placement_cost(cand, load, **kw)
        if cost.drop_frac > base_drop + 1e-9:
            continue
        if cost.total_s < best_cost - 1e-12:
            best, best_cost = cand, cost.total_s
    return best if best is not None else base


def per_layer_cost(plan: PerLayerPlacement, load: np.ndarray,
                   **kw) -> PlacementCost:
    """Summed modeled per-step cost of an (L,)-stacked plan under (L, E) load.

    Each layer's shadow weights are distinct parameters, so the sync and hbm
    terms are charged per layer; the weight-broadcast amortization shares one
    replan interval across the whole stack (``replan_every`` divides each
    layer's broadcast term — a single replan migrates all L layers at once).
    """
    load = np.asarray(load, np.float64)
    if load.ndim != 2 or load.shape[0] != plan.num_layers:
        raise ValueError(f"load shape {load.shape} != (L={plan.num_layers}, E)")
    parts = [placement_cost(p, load[i], **kw)
             for i, p in enumerate(plan.layers)]
    return PlacementCost(sum(p.a2a_s for p in parts),
                         sum(p.sync_s for p in parts),
                         sum(p.hbm_s for p in parts),
                         float(np.mean([p.drop_frac for p in parts])))


def plan_placement_per_layer(load: np.ndarray, num_ranks: int, *,
                             d_model: int, d_hidden: int, capacity: int,
                             capacity_factor: float = 1.0,
                             bytes_per_elem: int = 4, train: bool = True,
                             replan_every: int = 200,
                             max_shadow_frac: float = 0.5,
                             shrink_capacity: bool = True,
                             constants: Optional[CostConstants] = None,
                             ) -> PerLayerPlacement:
    """Per-layer planner: one permutation + shadow *set* per layer, one
    shared geometry.

    The layers share one geometry, so the shadow count S and capacity scale
    are chosen *jointly* — the S minimizing the summed
    per-layer cost (hot layers' a2a savings subsidize cool ones) — while
    each layer independently picks *which* experts to shadow (its own
    hottest) and how to permute the rest (its own greedy balance).  The
    shared capacity scale is the max of the per-layer residual peaks, so no
    layer drops more than it would under the baseline buffer.

    With identical per-layer loads this degenerates to ``plan_placement``
    stacked L times.
    """
    load = np.asarray(load, np.float64)
    if load.ndim != 2:
        raise ValueError(f"per-layer load must be (L, E), got {load.shape}")
    L, E = load.shape
    if E % num_ranks:
        raise ValueError(f"num_experts {E} not divisible by ranks {num_ranks}")
    rows = [_norm_load(load[i]) for i in range(L)]
    hot = [np.argsort(-r, kind="stable") for r in rows]

    def build(S: int) -> PerLayerPlacement:
        scale = 1.0
        if shrink_capacity and S:
            scale = max(_residual_scale(rows[i], np.sort(hot[i][S:]), capacity)
                        for i in range(L))
        return PerLayerPlacement(tuple(
            _build_plan(rows[i], num_ranks, S, scale) for i in range(L)))

    kw = dict(d_model=d_model, d_hidden=d_hidden, capacity=capacity,
              capacity_factor=capacity_factor, bytes_per_elem=bytes_per_elem,
              train=train, replan_every=replan_every, constants=constants)
    base = build(0)
    base_drop = per_layer_cost(base, load, **kw).drop_frac
    best, best_cost = None, np.inf
    max_s = int(max_shadow_frac * E) // num_ranks * num_ranks
    for S in range(0, max_s + 1, num_ranks):
        cand = base if S == 0 else build(S)
        cost = per_layer_cost(cand, load, **kw)
        if cost.drop_frac > base_drop + 1e-9:
            continue
        if cost.total_s < best_cost - 1e-12:
            best, best_cost = cand, cost.total_s
    return (best if best is not None else base).validate()


# ---------------------------------------------------------------------------
# Replan controller (the train.py hook's brain)
# ---------------------------------------------------------------------------


class PlacementController:
    """Periodic replan driver fed by a LoadMonitor.

    Every ``every`` steps, recompute a plan from the monitor's load EMA and
    return it iff the modeled step time improves on the current plan by at
    least ``min_gain`` (relative).  The caller owns executing the migration
    (see migrate.py) and rebuilding the train step.

    ``num_layers > 0`` switches to per-layer mode: plans come from
    :func:`plan_placement_per_layer` fed by the monitor's ``(L, E)``
    layer-load EMA, and ``current`` is a :class:`PerLayerPlacement`.
    """

    def __init__(self, monitor, num_ranks: int, *, d_model: int,
                 d_hidden: int, capacity: int, capacity_factor: float = 1.0,
                 every: int = 200, min_gain: float = 0.02, train: bool = True,
                 shrink_capacity: bool = True, bytes_per_elem: int = 4,
                 num_layers: int = 0, flat_tol: float = 0.02,
                 constants: Optional[CostConstants] = None):
        self.monitor = monitor
        self.num_ranks = num_ranks
        self.every = every
        self.min_gain = min_gain
        self.flat_tol = flat_tol
        self.num_layers = num_layers
        self.constants = constants if constants is not None else CostConstants()
        self.kw = dict(d_model=d_model, d_hidden=d_hidden, capacity=capacity,
                       capacity_factor=capacity_factor, train=train,
                       replan_every=every, shrink_capacity=shrink_capacity,
                       bytes_per_elem=bytes_per_elem, constants=self.constants)
        if num_layers:
            if getattr(monitor, "num_layers", 0) != num_layers:
                raise ValueError(
                    f"per-layer controller ({num_layers} layers) needs a "
                    f"LoadMonitor(num_layers={num_layers})")
            self.current = identity_per_layer(monitor.num_experts, num_ranks,
                                              num_layers)
        else:
            self.current = identity_placement(monitor.num_experts, num_ranks)
        self.replans = 0
        self.rollbacks = 0
        self.flat_skips = 0  # replan ticks short-circuited by flat load
        # plans that regressed after their migration and were rolled back
        # (launch.train.ReplanHook's probation): never proposed again
        self._blacklist: set = set()

    def _cost(self, plan, load) -> float:
        ckw = {k: v for k, v in self.kw.items() if k != "shrink_capacity"}
        if self.num_layers:
            return per_layer_cost(plan, load, **ckw).total_s
        return placement_cost(plan, load, **ckw).total_s

    def blacklist(self, plan) -> None:
        """Bar a plan from ever being proposed again (post-rollback).  Plans
        are NamedTuples of hashables, so the plan itself is the key."""
        self._blacklist.add(plan)

    def rollback(self, to_plan, bad_plan) -> None:
        """Record a probation rollback: the live layout returns to
        ``to_plan`` and ``bad_plan`` joins the blacklist."""
        self.current = to_plan
        self.blacklist(bad_plan)
        self.rollbacks += 1

    def _is_flat(self, load) -> bool:
        """True when every expert's share is within ``flat_tol`` of uniform.

        Expert-choice routing produces exactly this by construction (1/E per
        expert), and well-balanced token-choice gates approach it — either
        way no layout can beat the identity-ish one we already run, so the
        planner short-circuits instead of burning a plan+cost pass."""
        load = np.asarray(load, np.float64)
        rows = load if load.ndim == 2 else load[None, :]
        for row in rows:
            tot = row.sum()
            if tot <= 0:
                return False
            share = row / tot
            if share.max() * row.shape[0] > 1.0 + self.flat_tol:
                return False
        return True

    def maybe_replan(self, step: int):
        """New plan to migrate to, or None to keep the current layout."""
        if self.every <= 0 or step == 0 or step % self.every:
            return None
        if self.num_layers:
            load = self.monitor.load_ema_layers
        else:
            load = self.monitor.load_ema
        if self._is_flat(load):
            # flat load (expert-choice by construction, or a converged gate):
            # no placement can improve on uniform — keep the current layout.
            self.flat_skips += 1
            return None
        if self.num_layers:
            cand = plan_placement_per_layer(load, self.num_ranks, **self.kw)
        else:
            cand = plan_placement(load, self.num_ranks, **self.kw)
        if cand in self._blacklist:
            return None
        now = self._cost(self.current, load)
        new = self._cost(cand, load)
        if new < now * (1.0 - self.min_gain) and cand != self.current:
            self.current = cand
            self.replans += 1
            return cand
        return None
