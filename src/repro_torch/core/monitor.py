"""Load-balance monitor (paper §6: "The work of load-balance monitor ... is
in progress"): a host-side tracker fed the layers' ``MoEMetrics`` loads.

It keeps per-expert load EMAs (and, in per-layer mode, an (L, E) stack of
them), the drop-rate EMA and the imbalance statistics the placement
planner (``repro_torch.placement``) and the adaptive ragged bound read.
The expert-parallel paths report the *global* per-expert arrival count in
logical expert order, so the monitor never sees a placement's layout.

The reference's ``sink=`` (the telemetry sink) is the telemetry slice,
ROADMAP §1 item 7: anything but None is refused.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Optional

import numpy as np


def refuse_sink(sink, what: str) -> None:
    """The telemetry sinks are not ported: refuse one rather than drop its
    records."""
    if sink is not None:
        raise NotImplementedError(
            f"{what}(sink=...) emits to the telemetry sink, which is ROADMAP "
            f"§1 item 7, not ported to repro_torch yet; pass sink=None")


class LoadMonitor:
    def __init__(self, num_experts: int, *, ema: float = 0.99,
                 num_layers: int = 0, history_cap: int = 512,
                 record_every: int = 0, sink=None):
        refuse_sink(sink, "LoadMonitor")
        self.num_experts = num_experts
        self.ema = ema
        self.load_ema = np.full(num_experts, 1.0 / num_experts)
        # per-layer mode (num_layers > 0): an (L, E) EMA as well, which the
        # per-layer planner feeds on
        self.num_layers = num_layers
        self.load_ema_layers = (np.full((num_layers, num_experts),
                                        1.0 / num_experts)
                                if num_layers else None)
        self.drop_ema = 0.0
        self.steps = 0
        # once a dropless fallback has been forced, the adaptive bound must
        # not shrink the shards again
        self.force_dropless = False
        self.history: deque = deque(maxlen=max(1, int(history_cap)))
        self.record_every = record_every
        self.sink = None

    def update(self, metrics, *, record_every: Optional[int] = None) -> None:
        """metrics: a ``core.balance.MoEMetrics`` (or anything with ``load``
        and ``drop_frac``).  ``load`` is an (E,) vector (renormalized here)
        or an (L, E) per-layer stack, which also refreshes
        ``load_ema_layers``.  ``record_every`` overrides the instance
        default for this call."""
        load = np.asarray(metrics.load, np.float64)
        if load.ndim == 2:
            if self.load_ema_layers is not None:
                if load.shape != self.load_ema_layers.shape:
                    raise ValueError(
                        f"layer load {load.shape} != "
                        f"{self.load_ema_layers.shape}")
                rows = load / np.maximum(load.sum(-1, keepdims=True), 1e-12)
                self.load_ema_layers = (self.ema * self.load_ema_layers
                                        + (1 - self.ema) * rows)
            load = load.sum(0)
        total = load.sum()
        if total > 0:
            load = load / total
        drop = float(np.asarray(metrics.drop_frac))
        self.load_ema = self.ema * self.load_ema + (1 - self.ema) * load
        self.drop_ema = self.ema * self.drop_ema + (1 - self.ema) * drop
        self.steps += 1
        if record_every is None:
            record_every = self.record_every
        if record_every and self.steps % record_every == 0:
            self.history.append({"step": self.steps, **self.snapshot()})

    def snapshot(self) -> dict:
        l = self.load_ema / max(self.load_ema.sum(), 1e-12)
        uniform = 1.0 / self.num_experts
        return {
            "max_load": float(l.max()),
            "min_load": float(l.min()),
            "imbalance": float(l.max() / uniform),  # 1.0 == perfectly balanced
            "cv": float(l.std() / max(l.mean(), 1e-12)),
            "drop_ema": float(self.drop_ema),
        }

    @property
    def imbalance(self) -> float:
        return self.snapshot()["imbalance"]

    def suggest_ragged_bound(self, num_tokens_local: int, top_k: int,
                             num_peers: int, *, headroom: float = 1.25,
                             multiple: int = 8,
                             drop_guard: float = 1e-3) -> int:
        """Adaptive bound for the ragged exchange's per-peer shards.

        The dropless default (``T_local * k``) sizes every shard for all
        local assignments landing on one peer.  The EMAs know the peak peer
        share (experts partition into ``num_peers`` contiguous physical
        blocks), so the shard is sized to that share x ``headroom``.  An
        un-warmed monitor, a drop EMA above ``drop_guard`` or a forced
        dropless fallback keep the never-drop bound; results round up to
        ``multiple`` and clamp to [multiple, n]."""
        n = int(num_tokens_local) * int(top_k)
        e_pp = self.num_experts // max(1, int(num_peers))
        if (self.force_dropless or self.steps == 0 or e_pp == 0
                or float(self.drop_ema) > drop_guard):
            return n
        l = self.load_ema / max(self.load_ema.sum(), 1e-12)
        peak = max(float(l[p * e_pp:(p + 1) * e_pp].sum())
                   for p in range(int(num_peers)))
        bound = int(np.ceil(n * peak * headroom))
        bound = -(-bound // multiple) * multiple  # round up to multiple
        return int(min(max(bound, multiple), n))

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"num_experts": self.num_experts, "steps": self.steps,
                       "final": self.snapshot(),
                       "history": list(self.history)}, f, indent=1)


def expert_placement(num_experts: int, num_workers: int,
                     load: Optional[np.ndarray] = None) -> list:
    """Greedy load-aware expert -> worker placement: given a measured
    per-expert load, balance the sum of loads per worker instead of
    FastMoE's contiguous blocks.  Returns the worker of each expert.  When
    ``num_experts % num_workers != 0`` the remainder is spread one extra
    expert per worker, so every expert is placed."""
    if load is None:
        return [e * num_workers // num_experts for e in range(num_experts)]
    order = np.argsort(-np.asarray(load, np.float64))
    totals = np.zeros(num_workers)
    counts = np.zeros(num_workers, np.int64)
    base, rem = divmod(num_experts, num_workers)
    caps = np.full(num_workers, base, np.int64)
    caps[:rem] += 1
    place = np.zeros(num_experts, np.int64)
    for e in order:
        # the lightest worker with room left (caps within 1 of E / W)
        for w in np.argsort(totals, kind="stable"):
            if counts[w] < caps[w]:
                place[e] = w
                totals[w] += load[e]
                counts[w] += 1
                break
    return place.tolist()
