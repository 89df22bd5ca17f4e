"""Token scatter/gather — the paper's §4 reordered computation (Fig 4).

Two realizations, as in the JAX package:

* ``capacity`` — GShard-style static buffers ``(E, C, d)``; overflow tokens
  are dropped (tracked), lower slots keep priority.
* ``ragged`` — expert-sorted token array + group sizes, no drops.  Here the
  scatter (``dispatch_ragged``) and the gate-weighted gather
  (``combine_ragged``) are the two token-shuffle kernels
  (``repro_torch.kernels.token_shuffle``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float, *, multiple: int = 8) -> int:
    """Static per-expert buffer length C."""
    c = math.ceil(num_tokens * top_k * capacity_factor / num_experts)
    return max(multiple, math.ceil(c / multiple) * multiple)


# ---------------------------------------------------------------------------
# Capacity (static-buffer) dispatch
# ---------------------------------------------------------------------------


class CapacityPlan(NamedTuple):
    """Routing of each (token, slot) pair into the (E, C) buffer grid."""

    expert_ids: torch.Tensor  # (T, k) int64
    positions: torch.Tensor  # (T, k) int64 — row in the expert buffer; ==C if dropped
    keep: torch.Tensor  # (T, k) bool
    load: torch.Tensor  # (E,) int64 — tokens *assigned* per expert (pre-drop)
    capacity: int


def make_capacity_plan(expert_ids: torch.Tensor, num_experts: int,
                       capacity: int) -> CapacityPlan:
    """Assign buffer positions with slot-major priority (top-1 choices first),
    matching GShard so lower-k choices survive overflow."""
    T, k = expert_ids.shape
    flat = expert_ids.T.reshape(-1)  # slot-major (k*T,)
    onehot = F.one_hot(flat, num_experts)  # (kT, E)
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot
    pos = pos_in_expert.gather(1, flat[:, None])[:, 0]
    keep = pos < capacity
    pos = torch.where(keep, pos, torch.full_like(pos, capacity))
    load = onehot.sum(0)

    def unflatten(a):
        return a.reshape(k, T).T

    return CapacityPlan(expert_ids, unflatten(pos), unflatten(keep), load,
                        int(capacity))


def dispatch_capacity(x: torch.Tensor, plan: CapacityPlan,
                      num_experts: int) -> torch.Tensor:
    """Scatter tokens (T, d) into per-expert buffers (E, C, d).  Dropped rows
    (position C) land in a sacrificial extra row that is sliced off."""
    T, d = x.shape
    k = plan.expert_ids.shape[1]
    buf = torch.zeros(num_experts, plan.capacity + 1, d, dtype=x.dtype,
                      device=x.device)
    rows = torch.arange(T, device=x.device).repeat_interleave(k)
    buf[plan.expert_ids.reshape(-1), plan.positions.reshape(-1)] = x[rows]
    return buf[:, :plan.capacity]


def combine_capacity(out_buf: torch.Tensor, plan: CapacityPlan,
                     combine_weights: torch.Tensor) -> torch.Tensor:
    """Gather expert outputs (E, C, dout) back to token order, weighted-sum
    over k.  Dropped slots read a zero row and carry weight 0."""
    T, k = plan.expert_ids.shape
    E, _, dout = out_buf.shape
    padded = torch.cat([out_buf, out_buf.new_zeros(E, 1, dout)], dim=1)
    gathered = padded[plan.expert_ids.reshape(-1), plan.positions.reshape(-1)]
    gathered = gathered.reshape(T, k, dout)
    w = (combine_weights * plan.keep).to(gathered.dtype)
    return torch.einsum("tk,tkd->td", w, gathered)


# ---------------------------------------------------------------------------
# Ragged (sorted) dispatch — FastMoE-faithful, no drops
# ---------------------------------------------------------------------------


class RaggedPlan(NamedTuple):
    sort_idx: torch.Tensor  # (T*k,) int64 — stable argsort of flat expert ids
    group_sizes: torch.Tensor  # (E,) int32
    token_rows: torch.Tensor  # (T*k,) int32 — source token per sorted row


def make_ragged_plan(expert_ids: torch.Tensor, num_experts: int) -> RaggedPlan:
    T, k = expert_ids.shape
    flat = expert_ids.reshape(-1)  # token-major
    sort_idx = torch.argsort(flat, stable=True)
    group_sizes = torch.bincount(flat, minlength=num_experts).to(torch.int32)
    token_rows = torch.div(sort_idx, k, rounding_mode="floor").to(torch.int32)
    return RaggedPlan(sort_idx, group_sizes, token_rows)


def dispatch_ragged(x: torch.Tensor, plan: RaggedPlan) -> torch.Tensor:
    """Gather tokens (T, d) into expert-sorted order (T*k, d) — the
    ``gather_rows`` kernel."""
    return ops.gather_tokens(x, plan.token_rows)


def combine_ragged(y_sorted: torch.Tensor, plan: RaggedPlan,
                   combine_weights: torch.Tensor) -> torch.Tensor:
    """Un-sort expert outputs (T*k, dout) and weighted-sum the k slots — the
    ``combine_topk`` kernel, reading slot (t, j) from sorted row
    ``inverse(sort_idx)[t*k + j]``.  The weights are rounded to the output
    dtype first, as the JAX einsum does."""
    T, k = combine_weights.shape
    inv = torch.empty_like(plan.sort_idx)
    inv[plan.sort_idx] = torch.arange(plan.sort_idx.numel(),
                                      device=inv.device)
    idx = inv.reshape(T, k).to(torch.int32)
    return ops.combine_tokens(y_sorted, idx,
                              combine_weights.to(y_sorted.dtype))
