"""Load-balance losses and monitoring (paper §6 future work, following
Switch/GShard).  The telemetry field ``obs`` of the JAX ``MoEMetrics`` joins
with the telemetry slice of the port."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MoEMetrics(NamedTuple):
    """Per-MoE-layer metrics, accumulable across layers with ``+``."""

    aux_loss: torch.Tensor  # scalar — Switch load-balance loss
    z_loss: torch.Tensor  # scalar — router logit z-loss
    load: torch.Tensor  # (E,) float32 — fraction of tokens assigned per expert
    drop_frac: torch.Tensor  # scalar — fraction of (token, slot) pairs dropped

    @staticmethod
    def zero(num_experts: int, device) -> "MoEMetrics":
        z = torch.zeros((), device=device)
        return MoEMetrics(z, z, torch.zeros(num_experts, device=device), z)

    def __add__(self, other: "MoEMetrics") -> "MoEMetrics":
        return MoEMetrics(*(a + b for a, b in zip(self, other)))


def load_balance_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-Transformer aux loss: E * sum_e f_e * P_e (f_e: fraction of
    tokens whose top-1 choice is e; P_e: mean router prob)."""
    top1 = expert_ids[:, 0]
    f = F.one_hot(top1, num_experts).to(probs.dtype).mean(0)
    p = probs.mean(0)
    return num_experts * torch.sum(f * p)


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE z-loss: mean(logsumexp(logits)^2)."""
    return torch.mean(torch.logsumexp(logits, dim=-1) ** 2)


def load_metrics(load_counts: torch.Tensor, keep, num_assignments: int):
    """(normalized per-expert load, dropped fraction) — the paper's §6
    'load-balance monitor'."""
    total = max(float(num_assignments), 1.0)
    load = load_counts.float() / total
    if keep is None:
        drop = torch.zeros((), device=load_counts.device)
    else:
        drop = 1.0 - keep.float().sum() / total
    return load, drop
