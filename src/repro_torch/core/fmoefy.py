"""``fmoefy`` — the paper's §3.1 Megatron-LM plugin, as a config rewrite.

FastMoE's ``fmoefy(model, num_experts)`` monkey-patches the FFN of every
transformer layer into an MoE.  Models here are interpreted from configs,
so the plugin is a pure function ModelConfig -> ModelConfig, as the JAX
package's.  Following the paper's §5.4 methodology, the expert hidden
width defaults to d_ff / top_k so the *active* FLOPs match the dense
original.  On the ssm family (rwkv6) the MoE replaces the channel mix.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, MoEConfig


def fmoefy(cfg: ModelConfig, num_experts: int = 96, top_k: int = 2, *,
           d_expert_hidden: int | None = None,
           capacity_factor: float = 1.25,
           keep_active_flops: bool = True) -> ModelConfig:
    """Replace the dense FFN of ``cfg`` with an MoE FFN (paper Listing 1)."""
    if cfg.moe is not None:
        raise ValueError(f"{cfg.name} already has an MoE FFN")
    if d_expert_hidden is None:
        d_expert_hidden = max(8, cfg.d_ff // top_k) if keep_active_flops else cfg.d_ff
    moe = MoEConfig(num_experts=num_experts, top_k=top_k,
                    d_expert_hidden=d_expert_hidden,
                    capacity_factor=capacity_factor)
    family = cfg.family if cfg.family in ("audio", "vlm", "ssm", "hybrid") else "moe"
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-moe{num_experts}", moe=moe, family=family)
