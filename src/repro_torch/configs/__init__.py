"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Every dense and moe architecture of the JAX package is registered; the
other families join as they are ported (see ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs.base import (
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    reduced,
)
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2
from repro_torch.configs.fastmoe_gpt import CONFIG as _fastmoe_gpt
from repro_torch.configs.fastmoe_gpt import DENSE_BASELINE as _fastmoe_dense
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.switch_base import CONFIG as _switch

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [_fastmoe_gpt, _fastmoe_dense, _starcoder2,
                        _deepseek_v2, _switch, _arctic, _granite, _smollm,
                        _qwen2]}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


__all__ = ["ARCHS", "AttentionConfig", "ModelConfig", "MoEConfig",
           "get_config", "reduced"]
