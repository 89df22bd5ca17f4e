"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Only the architectures the port serves so far are registered; the others
join as their model families are ported (see ROADMAP.md)."""
from __future__ import annotations

from repro_torch.configs.base import (
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    reduced,
)
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2
from repro_torch.configs.fastmoe_gpt import CONFIG as _fastmoe_gpt
from repro_torch.configs.fastmoe_gpt import DENSE_BASELINE as _fastmoe_dense
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [_fastmoe_gpt, _fastmoe_dense, _starcoder2,
                        _deepseek_v2]}


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


__all__ = ["ARCHS", "AttentionConfig", "ModelConfig", "MoEConfig",
           "get_config", "reduced"]
