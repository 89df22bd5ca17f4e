"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Every architecture of the JAX package is registered: the dense and moe
families, rwkv6-7b (ssm), hymba-1.5b (hybrid), whisper-tiny (audio) and
internvl2-76b (vlm)."""
from __future__ import annotations

from repro_torch.configs.base import (
    AttentionConfig,
    INPUT_SHAPES,
    EncoderConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    reduced,
)
from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.deepseek_v2_236b import CONFIG as _deepseek_v2
from repro_torch.configs.fastmoe_gpt import CONFIG as _fastmoe_gpt
from repro_torch.configs.fastmoe_gpt import DENSE_BASELINE as _fastmoe_dense
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.internvl2_76b import CONFIG as _internvl
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.switch_base import CONFIG as _switch
from repro_torch.configs.whisper_tiny import CONFIG as _whisper

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [_fastmoe_gpt, _fastmoe_dense, _starcoder2,
                        _deepseek_v2, _switch, _arctic, _granite, _smollm,
                        _qwen2, _rwkv6, _hymba, _whisper, _internvl]}

# The ten assigned architectures (the paper's own GPT configs aside), as
# the reference lists them.
ASSIGNED = [
    "granite-3-2b", "whisper-tiny", "arctic-480b", "qwen2-72b",
    "deepseek-v2-236b", "hymba-1.5b", "rwkv6-7b", "smollm-360m",
    "internvl2-76b", "starcoder2-15b",
]


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}") from None


__all__ = ["ARCHS", "ASSIGNED", "AttentionConfig", "EncoderConfig",
           "INPUT_SHAPES", "InputShape", "ModelConfig", "MoEConfig",
           "SSMConfig", "get_config", "reduced"]
