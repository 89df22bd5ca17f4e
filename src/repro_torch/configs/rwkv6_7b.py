"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free [arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    source="arXiv:2404.05892",
    num_layers=32,
    d_model=4096,
    d_ff=14336,
    vocab_size=65536,
    attention=None,  # attention-free
    ssm=SSMConfig(kind="rwkv6", head_dim=64, lora_rank=64),
    norm="layernorm",
    act="rwkv",  # squared-relu channel mix
)
