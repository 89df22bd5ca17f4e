"""qwen2-72b [dense] — GQA, QKV bias [arXiv:2407.10671]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671",
    num_layers=80,
    d_model=8192,
    d_ff=29568,
    vocab_size=152064,
    attention=AttentionConfig(kind="gqa", num_heads=64, num_kv_heads=8,
                              head_dim=128, qkv_bias=True, rope_theta=1e6),
    norm="rmsnorm",
    act="swiglu",
)
