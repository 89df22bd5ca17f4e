"""starcoder2-15b [dense] — GQA, RoPE, sliding-window 4096 [arXiv:2402.19173]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=40,
    d_model=6144,
    d_ff=24576,
    vocab_size=49152,
    attention=AttentionConfig(kind="gqa", num_heads=48, num_kv_heads=4,
                              head_dim=128, qkv_bias=True, rope_theta=1e5,
                              sliding_window=4096),
    norm="layernorm",
    act="gelu",
)
