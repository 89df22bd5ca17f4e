"""hymba-1.5b [hybrid] — parallel attn+mamba heads [arXiv:2411.13676].

Each layer runs GQA attention and a Mamba SSM head in PARALLEL on the same
input and fuses their (normalized) outputs.  Sliding-window attention
everywhere except first/middle/last layers (global), per the paper.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    source="arXiv:2411.13676",
    num_layers=32,
    d_model=1600,
    d_ff=5504,
    vocab_size=32001,
    attention=AttentionConfig(kind="gqa", num_heads=25, num_kv_heads=5,
                              head_dim=64, sliding_window=1024,
                              global_layers=(0, 15, 31), rope_theta=10000.0),
    ssm=SSMConfig(kind="mamba", state_size=16, expand=2, conv_width=4),
    norm="rmsnorm",
    act="swiglu",
)
