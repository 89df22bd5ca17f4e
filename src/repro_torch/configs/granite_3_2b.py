"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    source="hf:ibm-granite/granite-3.0-2b-base",
    num_layers=40,
    d_model=2048,
    d_ff=8192,
    vocab_size=49155,
    attention=AttentionConfig(kind="gqa", num_heads=32, num_kv_heads=8,
                              head_dim=64, rope_theta=10000.0),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
)
