"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    num_layers=32,
    d_model=960,
    d_ff=2560,
    vocab_size=49152,
    attention=AttentionConfig(kind="gqa", num_heads=15, num_kv_heads=5,
                              head_dim=64, rope_theta=10000.0),
    norm="rmsnorm",
    act="swiglu",
    tie_embeddings=True,
)
