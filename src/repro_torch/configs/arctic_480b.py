"""arctic-480b [moe] — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35,
    d_model=7168,
    d_ff=4864,  # dense-residual FFN width
    vocab_size=32000,
    attention=AttentionConfig(kind="gqa", num_heads=56, num_kv_heads=8,
                              head_dim=128, rope_theta=10000.0),
    moe=MoEConfig(num_experts=128, top_k=2, d_expert_hidden=4864,
                  dense_residual=True, capacity_factor=1.25),
    norm="rmsnorm",
    act="swiglu",
)
