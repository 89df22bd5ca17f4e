"""fastmoe-gpt [moe] — the paper's own §5.4 model: 12-layer GPT, 96 experts
per layer, top-2, expert-FFN hidden halved so active FLOPs match the dense
baseline [FastMoE, He et al. 2021, §5.4]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

# Megatron GPT-small-ish geometry used in the paper's 8-GPU experiment.
CONFIG = ModelConfig(
    name="fastmoe-gpt",
    family="moe",
    source="FastMoE §5.4 (arXiv:2103.13262)",
    num_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=50304,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16,
                              head_dim=64, rope_theta=10000.0),
    # d_h halved (4096 -> 2048) so top-2 active FLOPs == dense baseline (§5.4)
    moe=MoEConfig(num_experts=96, top_k=2, d_expert_hidden=2048,
                  capacity_factor=1.25),
    norm="layernorm",
    act="gelu",
)

# Dense same-active-FLOPs baseline the paper compares against in Fig. 7.
DENSE_BASELINE = ModelConfig(
    name="fastmoe-gpt-dense",
    family="dense",
    source="FastMoE §5.4 baseline",
    num_layers=12,
    d_model=1024,
    d_ff=4096,
    vocab_size=50304,
    attention=AttentionConfig(kind="gqa", num_heads=16, num_kv_heads=16,
                              head_dim=64, rope_theta=10000.0),
    norm="layernorm",
    act="gelu",
)
