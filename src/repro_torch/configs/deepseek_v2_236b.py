"""deepseek-v2-236b [moe] — MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434]."""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    d_ff=12288,  # only used by fmoefy/dense comparisons; all layers are MoE
    vocab_size=102400,
    attention=AttentionConfig(kind="mla", num_heads=128, num_kv_heads=128,
                              head_dim=128, kv_lora_rank=512, q_lora_rank=1536,
                              qk_rope_head_dim=64, qk_nope_head_dim=128,
                              v_head_dim=128, rope_theta=10000.0),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert_hidden=1536,
                  num_shared_experts=2, capacity_factor=1.25),
    norm="rmsnorm",
    act="swiglu",
)
