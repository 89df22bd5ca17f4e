"""switch-base-128 [moe] — Switch Transformer top-1 routing (arXiv:2101.03961).

Beyond the assigned pool: the paper positions FastMoE against Switch/GShard,
so a top-1 (k=1) config exercises the k=1 gate/dispatch/combine path and the
'topk_softmax' policy that Switch uses.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="switch-base-128",
    family="moe",
    source="arXiv:2101.03961",
    num_layers=12,
    d_model=768,
    d_ff=3072,
    vocab_size=32128,
    attention=AttentionConfig(kind="gqa", num_heads=12, num_kv_heads=12,
                              head_dim=64, rope_theta=10000.0),
    moe=MoEConfig(num_experts=128, top_k=1, d_expert_hidden=3072,
                  gate_policy="topk_softmax", renormalize=False,
                  capacity_factor=1.25),
    norm="rmsnorm",
    act="gelu",
)
