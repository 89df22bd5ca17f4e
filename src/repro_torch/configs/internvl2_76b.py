"""internvl2-76b [vlm] — InternViT + LLM backbone [arXiv:2404.16821].

The InternViT vision encoder + MLP projector are stubbed, as in the JAX
package: the caller passes precomputed patch embeddings of shape
(B, 256, 8192) (``lm.forward/prefill/loss_fn(patches=...)``), which the LM
consumes prepended to the text tokens.
"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    d_ff=28672,
    vocab_size=128256,
    attention=AttentionConfig(kind="gqa", num_heads=64, num_kv_heads=8,
                              head_dim=128, rope_theta=500000.0),
    norm="rmsnorm",
    act="swiglu",
    frontend="vision",
    num_patches=256,
)
