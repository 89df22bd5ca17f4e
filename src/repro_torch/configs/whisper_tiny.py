"""whisper-tiny [audio] — enc-dec, conv frontend (stub) [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is stubbed, as in the JAX
package: the caller passes precomputed frame embeddings of shape
(B, 1500, 384) (``lm.forward/prefill/loss_fn(frames=...)``).  This config
describes the transformer backbone only.
"""
from repro_torch.configs.base import AttentionConfig, EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,
    d_model=384,
    d_ff=1536,
    vocab_size=51865,
    attention=AttentionConfig(kind="gqa", num_heads=6, num_kv_heads=6,
                              head_dim=64, rope_theta=10000.0),
    norm="layernorm",
    act="gelu",
    encoder=EncoderConfig(num_layers=4, num_frames=1500),
    frontend="audio",
)
