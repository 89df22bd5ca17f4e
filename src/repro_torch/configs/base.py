"""Configuration dataclasses, copied field for field from the JAX package.

The port keeps its own copy (it never imports ``repro``); every architecture
is a :class:`ModelConfig` composed of attention / SSM / MoE sub-configs.
Configs are frozen, hashable and purely declarative — `repro_torch.models.lm`
interprets them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AttentionConfig:
    """Multi-head attention variants: GQA (llama-style) and MLA (DeepSeek-V2)."""

    kind: str = "gqa"  # "gqa" | "mla"
    num_heads: int = 8
    num_kv_heads: int = 8
    head_dim: int = 64
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    # Sliding-window size per layer; None => full causal attention.
    sliding_window: Optional[int] = None
    # Layer indices that use *full* attention even when sliding_window is set
    # (Hymba keeps first/middle/last global).  Empty tuple => all windowed.
    global_layers: Tuple[int, ...] = ()
    # --- MLA-only fields (DeepSeek-V2) ---
    kv_lora_rank: int = 0  # compressed KV latent width (512 for DS-V2)
    q_lora_rank: int = 0  # 0 => full-rank Q projection
    qk_rope_head_dim: int = 64  # decoupled RoPE key width
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence blocks (RWKV6 Finch, Mamba for Hymba)."""

    kind: str = "rwkv6"  # "rwkv6" | "mamba"
    state_size: int = 16  # per-channel state (mamba) / head_dim (rwkv)
    head_dim: int = 64  # rwkv6 head size
    expand: int = 2  # mamba inner expansion
    dt_rank: int = 0  # mamba delta rank; 0 => ceil(d_model/16)
    conv_width: int = 4  # mamba local conv width
    lora_rank: int = 64  # rwkv6 data-dependent decay LoRA rank


@dataclass(frozen=True)
class MoEConfig:
    """Sparsely-gated mixture-of-experts FFN (the paper's subject)."""

    num_experts: int = 8
    top_k: int = 2
    d_expert_hidden: int = 0  # per-expert FFN hidden width
    num_shared_experts: int = 0  # DeepSeek-V2 always-on experts
    dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    # routing variant (the gate is user-swappable, paper §3.1):
    #   "topk"          softmax top-k (gate_policy picks the score order)
    #   "noisy_topk"    Shazeer et al. 2017 learned-noise top-k (exploration)
    #   "gumbel"        gumbel-softmax perturbed top-k (StableMoE-style
    #                   exploration; deterministic == "topk" when no rng)
    #   "expert_choice" Zhou et al. 2022: experts pick tokens — exact
    #                   per-expert capacity by construction (no drops,
    #                   flat load, no balance loss)
    #   "frozen"        StableMoE stage 2: route through the frozen
    #                   distilled router (w_frozen, stop-gradient)
    router: str = "topk"
    router_temperature: float = 1.0  # gumbel perturbation scale
    # "softmax_topk": softmax over all experts then take top-k (GShard)
    # "topk_softmax": top-k logits then softmax over the k (Switch/FastMoE Alg.1)
    gate_policy: str = "softmax_topk"
    renormalize: bool = True  # renormalize selected gate weights to sum to 1
    balance_loss_weight: float = 0.01  # aux load-balance loss (paper §6 future work)
    z_loss_weight: float = 1e-3
    router_dtype: str = "float32"
    # dispatch implementation: "capacity" (static GShard buffers, TPU-native,
    # supports expert parallelism) | "ragged" (sorted tokens + grouped GEMM,
    # FastMoE-faithful single-worker path, no token drops)
    dispatch: str = "capacity"


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (whisper).  Frontend is stubbed: inputs are
    precomputed frame embeddings of shape (B, num_frames, d_model)."""

    num_layers: int = 4
    num_frames: int = 1500  # whisper 30s @ 50Hz after conv frontend


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | audio | vlm
    source: str = ""  # citation for the assigned config
    num_layers: int = 2
    d_model: int = 256
    d_ff: int = 1024
    vocab_size: int = 32000
    attention: Optional[AttentionConfig] = None
    ssm: Optional[SSMConfig] = None
    moe: Optional[MoEConfig] = None
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    max_seq_len: int = 131072
    # enc-dec / multimodal
    encoder: Optional[EncoderConfig] = None
    # "none" | "audio" (stub frame embeddings) | "vision" (stub patch embeddings)
    frontend: str = "none"
    num_patches: int = 256  # vlm stub patch count
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # remat policy for the scanned layer stack: "full" | "none"
    remat: str = "full"

    # -- derived ------------------------------------------------------------
    @property
    def ffn_kind(self) -> str:
        return "moe" if self.moe is not None else "dense"

    def param_count(self) -> int:
        """Total parameter count (embedding + layers + head)."""
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # lm head
        n += self.num_layers * self._layer_params()
        n += self.d_model  # final norm
        if self.encoder is not None:
            enc_layer = self._attn_params(self_only=True) + self._dense_ffn_params(self.d_ff) + 4 * self.d_model
            n += self.encoder.num_layers * enc_layer
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed top-k + shared)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        n += self.num_layers * self._layer_params(active=True)
        return n

    # -- internals ------------------------------------------------------------
    def _dense_ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.act == "swiglu" else 2
        return mult * self.d_model * d_ff

    def _attn_params(self, self_only: bool = False) -> int:
        a = self.attention
        if a is None:
            return 0
        if a.kind == "mla":
            kv_in = a.kv_lora_rank + a.qk_rope_head_dim
            q = (self.d_model * a.q_lora_rank + a.q_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim)
                 if a.q_lora_rank else self.d_model * a.num_heads * (a.qk_nope_head_dim + a.qk_rope_head_dim))
            kv = self.d_model * kv_in + a.kv_lora_rank * a.num_heads * (a.qk_nope_head_dim + a.v_head_dim)
            o = a.num_heads * a.v_head_dim * self.d_model
            return q + kv + o
        qkv = self.d_model * (a.num_heads + 2 * a.num_kv_heads) * a.head_dim
        o = a.num_heads * a.head_dim * self.d_model
        cross = 0 if self_only else 0
        return qkv + o + cross

    def _ssm_params(self) -> int:
        s = self.ssm
        if s is None:
            return 0
        d = self.d_model
        if s.kind == "rwkv6":
            # r,k,v,g,o projections + decay/first per head + token-shift loras
            return 5 * d * d + 2 * d + 6 * (d * 32 + 32 * d) + s.lora_rank * 2 * d
        d_in = s.expand * d
        dt_rank = s.dt_rank or max(1, (d + 15) // 16)
        return (d * 2 * d_in + d_in * s.conv_width + d_in * (dt_rank + 2 * s.state_size)
                + dt_rank * d_in + d_in * s.state_size + d_in + d_in * d)

    def _layer_params(self, active: bool = False) -> int:
        n = 2 * self.d_model  # two norms
        n += self._attn_params()
        n += self._ssm_params()
        if self.moe is not None:
            m = self.moe
            per_expert = self._dense_ffn_params(m.d_expert_hidden)
            n_experts = (m.top_k if active else m.num_experts) + m.num_shared_experts
            n += n_experts * per_expert
            n += self.d_model * m.num_experts  # router
            if m.dense_residual:
                n += self._dense_ffn_params(self.d_ff)
        else:
            n += self._dense_ffn_params(self.d_ff)
        return n


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, *, num_layers: int = 2, d_model: int = 256,
            max_experts: int = 4) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=512 d_model, <=4 experts)."""
    scale = d_model / cfg.d_model
    attn = cfg.attention
    if attn is not None:
        heads = max(2, min(4, attn.num_heads))
        kv = max(1, min(heads, attn.num_kv_heads if attn.num_kv_heads < attn.num_heads else heads))
        while heads % kv:
            kv -= 1
        attn = dataclasses.replace(
            attn, num_heads=heads, num_kv_heads=kv, head_dim=d_model // heads if attn.kind == "gqa" else attn.head_dim,
            sliding_window=min(attn.sliding_window, 64) if attn.sliding_window else None,
            global_layers=tuple(g for g in attn.global_layers if g < num_layers),
        )
        if attn.kind == "mla":
            attn = dataclasses.replace(
                attn, kv_lora_rank=64, q_lora_rank=32 if cfg.attention.q_lora_rank else 0,
                qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32, head_dim=32)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, head_dim=min(ssm.head_dim, 32), lora_rank=16)
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=min(moe.num_experts, max_experts),
            top_k=min(moe.top_k, 2),
            d_expert_hidden=max(32, int(moe.d_expert_hidden * scale) // 8 * 8),
            num_shared_experts=min(moe.num_shared_experts, 1))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=num_layers,
        d_model=d_model,
        d_ff=max(64, int(cfg.d_ff * scale) // 8 * 8),
        vocab_size=min(cfg.vocab_size, 512),
        attention=attn, ssm=ssm, moe=moe,
        encoder=EncoderConfig(num_layers=1, num_frames=16) if cfg.encoder else None,
        num_patches=8 if cfg.frontend == "vision" else cfg.num_patches,
        max_seq_len=512,
        dtype="float32", param_dtype="float32",
        remat="none",
    )
