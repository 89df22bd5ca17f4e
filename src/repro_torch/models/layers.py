"""Shared layer primitives: norms, RoPE, embeddings, linear, and the
tensor-parallel view of a layer (:class:`TP`).

Numerics follow the JAX reference exactly: norms compute in f32 with
eps 1e-6 and the population variance, RoPE is the half-split form with
angles in f32, and the unembedding runs in f32.

The embedding is vocab-parallel where serving holds its table split over
``model`` (``launch.sharding.Layout.tp``): each rank looks up the ids in
its block of rows, writes zeros for the rest (:func:`embed_part`), and
the parts are summed over ``model`` (exact: one part is nonzero).  The
head's logits are then local to the rank's vocab block and gathered over
``model`` into the whole (B, S, V), so every model rank of a data group
holds the same logits bit for bit.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core import comm


class TP(NamedTuple):
    """Which blocks of a layer (``attn``, ``cross_attn``, ``ffn``,
    ``ffn/shared``, ``ffn/dense``), or of the model's ends (``embed``,
    ``lm_head``), a serving rank computes tensor-parallel over the mesh's
    ``model`` axis (``launch.sharding.Layout.blocks_under``).  Such a block
    computes its local part on the rank's weights; :meth:`sum` adds the
    parts over ``model`` and :meth:`gather` joins vocab slices.  For a
    block not among ``blocks`` both are the identity.  :data:`NO_TP`: the
    whole-weight path."""
    mesh: Any = None
    blocks: frozenset = frozenset()

    def on(self, block: str) -> bool:
        return block in self.blocks

    @property
    def size(self) -> int:
        return self.mesh.shape["model"] if self.blocks else 1

    @property
    def rank(self) -> int:
        return self.mesh.axis_index("model") if self.blocks else 0

    def sum(self, part: torch.Tensor, block: str) -> torch.Tensor:
        return comm.tp_sum(part, self.mesh) if self.on(block) else part

    def gather(self, part: torch.Tensor, block: str) -> torch.Tensor:
        return comm.tp_gather(part, self.mesh) if self.on(block) else part


NO_TP = TP()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_init(d: int, kind: str, *, device, dtype=torch.float32) -> dict:
    p = {"scale": torch.ones(d, device=device, dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(d, device=device, dtype=dtype)
    return p


def apply_norm(params: dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    scale = params["scale"].float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * scale + params["bias"].float()
    else:  # rmsnorm
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by per-position angles.

    positions: broadcastable to (..., seq) — absolute token positions.
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings and linear layers
# ---------------------------------------------------------------------------


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device,
               dtype=torch.float32) -> dict:
    t = torch.randn(vocab, d, generator=gen, device=device) * 0.02
    return {"table": t.to(dtype)}


def embed_part(table: torch.Tensor, tokens: torch.Tensor,
               rank: int) -> torch.Tensor:
    """Model rank ``rank``'s part of the vocab-parallel lookup on its block
    ``table`` of rows: the rows of the ids in its block, zeros for the
    rest.  On the whole table (rank 0) the lookup itself."""
    n = table.shape[0]
    local = tokens - rank * n
    rows = table[local.clamp(0, n - 1)]
    hit = ((local >= 0) & (local < n))[..., None]
    return torch.where(hit, rows, rows.new_zeros(()))


def embed_lookup(params: dict, tokens: torch.Tensor, dtype,
                 tp: TP = NO_TP) -> torch.Tensor:
    if not tp.on("embed"):
        return params["table"][tokens].to(dtype)
    return tp.sum(embed_part(params["table"], tokens, tp.rank),
                  "embed").to(dtype)


def unembed(params: dict, x: torch.Tensor, tp: TP = NO_TP) -> torch.Tensor:
    """Logits in float32 (numerically-sensitive softmax upstream); under a
    vocab-parallel table the rank's slice, gathered over ``model``."""
    return tp.gather(x.float() @ params["table"].float().T, "embed")


def linear_init(gen: torch.Generator, d_in: int, d_out: int, *, device,
                dtype=torch.float32, bias: bool = False) -> dict:
    w = torch.randn(d_in, d_out, generator=gen, device=device) * d_in ** -0.5
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device, dtype=dtype)
    return p


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x @ w (+ b); w keeps the JAX layout (d_in, d_out)."""
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y
