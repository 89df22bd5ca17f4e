"""Flash attention, forward and backward, hand-written for Hopper in
``csrc/flash_attention.cu``.

``o = softmax(q k^T / sqrt(d)) v`` over the keys with ``0 <= i - j <
window`` (causal) or ``i - j < window`` (not causal), where ``i =
q_offset + row``; q (B, Sq, H, d), k and v (B, Skv, KV, d) with H % KV == 0
(the kv head of query head h is h // (H / KV)).  The window is a runtime
int, so one build serves every layer.  The forward also returns the
per-row log-sum-exp (B, H, Sq) f32, which the backward uses to recompute
the probabilities tile by tile; the (Sq, Skv) scores never reach device
memory on the card.

The kernels take d in {64, 128}, bf16 or f32, a window >= 1 and inputs
where every row sees at least one key, so no row's softmax is empty.  On
CPU tensors the wrappers run the plain version: the masked softmax in f32
(the JAX package's ``SCORE_DTYPE`` default) and its autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"flash_attention_fwd": [_P] * 5 + [_I] * 10 + [_P],
         "flash_attention_bwd": [_P] * 11 + [_I] * 10 + [_P]}
HEAD_DIMS = (64, 128)
_NEG = -1e30


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int, q_offset: int) -> None:
    """Shapes, and the contract that every row sees a key: window >= 1 and
    q_offset + Sq - window < Skv."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q (B, Sq, H, d), k and v "
                         f"(B, Skv, KV, d) with H % KV == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if window < 1 or q_offset < 0 or q_offset + q.shape[1] - window >= k.shape[1]:
        raise ValueError(f"flash_attention: every row must see a key (window "
                         f">= 1, q_offset + Sq - window < Skv); got window "
                         f"{window}, q_offset {q_offset}, Sq {q.shape[1]}, "
                         f"Skv {k.shape[1]}")


def _scores(q, k, window, q_offset, causal):
    """Scaled masked scores (B, Sq, KV, G, Skv) in f32 (f64 for f64)."""
    B, Sq, H, dk = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, KV, H // KV, dk).to(acc)
    s = torch.einsum("bskgd,bckd->bskgc", qg, k.to(acc)) * dk ** -0.5
    i_pos = q_offset + torch.arange(Sq, device=q.device)
    dist = i_pos[:, None] - torch.arange(Skv, device=q.device)[None, :]
    mask = dist < window
    if causal:
        mask &= dist >= 0
    return s.masked_fill(~mask[None, :, None, None, :], _NEG)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_offset: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch: one masked softmax over
    materialised f32 scores, rounded once to q's dtype."""
    B, Sq, H, _ = q.shape
    s = _scores(q, k, window, q_offset, causal)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bskgc,bckd->bskgd", p, v.to(p.dtype))
    return out.reshape(B, Sq, H, -1).to(q.dtype)


def flash_attention_fwd_plain(q, k, v, *, window: int, q_offset: int = 0,
                              causal: bool = True):
    """(o, lse): the plain forward and the per-row log-sum-exp (B, H, Sq)
    of the scaled masked scores, f32."""
    B, Sq, H, _ = q.shape
    lse = torch.logsumexp(_scores(q, k, window, q_offset, causal), dim=-1)
    lse = lse.reshape(B, Sq, H).transpose(1, 2).float().contiguous()
    return attention_plain(q, k, v, window=window, q_offset=q_offset,
                           causal=causal), lse


def flash_attention_bwd_plain(q, k, v, dout, *, window: int, q_offset: int = 0,
                              causal: bool = True):
    """(dq, dk, dv): autograd of :func:`attention_plain`, in the inputs'
    dtype."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().requires_grad_() for t in (q, k, v))
        o = attention_plain(qf, kf, vf, window=window, q_offset=q_offset,
                            causal=causal)
        return torch.autograd.grad(o, (qf, kf, vf), dout)


def _kernel_args(what, q, k, v, window, q_offset, causal, *more):
    _build.require_cuda(what, q, k, v, *more)
    code = _build.dtype_code(what, q)
    if any(t.dtype != q.dtype for t in (k, v, *more)) or q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what}: q, k, v{', o, dO' if more else ''} of one "
                         f"dtype and head dim in {HEAD_DIMS}; got "
                         f"{[(tuple(t.shape), t.dtype) for t in (q, k, v, *more)]}")
    if any(t.data_ptr() % 16 for t in (q, k, v, *more)):
        raise ValueError(f"{what}: the kernels read rows in 16-byte chunks; "
                         f"every tensor must start 16-byte aligned")
    B, Sq, H, d = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    return [B, Sq, Skv, H, KV, d, int(window), int(q_offset), int(causal), code,
            _build.stream_of(q)]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int, q_offset: int = 0, causal: bool = True):
    """(o (B, Sq, H, d) in q's dtype, lse (B, H, Sq) f32)."""
    check_args(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, window=window,
                                         q_offset=q_offset, causal=causal)
    args = _kernel_args("flash_attention_fwd", q, k, v, window, q_offset, causal)
    B, Sq, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if q.numel():
        lib = _build.load("flash_attention", _SIGS)
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(), *args)
        _build.check(lib, rc, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return o, lse


def dq_scratch(q: torch.Tensor) -> torch.Tensor | None:
    """The f32 (B, Sq, H, d) zeros the bf16 backward kernel adds dQ into
    (each kv tile's part by atomic adds) before a last kernel scales and
    rounds it; None for f32, whose dQ kernel owns each row."""
    if q.dtype != torch.bfloat16:
        return None
    return torch.zeros(q.shape, dtype=torch.float32, device=q.device)


def flash_attention_bwd(q, k, v, o, lse, dout, *, window: int,
                        q_offset: int = 0, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention_fwd` given its (o, lse) and
    dO, in the inputs' dtype.  bf16: delta = rowsum(dO o); one kernel per
    kv tile for dK, dV and the dQ adds into :func:`dq_scratch`; dq rounded
    from it.  f32: delta; dK and dV per kv tile; dQ per q tile.  bf16 dq
    is not bitwise reproducible: the atomic adds land in any order."""
    check_args(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, window=window,
                                         q_offset=q_offset, causal=causal)
    args = _kernel_args("flash_attention_bwd", q, k, v, window, q_offset,
                        causal, o, dout)
    _build.require_cuda("flash_attention_bwd", lse)
    B, Sq, H, _ = q.shape
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse (B, H, Sq) f32; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel():
        delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
        acc = dq_scratch(q)
        lib = _build.load("flash_attention", _SIGS)
        rc = lib.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(),
                                     dout.data_ptr(), dq.data_ptr(),
                                     dk.data_ptr(), dv.data_ptr(),
                                     delta.data_ptr(),
                                     None if acc is None else acc.data_ptr(),
                                     *args)
        _build.check(lib, rc, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
