"""Flash attention, forward and backward, hand-written for Hopper in
``csrc/flash_attention.cu``.

``o = softmax(q k^T / sqrt(dk)) v`` over the keys with ``0 <= i - j <
window`` (causal) or ``i - j < window`` (not causal), where ``i =
q_offset + row``; q (B, Sq, H, dk), k (B, Skv, KV, dk) and v (B, Skv, KV,
dv) with H % KV == 0 (the kv head of query head h is h // (H / KV)); o is
(B, Sq, H, dv).  The window is a runtime
int, so one build serves every layer.  The forward also returns the
per-row log-sum-exp (B, H, Sq) f32, which the backward uses to recompute
the probabilities tile by tile; the (Sq, Skv) scores never reach device
memory on the card.

The kernels take dv == dk in {64, 128} (dv != dk, which MLA needs, runs
only on the CPU for now: ROADMAP §2 item 0), bf16 or f32, a window >= 1
and inputs where every row sees at least one key, so no row's softmax is
empty.  The
bf16 forward (wgmma, K and V by TMA) takes its q tile from the shape:
:func:`fwd_config`.  On
CPU tensors the wrappers run the plain version: the masked softmax in f32
(the JAX package's ``SCORE_DTYPE`` default) and its autograd.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"flash_attention_fwd": [_P] * 5 + [_I] * 11 + [_P],
         "flash_attention_fwd_smem": [_I, _I],
         "flash_attention_bwd": [_P] * 11 + [_I] * 11 + [_P]}
HEAD_DIMS = (64, 128)
BWD_KV_TILE = 64  # kv rows a block of the bf16 backward (BwdCfg::BK)
DQ_SLOT_BUDGET = 256 * 2 ** 20  # bytes of per-kv-tile f32 dQ slots at most
_NEG = -1e30
SMEM_LIMIT = 232_448  # dynamic shared memory a block may ask for on Hopper


class FwdConfig(NamedTuple):
    """The bf16 forward's tiles: q rows a block (64 per consumer
    warpgroup), kv rows a ring stage, ring stages, and the dynamic shared
    memory it asks for (``FwdCfg`` in ``csrc/flash_attention.cu``; chip_smoke
    holds the two equal)."""
    bq: int
    bk: int
    stages: int
    smem: int


def fwd_config(B: int, Sq: int, H: int, d: int) -> FwdConfig:
    """Two consumer warpgroups (128 q rows, 128-row kv stages; one block an
    SM, its registers rebalanced to the consumers) where 128-row q tiles
    give at least four blocks per SM, else one (64 and 64: several blocks
    share an SM, so short sequences keep the card full)."""
    bq = 128 if B * H * math.ceil(Sq / 128) >= 4 * _build.SMS else 64
    bk = 128 if bq == 128 else 64
    stages = (4 if bq == 128 else 3) if d == 64 else (3 if bq == 128 else 2)
    smem = 1024 + bq * d * 2 + 2 * stages * bk * d * 2 + 8 * (1 + 4 * stages)
    return FwdConfig(bq, bk, stages, smem)


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               window: int, q_offset: int) -> None:
    """Shapes — q (B, Sq, H, dk), k (B, Skv, KV, dk), v (B, Skv, KV, dv)
    with H % KV == 0 and any dv >= 1 — and the contract that every row
    sees a key: window >= 1 and q_offset + Sq - window < Skv."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or v.shape[3] < 1 \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"flash_attention: q (B, Sq, H, dk), k (B, Skv, KV, "
                         f"dk) and v (B, Skv, KV, dv) with H % KV == 0; got "
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
    if v.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: the card's kernels take dv == dk; got dk "
                         f"{q.shape[3]}, dv {v.shape[3]} (dv != dk runs on the "
                         f"CPU only until ROADMAP §2 item 0 ports it)")
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
    """(o (B, Sq, H, dv) in q's dtype, lse (B, H, Sq) f32)."""
    check_args(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, window=window,
                                         q_offset=q_offset, causal=causal)
    args = _kernel_args("flash_attention_fwd", q, k, v, window, q_offset, causal)
    B, Sq, H, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if q.numel():
        lib = _build.load("flash_attention", _SIGS)
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(), *args[:-1],
                                     fwd_config(B, Sq, H, d).bq, args[-1])
        _build.check(lib, rc, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return o, lse


def dq_slots(q: torch.Tensor, skv: int) -> int:
    """The bf16 backward's per-kv-tile dQ slots for q and Skv = ``skv``
    keys: ceil(skv / 64), or 0 where they would exceed DQ_SLOT_BUDGET."""
    tiles = math.ceil(skv / BWD_KV_TILE)
    return tiles if tiles * q.numel() * 4 <= DQ_SLOT_BUDGET else 0


def dq_scratch(q: torch.Tensor, skv: int) -> torch.Tensor | None:
    """The f32 scratch the bf16 backward kernel writes dQ into before a
    last kernel sums, scales and rounds it, for Skv = ``skv`` keys; None
    for f32, whose dQ kernel owns each row.

    Where one (B, Sq, H, d) slot per 64-row kv tile fits DQ_SLOT_BUDGET
    (every training shape: 4 x 8.4 MB at fastmoe-gpt's 8 x 256), it is
    (kv tiles, B, Sq, H, d), uninitialised: each kv tile stores its part in
    its own slot and the last kernel sums the slots that were written in
    kv-tile order, so dq is bitwise reproducible.  Beyond the budget (one
    starcoder2-15b kv group at 2 x 8192 would need ~12.9 GB) it is one
    (B, Sq, H, d) of zeros that the kv tiles add into by atomics, in an
    order that changes from run to run."""
    if q.dtype != torch.bfloat16:
        return None
    slots = dq_slots(q, skv)
    if slots:
        return torch.empty(slots, *q.shape, dtype=torch.float32, device=q.device)
    return torch.zeros(q.shape, dtype=torch.float32, device=q.device)


def flash_attention_bwd(q, k, v, o, lse, dout, *, window: int,
                        q_offset: int = 0, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention_fwd` given its (o, lse) and
    dO, in the inputs' dtype.  bf16: delta = rowsum(dO o); one kernel per
    kv tile for dK, dV and its part of dQ into :func:`dq_scratch`; dq
    summed and rounded from it — bitwise reproducible where the scratch
    has a slot per kv tile, not where it is one that the kv tiles add into
    by atomics.  f32: delta; dK and dV per kv tile; dQ per q tile."""
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
        acc = dq_scratch(q, k.shape[1])
        slots = dq_slots(q, k.shape[1]) if acc is not None else 0
        lib = _build.load("flash_attention", _SIGS)
        rc = lib.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(),
                                     dout.data_ptr(), dq.data_ptr(),
                                     dk.data_ptr(), dv.data_ptr(),
                                     delta.data_ptr(),
                                     None if acc is None else acc.data_ptr(),
                                     *args[:-1], slots, args[-1])
        _build.check(lib, rc, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
