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

The kernels take (dk, dv) in :data:`HEAD_DIM_PAIRS` — (64, 64), (128,
128) and MLA's (192, 128) —, bf16 or f32, a window >= 1 and inputs where
every row sees at least one key, so no row's softmax is empty; other
pairs (the reduced MLA's (48, 32)) run only on the CPU.  The bf16 forward
(wgmma, K and V by TMA) takes its q tile from the shape:
:func:`fwd_config`.  On
CPU tensors the wrappers run the plain version: the masked softmax in f32
(the JAX package's ``SCORE_DTYPE`` default) and its autograd.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, cost

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"flash_attention_fwd": [_P] * 5 + [_I] * 12 + [_P],
         "flash_attention_fwd_smem": [_I] * 3,
         "flash_attention_bwd": [_P] * 12 + [_I] * 12 + [_P]}
# (dk, dv) with an instance on the card (FOR_EACH_PAIR in the source)
HEAD_DIM_PAIRS = ((64, 64), (128, 128), (192, 128))
BWD_KV_TILE = 64  # kv rows a block of the bf16 backward (BwdCfg::BK)
# bytes of per-kv-tile f32 dQ slots at most (read at each call: a test may
# lower it to force the ranged backward); a starcoder2-15b kv group at 2 x
# 8192 (100 MB a slot, 128 kv tiles) runs in 4 ranges of 42 tiles
DQ_SLOT_BUDGET = 4 * 2 ** 30
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


def fwd_config(B: int, Sq: int, H: int, dk: int, dv: int) -> FwdConfig:
    """Two consumer warpgroups (128 q rows, 128-row kv stages; one block an
    SM, its registers rebalanced to the consumers) where 128-row q tiles
    give at least four blocks per SM, else one (64 and 64: several blocks
    share an SM, so short sequences keep the card full).  Stages: as many
    as fit, but two for one warpgroup at dk >= 128 (two blocks an SM) and
    at (192, 128) (three 128-row stages of K and V would need 296 KB)."""
    bq = 128 if B * H * math.ceil(Sq / 128) >= 4 * _build.SMS else 64
    bk = 128 if bq == 128 else 64
    if dk == 64:
        stages = 4 if bq == 128 else 3
    else:
        stages = 3 if bq == 128 and dk + dv <= 256 else 2
    smem = (1024 + bq * dk * 2 + stages * bk * (dk + dv) * 2
            + 8 * (1 + 4 * stages))
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
    pair = (q.shape[3], v.shape[3])
    if pair not in HEAD_DIM_PAIRS:
        raise ValueError(f"{what}: the card's kernels take (dk, dv) in "
                         f"{HEAD_DIM_PAIRS}; got {pair} (other pairs run on "
                         f"the CPU only)")
    _build.require_cuda(what, q, k, v, *more)
    code = _build.dtype_code(what, q)
    if any(t.dtype != q.dtype for t in (k, v, *more)):
        raise ValueError(f"{what}: q, k, v{', o, dO' if more else ''} of one "
                         f"dtype; got {[t.dtype for t in (q, k, v, *more)]}")
    if any(t.data_ptr() % 16 for t in (q, k, v, *more)):
        raise ValueError(f"{what}: the kernels read rows in 16-byte chunks; "
                         f"every tensor must start 16-byte aligned")
    B, Sq, H, dk = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    return [B, Sq, Skv, H, KV, dk, v.shape[3], int(window), int(q_offset),
            int(causal), code, _build.stream_of(q)]


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int, q_offset: int = 0, causal: bool = True):
    """(o (B, Sq, H, dv) in q's dtype, lse (B, H, Sq) f32).  Meta tensors
    (the dry run): the outputs allocated, the work entered in
    ``kernels.cost``."""
    check_args(q, k, v, window=window, q_offset=q_offset)
    if _build.all_meta(q, k, v):
        B, Sq, H, dk = q.shape
        cost.add("flash_attention_fwd", *_cost(q, k, v, window, q_offset,
                                               causal, backward=False))
        return (q.new_empty(B, Sq, H, v.shape[3]),
                torch.empty(B, H, Sq, dtype=torch.float32, device=q.device))
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, window=window,
                                         q_offset=q_offset, causal=causal)
    args = _kernel_args("flash_attention_fwd", q, k, v, window, q_offset, causal)
    B, Sq, H, dk = q.shape
    dv = v.shape[3]
    o = q.new_empty(B, Sq, H, dv)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    if q.numel():
        lib = _build.load("flash_attention", _SIGS)
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(), *args[:-1],
                                     fwd_config(B, Sq, H, dk, dv).bq, args[-1])
        _build.check(lib, rc, "flash_attention_fwd")
        flash_attention_fwd.launches += 1
    return o, lse


def dq_slots(q: torch.Tensor, skv: int) -> int:
    """The bf16 backward's per-kv-tile dQ slots for q and Skv = ``skv``
    keys: one per 64-row kv tile, ceil(skv / 64), where they fit
    DQ_SLOT_BUDGET, else as many as fit (at least one): the kv tiles then
    run in ranges of that many."""
    tiles = math.ceil(skv / BWD_KV_TILE)
    per = q.numel() * 4
    return max(1, min(tiles, DQ_SLOT_BUDGET // per)) if per else tiles


def dq_scratch(q: torch.Tensor, skv: int) -> torch.Tensor | None:
    """The f32 scratch the bf16 backward kernel writes dQ into, (slots, B,
    Sq, H, dk) uninitialised (:func:`dq_slots`), for Skv = ``skv`` keys;
    None for f32, whose dQ kernel owns each row.

    Each kv tile stores its part in its own slot, and the slots are summed
    in kv-tile order, so dq is bitwise reproducible: by the last kernel
    where every kv tile has a slot (every training shape: 4 x 8.4 MB at
    fastmoe-gpt's 8 x 256), else range by range into
    :func:`dq_accumulator`, the same additions in the same order (one
    starcoder2-15b kv group at 2 x 8192 would need ~12.9 GB of slots)."""
    if q.dtype != torch.bfloat16:
        return None
    return torch.empty(dq_slots(q, skv), *q.shape, dtype=torch.float32,
                       device=q.device)


def dq_accumulator(q: torch.Tensor, skv: int) -> torch.Tensor | None:
    """The f32 (B, Sq, H, dk) sum of the ranges' slots where the kv tiles
    run in ranges (uninitialised: the first range's sum writes it), else
    None."""
    if (q.dtype != torch.bfloat16
            or dq_slots(q, skv) >= math.ceil(skv / BWD_KV_TILE)):
        return None
    return torch.empty(q.shape, dtype=torch.float32, device=q.device)


def flash_attention_bwd(q, k, v, o, lse, dout, *, window: int,
                        q_offset: int = 0, causal: bool = True):
    """(dq, dk, dv) of :func:`flash_attention_fwd` given its (o, lse) and
    dO, in the inputs' dtype.  bf16: delta = rowsum(dO o); one kernel per
    kv tile for dK, dV and its part of dQ into :func:`dq_scratch`; dq
    summed in kv-tile order and rounded from it (over ranges of kv tiles
    where the slots would exceed the budget) — bitwise reproducible.  f32:
    delta; dK and dV per kv tile; dQ per q tile.  Meta tensors (the dry
    run): the gradients, delta and the dQ scratch allocated, the work
    entered in ``kernels.cost``."""
    check_args(q, k, v, window=window, q_offset=q_offset)
    if _build.all_meta(q, k, v, o, lse, dout):
        B, Sq, H, _ = q.shape
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
        scratch = (dq_scratch(q, k.shape[1]), dq_accumulator(q, k.shape[1]))
        del delta, scratch
        cost.add("flash_attention_bwd", *_cost(q, k, v, window, q_offset,
                                               causal, backward=True))
        return grads
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
        total = dq_accumulator(q, k.shape[1])
        slots = acc.shape[0] if acc is not None else 0
        lib = _build.load("flash_attention", _SIGS)
        rc = lib.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     o.data_ptr(), lse.data_ptr(),
                                     dout.data_ptr(), dq.data_ptr(),
                                     dk.data_ptr(), dv.data_ptr(),
                                     delta.data_ptr(),
                                     None if acc is None else acc.data_ptr(),
                                     None if total is None else total.data_ptr(),
                                     *args[:-1], slots, args[-1])
        _build.check(lib, rc, "flash_attention_bwd")
        flash_attention_bwd.launches += 1
    else:
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


def _cost(q, k, v, window, q_offset, causal, *, backward):
    B, Sq, H, dk = q.shape
    return cost.flash(B, k.shape[1], H, k.shape[2], dk, v.shape[3],
                      window, backward=backward, Sq=Sq, q_offset=q_offset,
                      causal=causal, e=q.element_size())


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0
