"""Fused expert FFN — grouped GEMM1 + activation + grouped GEMM2 in one
kernel, hand-written for Hopper in ``csrc/fused_ffn.cu``.

``y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g]`` for rows sorted
by group.  The (M, H) hidden activation never reaches device memory: each
block keeps one (16, 128) hidden tile in shared memory, rounded to the
working dtype before the second product (so fused matches two-pass in
bf16).  The hidden tiles of a row tile may be split over several blocks
that write f32 partials, summed in order by a second small kernel; the
wrapper sizes that split from the row count so that decode (few rows, few
experts) still fills the card.  Same group / zero-row contract as
``grouped_gemm``.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"fused_ffn": [_P] * 7 + [_I] * 8 + [_P]}
ACTS = {"swiglu": 0, "gelu": 1, "rwkv": 2, "silu": 3}
BM, BH = 16, 128  # row tile and hidden tile of csrc/fused_ffn.cu


def check_gating(ws: tuple, act: str) -> None:
    """swiglu needs (wi_gate, wi_up); every other act needs a single (wi,)."""
    if (len(ws) == 2) != (act == "swiglu"):
        raise ValueError(
            f"act='swiglu' requires ws=(wi_gate, wi_up); other activations "
            f"require ws=(wi,) — got {len(ws)} weight(s) with act={act!r}")


def activate(g: torch.Tensor, u, act: str) -> torch.Tensor:
    """Activation between the GEMMs (mirrors repro_torch.core.fmoe._act)."""
    if act == "swiglu":
        return F.silu(g) * u
    if act == "gelu":
        return F.gelu(g, approximate="tanh")
    if act == "rwkv":  # squared relu (RWKV channel-mix)
        return torch.square(F.relu(g))
    return F.silu(g)


def fused_ffn_plain(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                    group_sizes: torch.Tensor, act: str) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: f32 products (f64 for f64
    inputs), the hidden rounded to x's dtype before the second product;
    rows past the groups are zero."""
    check_gating(ws, act)
    M = x.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros(M, wo.shape[2], dtype=x.dtype, device=x.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, M)
        if end > start:
            xe = x[start:end].to(acc)
            g = xe @ ws[0][e].to(acc)
            u = xe @ ws[1][e].to(acc) if len(ws) == 2 else None
            h = activate(g, u, act).to(x.dtype).to(acc)
            y[start:end] = (h @ wo[e].to(acc)).to(x.dtype)
        start = end
    return y


def splits_for(M: int, E: int, H: int, device) -> int:
    """Hidden-tile split per row tile: enough blocks for about two per SM,
    never more splits than hidden tiles."""
    row_tiles = max(1, min(math.ceil(M / BM) + E, M))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(math.ceil(H / BH), math.ceil(2 * sms / row_tiles)))


def fused_ffn(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
              group_sizes: torch.Tensor, act: str) -> torch.Tensor:
    """x (M, K); ws (wi,) or (wi_gate, wi_up), each (E, K, H); wo (E, H, N);
    group_sizes (E,) int32 summing to <= M."""
    if x.device.type == "cpu":
        return fused_ffn_plain(x, ws, wo, group_sizes, act)
    check_gating(ws, act)
    _build.require_cuda("fused_ffn", x, *ws, wo, group_sizes)
    code = _build.dtype_code("fused_ffn", x)
    M, K = x.shape
    E, K2, H = ws[0].shape
    E2, H2, N = wo.shape
    if (any(w.dtype != x.dtype or w.shape != ws[0].shape for w in (*ws,))
            or wo.dtype != x.dtype or (K2, E2, H2) != (K, E, H)
            or group_sizes.shape != (E,) or group_sizes.dtype != torch.int32):
        raise ValueError(f"fused_ffn: x (M, K), ws (E, K, H), wo (E, H, N) of "
                         f"one dtype, group_sizes (E,) int32; got "
                         f"{tuple(x.shape)}, {[tuple(w.shape) for w in ws]}, "
                         f"{tuple(wo.shape)}, {tuple(group_sizes.shape)}")
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M and N:
        lib = _build.load("fused_ffn", _SIGS)
        splits = splits_for(M, E, H, x.device)
        partial = torch.empty(splits, M, N, dtype=torch.float32,
                              device=x.device)
        wu = ws[1].data_ptr() if len(ws) == 2 else None
        rc = lib.fused_ffn(x.data_ptr(), ws[0].data_ptr(), wu, wo.data_ptr(),
                           group_sizes.data_ptr(), partial.data_ptr(),
                           y.data_ptr(), M, K, H, N, E, ACTS[act], splits,
                           code, _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn")
        fused_ffn.launches += 1
    return y


fused_ffn.launches = 0
