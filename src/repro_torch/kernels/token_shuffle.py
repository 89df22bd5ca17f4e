"""Token scatter/gather kernels — the paper's §4 dedicated memory-movement
kernels (Fig 4), hand-written for Hopper in ``csrc/token_shuffle.cu``.

``gather_rows``  : y[i] = x[idx[i]]            (the *scatter*: tokens into
                   expert-sorted order)
``combine_topk`` : y[t] = sum_k w[t,k] * src[idx[t,k]]   (the *gather*:
                   expert outputs back in token order, mixed by the gate,
                   accumulated in f32)

Each wrapper runs its CUDA kernel on CUDA tensors (raising if it cannot) and
the plain PyTorch version beside it on CPU tensors; ``launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "gather_rows": [_P, _P, _P, _I, _I, _I, _P],
    "combine_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def _lib():
    return _build.load("token_shuffle", _SIGS)


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def combine_topk_plain(src: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    acc = torch.promote_types(src.dtype, torch.float32)  # f64 stays f64
    gathered = src[idx.long()].to(acc)  # (T, k, d)
    return (w.to(acc)[..., None] * gathered).sum(1).to(src.dtype)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y[i] = x[idx[i]]; x (M, d) any dtype, idx (T,) int32 -> (T, d)."""
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx)
    _build.require_cuda("gather_rows", x, idx)
    if x.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"gather_rows: x (M, d) and idx (T,) int32, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)} {idx.dtype}")
    M, d = x.shape
    T = idx.shape[0]
    y = torch.empty(T, d, dtype=x.dtype, device=x.device)
    if T and d:
        lib = _lib()
        rc = lib.gather_rows(x.data_ptr(), idx.data_ptr(), y.data_ptr(), T, M,
                             d * x.element_size(), _build.stream_of(x))
        _build.check(lib, rc, "gather_rows")
        gather_rows.launches += 1
    return y


def combine_topk(src: torch.Tensor, idx: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_k w[t, k] * src[idx[t, k]] in f32, rounded to src's dtype.

    src (M, d) f32 or bf16; idx (T, k) int32; w (T, k), read as f32.
    """
    if src.device.type == "cpu":
        return combine_topk_plain(src, idx, w)
    w = w.float().contiguous()
    _build.require_cuda("combine_topk", src, idx, w)
    code = _build.dtype_code("combine_topk", src)
    if (src.dim() != 2 or idx.dim() != 2 or idx.dtype != torch.int32
            or w.shape != idx.shape):
        raise ValueError(f"combine_topk: src (M, d), idx (T, k) int32 and w "
                         f"(T, k), got {tuple(src.shape)}, {tuple(idx.shape)} "
                         f"{idx.dtype}, {tuple(w.shape)}")
    M, d = src.shape
    T, k = idx.shape
    y = torch.empty(T, d, dtype=src.dtype, device=src.device)
    if T and d:
        lib = _lib()
        rc = lib.combine_topk(src.data_ptr(), idx.data_ptr(), w.data_ptr(),
                              y.data_ptr(), T, k, M, d, code,
                              _build.stream_of(src))
        _build.check(lib, rc, "combine_topk")
        combine_topk.launches += 1
    return y


gather_rows.launches = 0
combine_topk.launches = 0
