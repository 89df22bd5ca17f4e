"""Token scatter/gather kernels — the paper's §4 dedicated memory-movement
kernels (Fig 4), hand-written for Hopper in ``csrc/token_shuffle.cu``.

``gather_rows``  : y[i] = x[idx[i]]            (the *scatter*: tokens into
                   expert-sorted order)
``combine_topk`` : y[t] = sum_k w[t,k] * src[idx[t,k]]   (the *gather*:
                   expert outputs back in token order, mixed by the gate,
                   accumulated in f32)

``gather_rows`` has two kernels.  Given ``slot_rows``, the inverse of an
``idx`` that takes every source row k times (the ragged plan's table), and
rows the source-major kernel takes (``by_source_fits``), it runs
``gather_rows_by_source``: y[slot_rows[t, j]] = x[t], reading each source
row once and storing it k times.  Otherwise the per-destination kernel
reads x[idx[i]] for each row i.

Each wrapper runs its CUDA kernel on CUDA tensors (raising if it cannot) and
the plain PyTorch version beside it on CPU tensors; ``launches`` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, cost

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {
    "gather_rows": [_P, _P, _P, _I, _I, _I, _I, _P],
    "gather_rows_by_source": [_P, _P, _P, _I, _I, _I, _I, _P],
    "combine_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
}
MAX_SOURCE_K = 32  # the source-major kernel keeps a row's k slots in a warp


def _lib():
    return _build.load("token_shuffle", _SIGS)


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x[idx.long()]


def gather_rows_by_source_plain(x: torch.Tensor,
                                slot_rows: torch.Tensor) -> torch.Tensor:
    T, k = slot_rows.shape
    y = x.new_empty(T * k, x.shape[1])
    return y.index_copy_(0, slot_rows.reshape(-1).long(),
                         x.repeat_interleave(k, dim=0))


def combine_topk_plain(src: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor | None = None) -> torch.Tensor:
    acc = torch.promote_types(src.dtype, torch.float32)  # f64 stays f64
    gathered = src[idx.long()].to(acc)  # (T, k, d)
    if w is not None:
        gathered = w.to(acc)[..., None] * gathered
    return gathered.sum(1).to(src.dtype)


def by_source_fits(x: torch.Tensor, slot_rows: torch.Tensor) -> bool:
    """The source-major kernel's shape check: x's rows are whole 16-byte
    chunks from a 16-byte-aligned start, and k <= MAX_SOURCE_K."""
    return (x.dim() == 2 and slot_rows.dim() == 2
            and x.shape[1] * x.element_size() % 16 == 0
            and x.data_ptr() % 16 == 0
            and 0 < slot_rows.shape[1] <= MAX_SOURCE_K)


def gather_rows(x: torch.Tensor, idx: torch.Tensor,
                slot_rows: torch.Tensor | None = None) -> torch.Tensor:
    """y[i] = x[idx[i]]; x (M, d) any dtype, idx (T,) int32 -> (T, d).

    ``slot_rows`` (M, k) int32, where given, is idx's inverse: idx takes
    every row of x k times and row slot_rows[t, j] of y holds x[t].  Rows
    that ``by_source_fits`` then take the source-major kernel."""
    if slot_rows is not None and by_source_fits(x, slot_rows):
        return gather_rows_by_source(x, slot_rows)
    if _build.all_meta(x, idx):  # the dry run: allocate, count, no compute
        T, d = idx.shape[0], x.shape[1]
        cost.add("gather_rows", *cost.gather_rows(
            T, d, min(T, x.shape[0]), x.element_size()))
        return torch.empty(T, d, dtype=x.dtype, device=x.device)
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
                             d * x.element_size(), _build.SMS,
                             _build.stream_of(x))
        _build.check(lib, rc, "gather_rows")
        gather_rows.launches += 1
    return y


def gather_rows_by_source(x: torch.Tensor,
                          slot_rows: torch.Tensor) -> torch.Tensor:
    """y[slot_rows[t, j]] = x[t]; x (T, d) any dtype, slot_rows (T, k) int32
    a permutation of range(T * k) -> (T * k, d).  Each row of x is read
    once.  The kernel needs ``by_source_fits``."""
    if _build.all_meta(x, slot_rows):  # the dry run: allocate and count
        (T, d), k = x.shape, slot_rows.shape[1]
        cost.add("gather_rows_by_source", *cost.gather_rows(
            T * k, d, T, x.element_size()))
        return torch.empty(T * k, d, dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return gather_rows_by_source_plain(x, slot_rows)
    _build.require_cuda("gather_rows_by_source", x, slot_rows)
    if (slot_rows.dtype != torch.int32 or not by_source_fits(x, slot_rows)
            or slot_rows.shape[0] != x.shape[0]):
        raise ValueError(f"gather_rows_by_source: x (T, d) of 16-byte rows and "
                         f"slot_rows (T, k <= {MAX_SOURCE_K}) int32, got "
                         f"{tuple(x.shape)} {x.dtype} and "
                         f"{tuple(slot_rows.shape)} {slot_rows.dtype}")
    T, d = x.shape
    k = slot_rows.shape[1]
    y = torch.empty(T * k, d, dtype=x.dtype, device=x.device)
    if T and d:
        lib = _lib()
        rc = lib.gather_rows_by_source(
            x.data_ptr(), slot_rows.data_ptr(), y.data_ptr(), T, k,
            d * x.element_size(), _build.SMS, _build.stream_of(x))
        _build.check(lib, rc, "gather_rows_by_source")
        gather_rows_by_source.launches += 1
    return y


def combine_topk(src: torch.Tensor, idx: torch.Tensor,
                 w: torch.Tensor | None = None) -> torch.Tensor:
    """y[t] = sum_k w[t, k] * src[idx[t, k]] in f32, rounded to src's dtype.

    src (M, d) f32 or bf16; idx (T, k) int32; w (T, k) f32 or bf16, read as
    stored and widened to f32 (exact), or None for weights of 1.  Meta
    tensors (the dry run): the output allocated, the work counted.
    """
    if _build.all_meta(src, idx, w):
        (T, k), d = idx.shape, src.shape[1]
        cost.add("combine_topk", *cost.combine_topk(
            T, k, d, min(src.shape[0], T * k), src.element_size(),
            4 if w is None else w.element_size()))
        return torch.empty(T, d, dtype=src.dtype, device=src.device)
    if src.device.type == "cpu":
        return combine_topk_plain(src, idx, w)
    _build.require_cuda("combine_topk", src, idx, *(() if w is None else (w,)))
    code = _build.dtype_code("combine_topk", src)
    wcode = -1 if w is None else _build.dtype_code("combine_topk weights", w)
    if (src.dim() != 2 or idx.dim() != 2 or idx.dtype != torch.int32
            or (w is not None and w.shape != idx.shape)):
        raise ValueError(f"combine_topk: src (M, d), idx (T, k) int32 and w "
                         f"(T, k) or None, got {tuple(src.shape)}, "
                         f"{tuple(idx.shape)} {idx.dtype}, "
                         f"{None if w is None else tuple(w.shape)}")
    M, d = src.shape
    T, k = idx.shape
    y = torch.empty(T, d, dtype=src.dtype, device=src.device)
    if T and d:
        lib = _lib()
        rc = lib.combine_topk(src.data_ptr(), idx.data_ptr(),
                              None if w is None else w.data_ptr(),
                              y.data_ptr(), T, k, M, d, code, wcode,
                              _build.SMS, _build.stream_of(src))
        _build.check(lib, rc, "combine_topk")
        combine_topk.launches += 1
    return y


gather_rows.launches = 0
gather_rows_by_source.launches = 0
combine_topk.launches = 0
