"""Grouped GEMM — FastMoE's FMoELinear (paper §3.1/§4), hand-written for
Hopper in ``csrc/grouped_gemm.cu``.

``y[i] = x[i] @ w[g(i)]`` for rows ``x`` sorted by group, accumulated in f32
and rounded once to the working dtype; with ``trans_w`` the weights are read
transposed (``x[i] @ w[g(i)]^T``, the backward's dX, on the forward's
weights in place).  The kernel takes the group sizes as
they are (no padding of groups to row tiles): each block finds its group and
row range itself, so an expert with no rows is never read.  Rows beyond
``sum(group_sizes)`` come out as zero.

Two kernels: bf16 with K and N multiples of 8 and 16-byte aligned
operands (every model shape) runs the ring-buffered ``mma.sync`` kernel,
with its tile shape from :func:`tile_config`; f32 and other shapes run
the simple kernel (:func:`grouped_gemm_simple`).  :func:`route` makes the
choice on the host from dtype and shape alone, and each kernel keeps its
own launch count.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, cost

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"grouped_gemm": [_P, _P, _P, _P] + [_I] * 7 + [_P],
         "grouped_gemm_simple": [_P, _P, _P, _P] + [_I] * 6 + [_P]}
ROW_TILES = (16, 32, 64)


def tile_config(M: int, N: int, E: int) -> tuple[int, int]:
    """(BM, BN) of the ring kernel for M rows over E groups into N columns.

    BM is the smallest row tile that holds a group of average size
    (ceil(M / E) rows), so decode's 1-2 rows per expert are not a 64-row
    tile of padding; BN is 128, or 64 where 128-wide column tiles would
    give fewer than two blocks per SM."""
    per_group = math.ceil(M / max(E, 1))
    bm = next((b for b in ROW_TILES if b >= per_group), ROW_TILES[-1])
    row_tiles = max(math.ceil(M / bm), min(M, E))
    bn = 128 if row_tiles * math.ceil(N / 128) >= 2 * _build.SMS else 64
    return bm, bn


def route(x: torch.Tensor, w: torch.Tensor, trans_w: bool = False) -> str:
    """"mma" (the ring kernel) for bf16 with K and N multiples of 8 and
    16-byte aligned x and w, else "simple"."""
    K = x.shape[1]
    N = w.shape[1] if trans_w else w.shape[2]
    if (x.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and K % 8 == 0 and N % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0):
        return "mma"
    return "simple"


def rows_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` computed so that a row's result does not depend on how many
    rows ``a`` has, as the kernels' rows do not: torch's CPU matmul takes a
    matrix-vector route for a single row, whose last bit differs from the
    same row's in a taller product, so one row is computed as two.  (At
    the widths of the CPU tests a taller product keeps each row's sum;
    wider ones may block by the row count as well.)"""
    if a.shape[0] == 1 and a.device.type == "cpu":
        return (a.expand(2, -1) @ b)[:1]
    return a @ b


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor,
                       trans_w: bool = False) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: one f32 product per group
    (f64 for f64 inputs, :func:`rows_matmul`), rounded to x's dtype; rows
    past the groups are zero."""
    M = x.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros(M, w.shape[1 if trans_w else 2], dtype=x.dtype,
                    device=x.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, M)
        if end > start:
            we = w[e].T if trans_w else w[e]
            y[start:end] = rows_matmul(x[start:end].to(acc),
                                       we.to(acc)).to(x.dtype)
        start = end
    return y


def grouped_dw_plain(x: torch.Tensor, dy: torch.Tensor,
                     group_sizes: torch.Tensor, num_groups: int) -> torch.Tensor:
    """dW of the grouped product, ``dw[e] = x_e^T @ dy_e`` in f32 (f64 for
    f64 inputs), one plain product per group; rows past the groups are not
    read.  The port's counterpart of the ``ragged_dot`` VJP the JAX package
    takes for it (not a Pallas kernel there)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    dw = torch.zeros(num_groups, x.shape[1], dy.shape[1], dtype=acc,
                     device=x.device)
    if _build.all_meta(x, dy, group_sizes):  # the dry run: even groups
        M = x.shape[0]
        cost.add("grouped_dw", *cost.grouped_dw(
            M, x.shape[1], dy.shape[1], num_groups, M, x.element_size()))
        return dw
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, x.shape[0])
        if end > start:
            dw[e] = x[start:end].to(acc).T @ dy[start:end].to(acc)
        start = end
    return dw


def _check(what, x, w, group_sizes, trans_w):
    _build.require_cuda(what, x, w, group_sizes)
    M, K = x.shape
    E, K2, N = (w.shape[0], w.shape[2], w.shape[1]) if trans_w else w.shape
    if (w.dtype != x.dtype or K2 != K or group_sizes.shape != (E,)
            or group_sizes.dtype != torch.int32):
        raise ValueError(f"{what}: x (M, K), w (E, K, N) (or (E, N, K) "
                         f"with trans_w) of one dtype, "
                         f"group_sizes (E,) int32; got {tuple(x.shape)} "
                         f"{x.dtype}, {tuple(w.shape)} {w.dtype}, "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    return M, K, N, E


def grouped_gemm_simple(x: torch.Tensor, w: torch.Tensor,
                        group_sizes: torch.Tensor,
                        trans_w: bool = False) -> torch.Tensor:
    """The simple kernel (f32 or bf16, any K and N): :func:`grouped_gemm`'s
    route for f32 and for shapes the ring kernel does not take."""
    M, K, N, E = _check("grouped_gemm_simple", x, w, group_sizes, trans_w)
    code = _build.dtype_code("grouped_gemm_simple", x)
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M and N:
        lib = _build.load("grouped_gemm", _SIGS)
        rc = lib.grouped_gemm_simple(x.data_ptr(), w.data_ptr(),
                                     group_sizes.data_ptr(), y.data_ptr(), M,
                                     K, N, E, int(trans_w), code,
                                     _build.stream_of(x))
        _build.check(lib, rc, "grouped_gemm_simple")
        grouped_gemm_simple.launches += 1
    return y


def grouped_gemm(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                 trans_w: bool = False) -> torch.Tensor:
    """y[i] = x[i] @ w[g(i)]; x (M, K), w (E, K, N) — or (E, N, K) with
    ``trans_w``, read as its transpose —, group_sizes (E,) int32 summing to
    <= M.  ``grouped_gemm.launches`` counts the ring kernel's launches.
    Meta tensors (the dry run) take the meta branch: the output allocated
    and the work entered in ``kernels.cost``, nothing computed."""
    if _build.all_meta(x, w, group_sizes):
        M, K = x.shape
        E, N = w.shape[0], (w.shape[1] if trans_w else w.shape[2])
        cost.add("grouped_gemm", *cost.grouped_gemm(
            M, K, N, E, *cost.groups_of(group_sizes, M), x.element_size()))
        return torch.empty(M, N, dtype=x.dtype, device=x.device)
    if x.device.type == "cpu":
        return grouped_gemm_plain(x, w, group_sizes, trans_w)
    M, K, N, E = _check("grouped_gemm", x, w, group_sizes, trans_w)
    if route(x, w, trans_w) == "simple":
        return grouped_gemm_simple(x, w, group_sizes, trans_w)
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M and N:
        bm, bn = tile_config(M, N, E)
        lib = _build.load("grouped_gemm", _SIGS)
        rc = lib.grouped_gemm(x.data_ptr(), w.data_ptr(), group_sizes.data_ptr(),
                              y.data_ptr(), M, K, N, E, int(trans_w), bm, bn,
                              _build.stream_of(x))
        _build.check(lib, rc, "grouped_gemm")
        grouped_gemm.launches += 1
    return y


grouped_gemm.launches = 0
grouped_gemm_simple.launches = 0
