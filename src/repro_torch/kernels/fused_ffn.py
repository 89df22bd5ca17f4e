"""Fused expert FFN — grouped GEMM1 + activation + grouped GEMM2 in one
kernel, hand-written for Hopper in ``csrc/fused_ffn.cu``.

``y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g]`` for rows sorted
by group.  The (M, H) hidden activation never reaches device memory; it is
rounded to the working dtype before the second product (so fused matches
two-pass in bf16).  The hidden dimension of a row tile is split over
several blocks that write f32 partials, summed in order by a second small
kernel.  Same group / zero-row contract as ``grouped_gemm``.

Two kernels: bf16 with K, H and N multiples of 8 and 16-byte aligned
operands (every model shape) runs the weight-streaming ring kernel, with
its row tile, hidden chunk and split from :func:`plan`; f32 and other
shapes run the simple kernel (:func:`fused_ffn_simple`).  :func:`route`
makes the choice on the host from dtype and shape alone.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, cost
from repro_torch.kernels.grouped_gemm import rows_matmul

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"fused_ffn": [_P] * 7 + [_I] * 9 + [_P],
         "fused_ffn_simple": [_P] * 7 + [_I] * 8 + [_P],
         "fused_ffn_smem": [_I] * 3}
ACTS = {"swiglu": 0, "gelu": 1, "rwkv": 2, "silu": 3}
ROW_TILES = (16, 32, 64)  # the ring kernel's row tiles
HIDDEN_CHUNKS = (256, 128, 64)  # its hidden columns a block, largest first
SIMPLE_BM, SIMPLE_BH = 16, 128  # row tile and hidden tile of the simple kernel


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
    inputs, ``grouped_gemm.rows_matmul``), the hidden rounded to x's dtype
    before the second product; rows past the groups are zero."""
    check_gating(ws, act)
    M = x.shape[0]
    acc = torch.promote_types(x.dtype, torch.float32)
    y = torch.zeros(M, wo.shape[2], dtype=x.dtype, device=x.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, M)
        if end > start:
            xe = x[start:end].to(acc)
            g = rows_matmul(xe, ws[0][e].to(acc))
            u = rows_matmul(xe, ws[1][e].to(acc)) if len(ws) == 2 else None
            h = activate(g, u, act).to(x.dtype).to(acc)
            y[start:end] = rows_matmul(h, wo[e].to(acc)).to(x.dtype)
        start = end
    return y


class Plan(NamedTuple):
    """The ring kernel's tiling: ``bm`` rows of one expert and ``hc``
    hidden columns a block, ``splits = ceil(H / hc)`` blocks per row tile,
    each writing an f32 partial of (M, N)."""
    bm: int
    hc: int
    splits: int


def plan(M: int, E: int, H: int, gated: bool = False,
         split_rows: int = 0, split_groups: int = 0) -> Plan:
    """The ring kernel's tiles for M rows over E experts and hidden H.

    ``split_rows`` (0 = M) and ``split_groups`` (0 = E) are the row and
    expert counts the hidden split is planned for: a launch on a part of a
    larger buffer (a micro-shard of the §5.2 schedule, the owned or the
    shadowed experts of a placed psum layer) passes the whole buffer's, so
    every row sums the same f32 partials in the same order as in the
    whole buffer's launch.  The row tile ``bm`` follows M and E and does
    not change a row's arithmetic.

    ``bm`` is the smallest row tile that holds an expert of average size
    (ceil(M / E) rows, at most 64), so an expert's weights are streamed
    once rather than once per 16 rows.  ``hc`` is the largest hidden chunk
    (256, 128, 64; at most 128 when gated: two GEMM1 accumulators) whose
    split gives the grid at least two blocks per SM — counting one row tile
    per expert the rows can reach (min(M, E)) or per ``bm`` rows, whichever
    is more; each split adds an f32 (M, N) partial to write and read back,
    so no more splits than that."""
    def row_tile(m, e):
        per_group = math.ceil(m / max(e, 1))
        return next((b for b in ROW_TILES if b >= per_group), ROW_TILES[-1])

    S, G = split_rows or M, split_groups or E
    row_tiles = max(math.ceil(S / row_tile(S, G)), min(S, G), 1)
    chunks = [c for c in HIDDEN_CHUNKS if not (gated and c > 128)]
    hc = next((c for c in chunks
               if row_tiles * math.ceil(H / c) >= 2 * _build.SMS), chunks[-1])
    return Plan(row_tile(M, E), hc, math.ceil(H / hc))


def route(x: torch.Tensor, ws: tuple, wo: torch.Tensor) -> str:
    """"ring" for bf16 with K, H and N multiples of 8 and 16-byte aligned
    x and weights, else "simple"."""
    K, H, N = x.shape[1], ws[0].shape[2], wo.shape[2]
    if (all(t.dtype == torch.bfloat16 for t in (x, *ws, wo))
            and K % 8 == 0 and H % 8 == 0 and N % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *ws, wo))):
        return "ring"
    return "simple"


def simple_splits(M: int, E: int, H: int) -> int:
    """The hidden-tile split of the simple kernel and of the backward's dX
    kernel (both 16-row, 128-hidden tiles): enough blocks for about two per
    SM, never more splits than hidden tiles."""
    tiles = max(1, min(math.ceil(M / SIMPLE_BM) + E, M))
    return max(1, min(math.ceil(H / SIMPLE_BH), math.ceil(2 * _build.SMS / tiles)))


def _check(what, x, ws, wo, group_sizes, act):
    check_gating(ws, act)
    _build.require_cuda(what, x, *ws, wo, group_sizes)
    M, K = x.shape
    E, K2, H = ws[0].shape
    E2, H2, N = wo.shape
    if (any(w.dtype != x.dtype or w.shape != ws[0].shape for w in (*ws,))
            or wo.dtype != x.dtype or (K2, E2, H2) != (K, E, H)
            or group_sizes.shape != (E,) or group_sizes.dtype != torch.int32):
        raise ValueError(f"{what}: x (M, K), ws (E, K, H), wo (E, H, N) of "
                         f"one dtype, group_sizes (E,) int32; got "
                         f"{tuple(x.shape)}, {[tuple(w.shape) for w in ws]}, "
                         f"{tuple(wo.shape)}, {tuple(group_sizes.shape)}")
    return M, K, H, N, E


def fused_ffn_simple(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                     group_sizes: torch.Tensor, act: str,
                     plan_rows: int = 0, plan_groups: int = 0) -> torch.Tensor:
    """The simple kernel (f32 or bf16, any K, H, N): :func:`fused_ffn`'s
    route for f32 and for shapes the ring kernel does not take."""
    M, K, H, N, E = _check("fused_ffn_simple", x, ws, wo, group_sizes, act)
    code = _build.dtype_code("fused_ffn_simple", x)
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M and N:
        lib = _build.load("fused_ffn", _SIGS)
        splits = simple_splits(plan_rows or M, plan_groups or E, H)
        partial = torch.empty(splits, M, N, dtype=torch.float32,
                              device=x.device)
        wu = ws[1].data_ptr() if len(ws) == 2 else None
        rc = lib.fused_ffn_simple(x.data_ptr(), ws[0].data_ptr(), wu,
                                  wo.data_ptr(), group_sizes.data_ptr(),
                                  partial.data_ptr(), y.data_ptr(), M, K, H, N,
                                  E, ACTS[act], splits, code,
                                  _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn_simple")
        fused_ffn_simple.launches += 1
        fused_ffn.launches += 1
    return y


def fused_ffn(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
              group_sizes: torch.Tensor, act: str,
              plan_rows: int = 0, plan_groups: int = 0) -> torch.Tensor:
    """x (M, K); ws (wi,) or (wi_gate, wi_up), each (E, K, H); wo (E, H, N);
    group_sizes (E,) int32 summing to <= M.  ``plan_rows`` (0 = M) and
    ``plan_groups`` (0 = E): the rows and experts the hidden split is
    planned for (:func:`plan`'s ``split_rows`` and ``split_groups``).
    ``fused_ffn.launches`` counts every kernel launch,
    ``fused_ffn_simple.launches`` the simple kernel's.  Meta tensors (the
    dry run) allocate the output and the f32 hidden-split partials the
    route's kernel would, and enter its work in ``kernels.cost``."""
    if _build.all_meta(x, *ws, wo, group_sizes):
        return _meta(x, ws, wo, group_sizes, plan_rows, plan_groups)
    if x.device.type == "cpu":
        return fused_ffn_plain(x, ws, wo, group_sizes, act)
    M, K, H, N, E = _check("fused_ffn", x, ws, wo, group_sizes, act)
    if route(x, ws, wo) == "simple":
        return fused_ffn_simple(x, ws, wo, group_sizes, act, plan_rows,
                                plan_groups)
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M and N:
        lib = _build.load("fused_ffn", _SIGS)
        p = plan(M, E, H, gated=len(ws) == 2, split_rows=plan_rows,
                 split_groups=plan_groups)
        partial = torch.empty(p.splits, M, N, dtype=torch.float32,
                              device=x.device)
        wu = ws[1].data_ptr() if len(ws) == 2 else None
        rc = lib.fused_ffn(x.data_ptr(), ws[0].data_ptr(), wu, wo.data_ptr(),
                           group_sizes.data_ptr(), partial.data_ptr(),
                           y.data_ptr(), M, K, H, N, E, ACTS[act], p.bm, p.hc,
                           p.splits, _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn")
        fused_ffn.launches += 1
    return y


def _meta(x, ws, wo, group_sizes, plan_rows, plan_groups):
    M, K = x.shape
    E, _, H = ws[0].shape
    N = wo.shape[2]
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    if M and N:
        splits = (plan(M, E, H, gated=len(ws) == 2, split_rows=plan_rows,
                       split_groups=plan_groups).splits
                  if route(x, ws, wo) == "ring"
                  else simple_splits(plan_rows or M, plan_groups or E, H))
        partial = torch.empty(splits, M, N, dtype=torch.float32,
                              device=x.device)
        del partial
        cost.add("fused_ffn", *cost.fused_ffn(
            M, K, H, N, E, *cost.groups_of(group_sizes, M), len(ws),
            x.element_size()))
    return y


fused_ffn.launches = 0
fused_ffn_simple.launches = 0
