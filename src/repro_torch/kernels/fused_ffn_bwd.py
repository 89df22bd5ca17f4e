"""Fused expert-FFN backward — dX and grouped dW without the (M, H) hidden,
hand-written for Hopper in ``csrc/fused_ffn_bwd.cu``.

For ``y[i] = act(x[i] @ wi[g]) [* (x[i] @ wi_up[g])] @ wo[g]`` and the
incoming ``dy``, both kernels recompute each hidden tile on chip:

    g, u   = x @ wi[:, j], x @ wi_up[:, j]      f32
    dh     = dy @ wo[j, :]^T                    f32
    h      = act(g, u)                          rounded to x's dtype
    dg, du = act'(g, u) * dh                    rounded to x's dtype

``fused_ffn_bwd_dx``: ``dx = sum_j dg @ wi[:, j]^T [+ du @ wi_up[:, j]^T]``,
accumulated in f32 and rounded once to x's dtype; rows past
``sum(group_sizes)`` are zero.  ``fused_ffn_bwd_dw``: ``dwo[g] = h^T @ dy``
and ``dwi[g] = x^T @ dg`` (``dwi_up``: du) in f32; experts without rows get
zeros.  The roundings are those of ``repro/kernels/fused_ffn_bwd.py``; the
caller (``ops.fused_grouped_ffn``) casts the dW to the weight dtype.

Two kernels each: bf16 with K, H and N multiples of 8 and 16-byte aligned
operands (every model shape) runs the ring kernels, dX with its row tile
and split from :func:`plan_bwd`; f32 and other shapes run
the first versions (:func:`fused_ffn_bwd_dx_simple`,
:func:`fused_ffn_bwd_dw_simple`).  :func:`route` makes the choice on the
host from dtype, shape and alignment alone.

Each wrapper runs its kernel on CUDA tensors (raising if it cannot) and its
plain PyTorch version on CPU tensors; ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, cost
from repro_torch.kernels import fused_ffn as ff

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGS = {"fused_ffn_bwd_dx": [_P] * 8 + [_I] * 8 + [_P],
         "fused_ffn_bwd_dw": [_P] * 9 + [_I] * 6 + [_P],
         "fused_ffn_bwd_dx_simple": [_P] * 8 + [_I] * 8 + [_P],
         "fused_ffn_bwd_dw_simple": [_P] * 9 + [_I] * 7 + [_P],
         "fused_ffn_bwd_smem": [_I] * 3}
DX_CHUNK = 256  # the dX ring kernel's hidden columns a block
DW_CHUNK = 128  # the dW ring kernel's
DW_ROWS = 64  # rows of an expert the dW kernel takes at a time
BLOCKS_PER_SM = 2  # of both ring kernels, ungated (one gated)
_LDT = 72  # a 64-column tile's row in shared memory (bf16 elements)
_GELU_C, _GELU_A = 0.7978845608028654, 0.044715  # sqrt(2 / pi), tanh-form cubic


def act_vjp(g: torch.Tensor, u, dh: torch.Tensor, act: str):
    """(dg, du) of h = ff.activate(g, u, act) for the incoming dh; du is None
    unless swiglu.  The derivatives are written out as the kernel has them
    (csrc/common.cuh ``activate_vjp``)."""
    if act == "gelu":
        t = torch.tanh(_GELU_C * (g + _GELU_A * g * g * g))
        return dh * (0.5 * (1 + t) + 0.5 * g * (1 - t * t) * _GELU_C
                     * (1 + 3 * _GELU_A * g * g)), None
    if act == "rwkv":
        return 2 * F.relu(g) * dh, None
    s = torch.sigmoid(g)
    dsilu = s * (1 + g * (1 - s))
    if act == "swiglu":
        return dh * u * dsilu, dh * F.silu(g)
    return dh * dsilu, None


def _acc(t: torch.Tensor) -> torch.dtype:
    """Accumulation dtype: f32 for bf16/f32 inputs (f64 stays f64)."""
    return torch.promote_types(t.dtype, torch.float32)


def _recompute(xe, dye, ws, wo_e, act, dtype):
    """Per-group recompute: (h, dg, du) rounded to ``dtype``, in f32."""
    acc = xe.dtype
    g = xe @ ws[0].to(acc)
    u = xe @ ws[1].to(acc) if len(ws) == 2 else None
    dh = dye @ wo_e.to(acc).T
    dg, du = act_vjp(g, u, dh, act)
    h = ff.activate(g, u, act)

    def rnd(t):
        return None if t is None else t.to(dtype).to(acc)
    return rnd(h), rnd(dg), rnd(du)


def _groups(group_sizes: torch.Tensor, M: int):
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        end = min(start + size, M)
        yield e, start, end
        start = end


def fused_ffn_bwd_dx_plain(x, ws, wo, dy, group_sizes, act):
    """The dX kernel's arithmetic in plain PyTorch, one group at a time."""
    ff.check_gating(ws, act)
    acc = _acc(x)
    dx = torch.zeros_like(x)
    for e, s, t in _groups(group_sizes, x.shape[0]):
        if t <= s:
            continue
        xe, dye = x[s:t].to(acc), dy[s:t].to(acc)
        _, dg, du = _recompute(xe, dye, [w[e] for w in ws], wo[e], act, x.dtype)
        d = dg @ ws[0][e].to(acc).T
        if du is not None:
            d = d + du @ ws[1][e].to(acc).T
        dx[s:t] = d.to(x.dtype)
    return dx


def fused_ffn_bwd_dw_plain(x, ws, wo, dy, group_sizes, act):
    """The dW kernel's arithmetic in plain PyTorch: ((dwi[, dwi_up]), dwo)
    in f32 (f64 for f64 inputs), zeros for experts without rows."""
    ff.check_gating(ws, act)
    acc = _acc(x)
    dws = tuple(torch.zeros(w.shape, dtype=acc, device=x.device) for w in ws)
    dwo = torch.zeros(wo.shape, dtype=acc, device=x.device)
    for e, s, t in _groups(group_sizes, x.shape[0]):
        if t <= s:
            continue
        xe, dye = x[s:t].to(acc), dy[s:t].to(acc)
        h, dg, du = _recompute(xe, dye, [w[e] for w in ws], wo[e], act, x.dtype)
        dwo[e] = h.T @ dye
        dws[0][e] = xe.T @ dg
        if du is not None:
            dws[1][e] = xe.T @ du
    return dws, dwo


class BwdPlan(NamedTuple):
    """The dX ring kernel's tiling: ``bm`` rows of one expert and DX_CHUNK
    hidden columns a block, ``splits = ceil(H / DX_CHUNK)`` blocks per row
    tile, each writing an f32 partial of (M, K).  (A dW block takes
    DW_CHUNK hidden columns of one expert, its rows DW_ROWS at a time.)"""
    bm: int
    splits: int


def dx_smem(bm: int, gated: bool) -> int:
    """Dynamic shared memory of the dX ring kernel (``DxShipped``): its
    ring stages (two; three gated), each the largest of an x step (x's k
    tile and the (64 x 128) wi tile [and wi_up's]), a y step (dy's n tile
    and wo's (128 x 64) tile) and a phase-B step (wi's (128 x 64) tile
    [and wi_up's]), then dg [du] of the chunk (bm x DX_CHUNK), all bf16."""
    nw = 2 if gated else 1
    step = max(bm * _LDT + 64 * 136 * nw, bm * _LDT + 128 * _LDT, 128 * _LDT * nw)
    return 2 * ((3 if gated else 2) * step + bm * (DX_CHUNK + 8) * nw)


def dw_smem(gated: bool) -> int:
    """Dynamic shared memory of the dW ring kernel (``DwShipped``): three
    ring stages (a DW_ROWS-row x or dy tile with a (64 x 64) weight tile
    [and wi_up's]), then h, dg [du] of a batch (DW_ROWS x DW_CHUNK), all
    bf16."""
    nw = 2 if gated else 1
    step = DW_ROWS * _LDT + 64 * _LDT * nw
    return 2 * (3 * step + DW_ROWS * (DW_CHUNK + 8) * (nw + 1))


def plan_bwd(M: int, E: int, H: int) -> BwdPlan:
    """The dX ring kernel's tiles for M rows over E experts and hidden H:
    the forward's row tile (``fused_ffn.plan``: the smallest that holds an
    expert of average size) and one split per DX_CHUNK hidden columns.
    Each split adds an f32 (M, K) partial, written once and read back once;
    the chunk's dg [du] waits in shared memory, not registers, so the chunk
    is as wide as two blocks an SM allow (at the training rows the splits
    still give the grid more than two waves of them)."""
    return BwdPlan(ff.plan(M, E, H).bm, math.ceil(H / DX_CHUNK))


def route(x: torch.Tensor, ws: tuple, wo: torch.Tensor, dy: torch.Tensor) -> str:
    """"ring" for bf16 with K, H and N multiples of 8 and 16-byte aligned
    x, weights and dy, else "simple"."""
    if (ff.route(x, ws, wo) == "ring" and dy.dtype == torch.bfloat16
            and dy.data_ptr() % 16 == 0):
        return "ring"
    return "simple"


def _check(what, x, ws, wo, dy, group_sizes, act):
    ff.check_gating(ws, act)
    _build.require_cuda(what, x, *ws, wo, dy, group_sizes)
    M, K = x.shape
    E, K2, H = ws[0].shape
    E2, H2, N = wo.shape
    if (any(w.dtype != x.dtype or w.shape != ws[0].shape for w in ws)
            or wo.dtype != x.dtype or dy.dtype != x.dtype
            or (K2, E2, H2) != (K, E, H) or dy.shape != (M, N)
            or group_sizes.shape != (E,) or group_sizes.dtype != torch.int32):
        raise ValueError(f"{what}: x (M, K), ws (E, K, H), wo (E, H, N), dy "
                         f"(M, N) of one dtype, group_sizes (E,) int32; got "
                         f"{tuple(x.shape)}, {[tuple(w.shape) for w in ws]}, "
                         f"{tuple(wo.shape)}, {tuple(dy.shape)} {dy.dtype}, "
                         f"{tuple(group_sizes.shape)}")
    return M, K, H, N, E, _build.dtype_code(what, x)


def _weights(ws):
    """(wi, wi_up or None) pointers."""
    return ws[0].data_ptr(), ws[1].data_ptr() if len(ws) == 2 else None


def fused_ffn_bwd_dx_simple(x, ws, wo, dy, group_sizes, act, plan_rows=0,
                            plan_groups=0):
    """The first-version dX kernel (f32 or bf16, any K, H, N):
    :func:`fused_ffn_bwd_dx`'s route for f32 and for shapes the ring kernel
    does not take."""
    M, K, H, N, E, code = _check("fused_ffn_bwd_dx_simple", x, ws, wo, dy,
                                 group_sizes, act)
    dx = torch.empty_like(x)
    if M and K:
        lib = _build.load("fused_ffn_bwd", _SIGS)
        splits = ff.simple_splits(plan_rows or M, plan_groups or E, H)
        partial = torch.empty(splits, M, K, dtype=torch.float32,
                              device=x.device)
        wi, wu = _weights(ws)
        rc = lib.fused_ffn_bwd_dx_simple(
            x.data_ptr(), wi, wu, wo.data_ptr(), dy.data_ptr(),
            group_sizes.data_ptr(), partial.data_ptr(), dx.data_ptr(), M, K, H,
            N, E, ff.ACTS[act], splits, code, _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn_bwd_dx_simple")
        fused_ffn_bwd_dx_simple.launches += 1
        fused_ffn_bwd_dx.launches += 1
    return dx


def fused_ffn_bwd_dx(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                     dy: torch.Tensor, group_sizes: torch.Tensor,
                     act: str, plan_rows: int = 0,
                     plan_groups: int = 0) -> torch.Tensor:
    """dX (M, K) in x's dtype; x (M, K), ws (wi,) or (wi_gate, wi_up) each
    (E, K, H), wo (E, H, N), dy (M, N), group_sizes (E,) int32.  The ring
    kernel's split depends on neither M nor E; ``plan_rows`` (0 = M) and
    ``plan_groups`` (0 = E) pin the first version's (``fused_ffn.
    fused_ffn``'s arguments).
    ``fused_ffn_bwd_dx.launches`` counts every kernel launch,
    ``fused_ffn_bwd_dx_simple.launches`` the first version's.  Meta
    tensors (the dry run) allocate dX and the route's f32 split partials
    and enter the kernel's work in ``kernels.cost``."""
    if _build.all_meta(x, *ws, wo, dy, group_sizes):
        return _meta_dx(x, ws, wo, dy, group_sizes, plan_rows, plan_groups)
    if x.device.type == "cpu":
        return fused_ffn_bwd_dx_plain(x, ws, wo, dy, group_sizes, act)
    M, K, H, N, E, _ = _check("fused_ffn_bwd_dx", x, ws, wo, dy, group_sizes,
                              act)
    if route(x, ws, wo, dy) == "simple":
        return fused_ffn_bwd_dx_simple(x, ws, wo, dy, group_sizes, act,
                                       plan_rows, plan_groups)
    dx = torch.empty_like(x)
    if M and K:
        lib = _build.load("fused_ffn_bwd", _SIGS)
        p = plan_bwd(M, E, H)
        partial = torch.empty(p.splits, M, K, dtype=torch.float32,
                              device=x.device)
        wi, wu = _weights(ws)
        rc = lib.fused_ffn_bwd_dx(x.data_ptr(), wi, wu, wo.data_ptr(),
                                  dy.data_ptr(), group_sizes.data_ptr(),
                                  partial.data_ptr(), dx.data_ptr(), M, K, H,
                                  N, E, ff.ACTS[act], p.bm, p.splits,
                                  _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn_bwd_dx")
        fused_ffn_bwd_dx.launches += 1
    return dx


def _dw_outputs(x, ws, wo):
    dws = tuple(torch.empty(w.shape, dtype=torch.float32, device=x.device)
                for w in ws)
    return dws, torch.empty(wo.shape, dtype=torch.float32, device=x.device)


def fused_ffn_bwd_dw_simple(x, ws, wo, dy, group_sizes, act):
    """The first-version dW kernel (f32 or bf16, any K, H, N):
    :func:`fused_ffn_bwd_dw`'s route for f32 and for shapes the ring kernel
    does not take."""
    M, K, H, N, E, code = _check("fused_ffn_bwd_dw_simple", x, ws, wo, dy,
                                 group_sizes, act)
    dws, dwo = _dw_outputs(x, ws, wo)
    if E and H and (K or N):
        lib = _build.load("fused_ffn_bwd", _SIGS)
        wi, wu = _weights(ws)
        rc = lib.fused_ffn_bwd_dw_simple(
            x.data_ptr(), wi, wu, wo.data_ptr(), dy.data_ptr(),
            group_sizes.data_ptr(), dws[0].data_ptr(),
            dws[1].data_ptr() if len(ws) == 2 else None, dwo.data_ptr(), M, K,
            H, N, E, ff.ACTS[act], code, _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn_bwd_dw_simple")
        fused_ffn_bwd_dw_simple.launches += 1
        fused_ffn_bwd_dw.launches += 1
    return dws, dwo


def fused_ffn_bwd_dw(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                     dy: torch.Tensor, group_sizes: torch.Tensor, act: str):
    """((dwi[, dwi_up]), dwo) in f32, shapes of ws and wo; same inputs as
    :func:`fused_ffn_bwd_dx`.  ``fused_ffn_bwd_dw.launches`` counts every
    kernel launch, ``fused_ffn_bwd_dw_simple.launches`` the first
    version's.  Meta tensors (the dry run): the f32 dW allocated, the work
    entered in ``kernels.cost``."""
    if _build.all_meta(x, *ws, wo, dy, group_sizes):
        M, K = x.shape
        E, _, H = ws[0].shape
        cost.add("fused_ffn_bwd_dw", *cost.fused_ffn_bwd_dw(
            M, K, H, wo.shape[2], E, *cost.groups_of(group_sizes, M),
            len(ws), x.element_size()))
        return _dw_outputs(x, ws, wo)
    if x.device.type == "cpu":
        return fused_ffn_bwd_dw_plain(x, ws, wo, dy, group_sizes, act)
    M, K, H, N, E, _ = _check("fused_ffn_bwd_dw", x, ws, wo, dy, group_sizes,
                              act)
    if route(x, ws, wo, dy) == "simple":
        return fused_ffn_bwd_dw_simple(x, ws, wo, dy, group_sizes, act)
    dws, dwo = _dw_outputs(x, ws, wo)
    if E and H and (K or N):
        lib = _build.load("fused_ffn_bwd", _SIGS)
        wi, wu = _weights(ws)
        rc = lib.fused_ffn_bwd_dw(x.data_ptr(), wi, wu, wo.data_ptr(),
                                  dy.data_ptr(), group_sizes.data_ptr(),
                                  dws[0].data_ptr(),
                                  dws[1].data_ptr() if len(ws) == 2 else None,
                                  dwo.data_ptr(), M, K, H, N, E, ff.ACTS[act],
                                  _build.stream_of(x))
        _build.check(lib, rc, "fused_ffn_bwd_dw")
        fused_ffn_bwd_dw.launches += 1
    return dws, dwo


def _meta_dx(x, ws, wo, dy, group_sizes, plan_rows, plan_groups):
    M, K = x.shape
    E, _, H = ws[0].shape
    dx = torch.empty_like(x)
    if M and K:
        splits = (plan_bwd(M, E, H).splits if route(x, ws, wo, dy) == "ring"
                  else ff.simple_splits(plan_rows or M, plan_groups or E, H))
        partial = torch.empty(splits, M, K, dtype=torch.float32,
                              device=x.device)
        del partial
        cost.add("fused_ffn_bwd_dx", *cost.fused_ffn_bwd_dx(
            M, K, H, wo.shape[2], E, *cost.groups_of(group_sizes, M),
            len(ws), x.element_size()))
    return dx


fused_ffn_bwd_dx.launches = 0
fused_ffn_bwd_dx_simple.launches = 0
fused_ffn_bwd_dw.launches = 0
fused_ffn_bwd_dw_simple.launches = 0
