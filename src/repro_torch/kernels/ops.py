"""The ops layer over the kernels, differentiable, with the JAX ``ops``
contracts:

* rows beyond ``sum(group_sizes)`` come out as zero on every impl (and must
  arrive zero-filled: the dW products read whole groups only, but the
  forward kernels' zero rows rely on it);
* ``check_gating``: swiglu takes (wi_gate, wi_up), every other act (wi,);
* acts: swiglu, gelu (tanh form), rwkv (squared ReLU), silu.

Each op is a ``torch.autograd.Function`` whose backward runs kernels too:

* ``grouped_matmul`` — dX is the grouped-GEMM kernel reading ``w``
  transposed in place; dW is the plain per-group product
  (``grouped_gemm.grouped_dw_plain``), as the JAX package leaves it to
  ``ragged_dot``'s VJP;
* ``fused_grouped_ffn`` — the fused dX and grouped dW kernels
  (``kernels.fused_ffn_bwd``); dW is cast to the weight dtype as
  ``repro/kernels/ops.py`` ``_ffn_bwd`` does;
* ``gather_tokens`` / ``combine_tokens`` — each one's backward is the other
  kernel (``gather_rows_any``, expert-choice's gather of a variable count
  of rows a token, sums them by ``combine_topk`` too): the gradient of a gather of every token into its k rows is the
  sum of those rows (``combine_topk`` with weights of 1, over the ragged
  plan's ``slot_rows`` where the caller passes them), and the gradient of
  the gate-weighted combine with respect to its rows is each row's token
  gradient times its weight (``combine_topk`` with k = 1);
* ``flash_attention`` — the forward kernel saves (q, k, v, o, lse) and
  nothing of size (Sq, Skv); the backward kernels recompute the
  probabilities from the per-row log-sum-exp (the reference has no
  backward kernel: XLA differentiates its jnp blockwise scan).

``impl="pallas"`` runs the hand-written kernel (the port of the Pallas
kernel; on CPU tensors its plain version); ``impl="plain"`` runs the plain
PyTorch grouped product, the port's counterpart of XLA's ``ragged_dot``.
The JAX tiling arguments (``bm``, ``bh``, ``aligned``) have no counterpart:
the Hopper kernels take the group sizes directly, so no call pads groups.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ffn as ff
from repro_torch.kernels import fused_ffn_bwd as fb
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import token_shuffle as ts


def _gm(x, w, group_sizes, impl, trans_w=False):
    if impl == "pallas":
        return gg.grouped_gemm(x, w, group_sizes, trans_w)
    if impl == "plain":
        return gg.grouped_gemm_plain(x, w, group_sizes, trans_w)
    raise ValueError(f"unknown grouped_matmul impl {impl!r}")


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, group_sizes, impl):
        ctx.save_for_backward(x, w, group_sizes)
        ctx.impl = impl
        return _gm(x, w, group_sizes, impl)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:  # dX = dy @ w^T, kernel-served
            dx = _gm(dy, w, group_sizes, ctx.impl, trans_w=True)
        if ctx.needs_input_grad[1]:
            dw = gg.grouped_dw_plain(x, dy, group_sizes, w.shape[0]).to(w.dtype)
        return dx, dw, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   impl: str = "pallas") -> torch.Tensor:
    """y[i] = x[i] @ w[g(i)] for rows sorted by group; rows beyond
    sum(group_sizes) are zero."""
    return _GroupedMatmul.apply(x, w, group_sizes.to(torch.int32), impl)


def ffn_two_pass(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                 group_sizes: torch.Tensor, act: str = "swiglu",
                 impl: str = "pallas") -> torch.Tensor:
    """Expert FFN as separate grouped GEMMs (materializes (M, H) in the
    working dtype; the activation runs on it as in the JAX two-pass)."""
    ff.check_gating(ws, act)
    if len(ws) == 2:
        h = F.silu(grouped_matmul(x, ws[0], group_sizes, impl))
        h = h * grouped_matmul(x, ws[1], group_sizes, impl)
    else:
        h = ff.activate(grouped_matmul(x, ws[0], group_sizes, impl), None, act)
    return grouped_matmul(h, wo, group_sizes, impl)


class _FusedFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group_sizes, act, plan, wo, *ws):
        ctx.save_for_backward(x, group_sizes, wo, *ws)
        ctx.act, ctx.plan = act, plan
        return ff.fused_ffn(x, ws, wo, group_sizes, act, *plan)

    @staticmethod
    def backward(ctx, dy):
        x, group_sizes, wo, *ws = ctx.saved_tensors
        ws = tuple(ws)
        dy = dy.contiguous()
        dx = None
        dws = [None] * len(ws)
        dwo = None
        if ctx.needs_input_grad[0]:
            dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, group_sizes, ctx.act,
                                     *ctx.plan)
        if any(ctx.needs_input_grad[3:]):
            dw32, dwo32 = fb.fused_ffn_bwd_dw(x, ws, wo, dy, group_sizes,
                                              ctx.act)
            dws = [d.to(w.dtype) for d, w in zip(dw32, ws)]
            dwo = dwo32.to(wo.dtype)
        return (dx, None, None, None, dwo, *dws)


def fused_grouped_ffn(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                      group_sizes: torch.Tensor, act: str = "swiglu",
                      plan_rows: int = 0, plan_groups: int = 0
                      ) -> torch.Tensor:
    """y[i] = act(x[i] @ wi[g(i)]) @ wo[g(i)] with the hidden tile on chip,
    in both directions.  ``plan_rows`` (0 = the rows of x) and
    ``plan_groups`` (0 = the experts of the weights): the rows and experts
    the kernels plan their hidden split for (``fused_ffn.plan``)."""
    ff.check_gating(tuple(ws), act)
    return _FusedFFN.apply(x, group_sizes.to(torch.int32), act,
                           (int(plan_rows), int(plan_groups)), wo, *ws)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx, slot_rows):
        ctx.save_for_backward(idx, slot_rows)
        ctx.num_tokens = x.shape[0]
        return ts.gather_rows(x, idx, slot_rows)

    @staticmethod
    def backward(ctx, dy):
        idx, slot_rows = ctx.saved_tensors
        T = ctx.num_tokens
        if idx.numel() % T or (slot_rows is not None
                               and slot_rows.shape[0] != T):
            raise ValueError(f"gather_tokens: the gradient needs every token "
                             f"gathered k times; {idx.numel()} rows of {T}")
        if slot_rows is None:  # the k rows that hold each token, in row order
            slot_rows = torch.argsort(idx, stable=True).reshape(T, -1).to(
                torch.int32)
        return ts.combine_topk(dy.contiguous(), slot_rows), None, None


def gather_tokens(x: torch.Tensor, idx: torch.Tensor,
                  slot_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Expert-sort scatter (paper Fig 4): y[i] = x[idx[i]].  The gradient
    takes the ragged dispatch's layout: each of the T tokens appears in
    len(idx) / T rows.  ``slot_rows`` (T, k), idx's inverse (the ragged
    plan's table), puts the forward on the source-major kernel and spares
    the backward its sort; the backward then sums a token's rows in slot
    order, not row order (the same sum for k <= 2)."""
    if slot_rows is not None:
        slot_rows = slot_rows.to(torch.int32)
    return _GatherTokens.apply(x, idx.to(torch.int32), slot_rows)


def token_table(idx: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """(T, kmax) int32: the rows of ``idx`` (n,) that hold each of
    ``num_tokens`` tokens, in row order, padded with n (one host sync for
    kmax, the most rows a token has)."""
    n = idx.numel()
    idx = idx.reshape(-1).long()
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=num_tokens)
    kmax = int(counts.max()) if n else 0
    start = torch.cumsum(counts, 0) - counts
    tok = idx[order]
    pos = torch.arange(n, device=idx.device) - start[tok]
    table = torch.full((num_tokens, max(kmax, 1)), n, dtype=torch.int32,
                       device=idx.device)
    table[tok, pos] = order.to(torch.int32)
    return table


class _GatherAny(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.num_tokens = x.shape[0]
        return ts.gather_rows(x, idx)

    @staticmethod
    def backward(ctx, dy):
        (idx,) = ctx.saved_tensors
        table = token_table(idx, ctx.num_tokens)
        dy = torch.cat([dy.contiguous(), dy.new_zeros(1, dy.shape[1])])
        return ts.combine_topk(dy, table), None


def gather_rows_any(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """y[i] = x[idx[i]] where a row of x may be taken any number of times
    (expert-choice's gather), on the by-destination ``gather_rows`` kernel.
    The gradient sums each token's rows in row order with ``combine_topk``
    over :func:`token_table`, a fixed order: deterministic, no atomics."""
    return _GatherAny.apply(x, idx.reshape(-1).to(torch.int32))


class _CombineTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, w):
        ctx.save_for_backward(src, idx, w)
        return ts.combine_topk(src, idx, w)

    @staticmethod
    def backward(ctx, dy):
        src, idx, w = ctx.saved_tensors
        dy = dy.contiguous()
        d_src = d_w = None
        if ctx.needs_input_grad[0]:
            if idx.numel() != src.shape[0]:
                raise ValueError(f"combine_tokens: the gradient of src needs "
                                 f"one (token, slot) per row; {idx.numel()} "
                                 f"slots for {src.shape[0]} rows")
            # the flat (token, slot) t*k + j of each row: idx's inverse
            slot_of_row = torch.argsort(idx.reshape(-1))
            rows = torch.div(slot_of_row, idx.shape[1], rounding_mode="floor")
            w_rows = w.reshape(-1)[slot_of_row]
            d_src = ts.combine_topk(dy, rows.to(torch.int32)[:, None],
                                    w_rows[:, None])
        if ctx.needs_input_grad[2]:
            acc = torch.promote_types(src.dtype, torch.float32)
            d_w = (dy.to(acc)[:, None, :] * src[idx.long()].to(acc)).sum(-1)
            d_w = d_w.to(w.dtype)
        return d_src, None, d_w


def combine_tokens(src: torch.Tensor, idx: torch.Tensor, w: torch.Tensor
                   ) -> torch.Tensor:
    """Gate-weighted un-shuffle (paper Fig 4 gather):
    y[t] = sum_k w[t, k] src[idx[t, k]].  The gradient of src takes the
    ragged dispatch's layout: idx is a permutation of src's rows."""
    return _CombineTokens.apply(src, idx.to(torch.int32), w)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window, q_offset, causal):
        o, lse = fa.flash_attention_fwd(q, k, v, window=window,
                                        q_offset=q_offset, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(window=window, q_offset=q_offset, causal=causal)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                            **ctx.mask)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_offset: int = 0,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(dk)) v over 0 <= i - j < window (causal) or
    i - j < window; q (B, Sq, H, dk), k (B, Skv, KV, dk), v (B, Skv, KV,
    dv), any strides; the output is (B, Sq, H, dv)."""
    return _FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                 int(window), int(q_offset), bool(causal))
