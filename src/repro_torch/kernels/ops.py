"""The ops layer over the kernels (forward only), with the JAX ``ops``
contracts:

* rows beyond ``sum(group_sizes)`` come out as zero on every impl;
* ``check_gating``: swiglu takes (wi_gate, wi_up), every other act (wi,);
* acts: swiglu, gelu (tanh form), rwkv (squared ReLU), silu.

``impl="pallas"`` runs the hand-written kernel (the port of the Pallas
kernel; on CPU tensors its plain version); ``impl="plain"`` runs the plain
PyTorch grouped product, the port's counterpart of XLA's ``ragged_dot``.
The JAX tiling arguments (``bm``, ``bh``, ``aligned``) have no counterpart:
the Hopper kernels take the group sizes directly, so no call pads groups.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import fused_ffn as ff
from repro_torch.kernels import grouped_gemm as gg
from repro_torch.kernels import token_shuffle as ts


def grouped_matmul(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor,
                   impl: str = "pallas") -> torch.Tensor:
    """y[i] = x[i] @ w[g(i)] for rows sorted by group; rows beyond
    sum(group_sizes) are zero."""
    group_sizes = group_sizes.to(torch.int32)
    if impl == "pallas":
        return gg.grouped_gemm(x, w, group_sizes)
    if impl == "plain":
        return gg.grouped_gemm_plain(x, w, group_sizes)
    raise ValueError(f"unknown grouped_matmul impl {impl!r}")


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


def fused_grouped_ffn(x: torch.Tensor, ws: tuple, wo: torch.Tensor,
                      group_sizes: torch.Tensor, act: str = "swiglu"
                      ) -> torch.Tensor:
    """y[i] = act(x[i] @ wi[g(i)]) @ wo[g(i)] with the hidden tile on chip."""
    return ff.fused_ffn(x, tuple(ws), wo, group_sizes.to(torch.int32), act)


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Expert-sort scatter (paper Fig 4): y[i] = x[idx[i]]."""
    return ts.gather_rows(x, idx.to(torch.int32))


def combine_tokens(src: torch.Tensor, idx: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Gate-weighted un-shuffle (paper Fig 4 gather)."""
    return ts.combine_topk(src, idx.to(torch.int32), w)
