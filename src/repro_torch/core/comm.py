"""Collectives of expert parallelism — the paper's §3.2 global data
exchange, over ``torch.distributed`` on the expert axis's process group.

The payload exchanges are differentiable: the backward of the tiled
all-to-all is the same exchange of the gradient, since that exchange is
its own inverse.  So are the psum mode's all-reduce (its backward is the
all-reduce of the gradient, what ``jax.lax.psum`` transposes to under the
reference's ``shard_map(check_vma=False)``) and expert-internal tensor
parallelism's row all-gather and reduce-scatter (each the other's
backward).  The counts carry no gradient.  The hierarchical
``*_intra`` / ``*_inter`` variants of the reference are not ported
(ROADMAP §1 item 6).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Tiled dim-0 all-to-all: slice i of ``x`` goes to rank i of
    ``group``; slice j of the result came from rank j."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable tiled all-to-all over dim 0 (its size = the group's)."""
    return _AllToAll.apply(x, group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()  # a fresh buffer: reduced in place
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM over ``group``; the gradient is summed too."""
    return _AllReduceSum.apply(x, group)


# The tiled gather and scatter work on dim 0 of a contiguous buffer, so a
# row dim of an (E_local, rows, d) buffer is moved to the front (a copy)
# and back (a view).


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((dist.get_world_size(group) * xt.shape[0],
                        *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // dist.get_world_size(group),
                        *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def all_gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled all-gather along ``dim``: rank i's rows land in block i.  Its
    backward reduce-scatters (SUM) the gradient."""
    return _AllGatherRows.apply(x, group, dim)


def reduce_scatter_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Tiled reduce-scatter (SUM) along ``dim``: rank i keeps block i of the
    sum.  Its backward all-gathers the gradient."""
    return _ReduceScatterRows.apply(x, group, dim)


def exchange_counts(counts: torch.Tensor, group) -> torch.Tensor:
    """Fig 2 step 1: counts (E,) of local assignments per expert, E = mp *
    E_local -> (mp, E_local) counts arriving from each source rank."""
    mp = dist.get_world_size(group)
    return _all_to_all(counts.reshape(mp, -1), group)


def exchange_tokens(buf: torch.Tensor, group) -> torch.Tensor:
    """Fig 2 step 2, the payload all-to-all: buf (E, C, d) -> (E_local,
    mp*C, d), source-major within each local expert."""
    mp = dist.get_world_size(group)
    E, C, d = buf.shape
    recv = all_to_all(buf.reshape(mp, E // mp, C, d), group)
    return recv.transpose(0, 1).reshape(E // mp, mp * C, d)


def return_tokens(out: torch.Tensor, group) -> torch.Tensor:
    """Inverse of :func:`exchange_tokens`: (E_local, mp*C, d) -> (E, C, d)."""
    mp = dist.get_world_size(group)
    E_local, n, d = out.shape
    C = n // mp
    back = all_to_all(out.reshape(E_local, mp, C, d).transpose(0, 1), group)
    return back.reshape(E_local * mp, C, d)


def exchange_ragged(send: torch.Tensor, counts: torch.Tensor, group, mp: int,
                    *, n_chunks: int = 1, wire_dtype=None):
    """The ragged (dropless) exchange, forward direction.

    send: (mp, bound, d) pad-to-max-per-peer shards; counts: (mp, E_local)
    kept rows per (destination rank, its expert), the valid lengths of the
    shards.  Returns ``(recv, incoming)``: the shards received from each
    source rank and the counts that came with them (which size the
    receiver's compaction, ``dispatch.ragged_recv_compact``)."""
    from repro_torch.core import pipeline

    incoming = pipeline.counts_all_to_all(counts, group, mp)
    recv = pipeline.ragged_pipelined_exchange(send, group, mp, n_chunks,
                                              wire_dtype=wire_dtype)
    return recv, incoming


def return_ragged(out: torch.Tensor, group, mp: int, *, n_chunks: int = 1,
                  wire_dtype=None) -> torch.Tensor:
    """Inverse of :func:`exchange_ragged`'s payload: (mp, bound, d_out)
    expert outputs go back to their source ranks, into the slots they were
    sent from."""
    from repro_torch.core import pipeline

    return pipeline.chunked_all_to_all(out, group, mp, n_chunks,
                                       wire_dtype=wire_dtype)
