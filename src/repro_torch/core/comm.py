"""Collectives of expert parallelism — the paper's §3.2 global data
exchange, over ``torch.distributed`` on the expert axis's process group.

The payload exchanges are differentiable: the backward of the tiled
all-to-all is the same exchange of the gradient, since that exchange is
its own inverse.  The counts carry no gradient.  The hierarchical
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
