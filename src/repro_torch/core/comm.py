"""Collectives of expert parallelism — the paper's §3.2 global data
exchange, over ``torch.distributed`` on the expert axis's process group.

The payload exchanges are differentiable: the backward of the tiled
all-to-all is the same exchange of the gradient, since that exchange is
its own inverse.  So are the psum mode's all-reduce (its backward is the
all-reduce of the gradient, what ``jax.lax.psum`` transposes to under the
reference's ``shard_map(check_vma=False)``) and expert-internal tensor
parallelism's row all-gather and reduce-scatter (each the other's
backward).  The counts carry no gradient.  The ragged exchange takes the
§5.2 schedule's chunks, shift decomposition and wire dtype
(``core/pipeline``), and the two-level exchange of a node mesh its intra-
node hop (``*_intra``) and slim inter-node hop (``*_inter``).

The collective tally: every collective the port issues (here, in
``core/pipeline``, the metrics' and the gradient sync's all-reduces) adds
its output bytes per rank under the reference's HLO op names
(``all-to-all``, ``all-reduce``, ``all-gather``, ``reduce-scatter``,
``collective-permute`` for the shifts), the counterpart of the bytes the
reference parses from its compiled step (``obs/stats.StepStats``).  It is
host bookkeeping of shapes: it reads no tensor's values.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import pipeline

_TALLY: dict = {}  # op name -> output bytes per rank since the last reset
_CALLS: dict = {}  # op name -> calls since the last reset


def tally(op: str, nbytes: float) -> None:
    """Enter one collective of ``nbytes`` output bytes per rank."""
    _TALLY[op] = _TALLY.get(op, 0) + nbytes
    _CALLS[op] = _CALLS.get(op, 0) + 1


def tally_reset() -> None:
    _TALLY.clear()
    _CALLS.clear()


def tallied() -> dict:
    """{op: output bytes per rank} since the last :func:`tally_reset`."""
    return dict(_TALLY)


def tallied_calls() -> dict:
    """{op: calls} since the last :func:`tally_reset`."""
    return dict(_CALLS)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place SUM over ``group`` (not differentiable), tallied."""
    tally("all-reduce", x.numel() * x.element_size())
    dist.all_reduce(x, group=group)
    return x


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable tiled all-to-all over dim 0 (its size = the group's):
    slice i of ``x`` goes to rank i of ``group``; slice j of the result
    came from rank j.  The undecomposed ``pipeline.Exchange``, waited on at
    once."""
    return pipeline.exchange(x, group, dist.get_world_size(group),
                             decompose=False)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_(x.contiguous().clone(), group)  # a fresh buffer


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
    tally("all-gather", out.numel() * out.element_size())
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // dist.get_world_size(group),
                        *xt.shape[1:]))
    tally("reduce-scatter", out.numel() * out.element_size())
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
    return pipeline.counts_all_to_all(counts.reshape(mp, -1), group, mp)


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
                    *, n_chunks: int = 1, wire_dtype=None, decompose=None,
                    fill_fn=None):
    """The ragged (dropless) exchange, forward direction.

    send: (mp, bound, d) pad-to-max-per-peer shards; counts: (mp, E_local)
    kept rows per (destination rank, its expert), the valid lengths of the
    shards.  Returns ``(recv, incoming, fill_out)``: the shards received
    from each source rank, the counts that came with them (which size the
    receiver's compaction, ``dispatch.ragged_recv_compact``), and what
    ``fill_fn`` (the shadowed experts, run in the first chunk's wire
    bubble) returned, or None.  With ``n_chunks > 1`` the payload moves in
    micro-shards, and it and the counts take the decomposed exchange
    unless ``decompose`` is False."""
    decompose = n_chunks > 1 if decompose is None else decompose
    incoming = pipeline.counts_all_to_all(counts, group, mp,
                                          decompose=decompose)
    recv, fill_out = pipeline.ragged_pipelined_exchange(
        send, group, mp, n_chunks, fill_fn=fill_fn, wire_dtype=wire_dtype,
        decompose=decompose)
    return recv, incoming, fill_out


def return_ragged(out: torch.Tensor, group, mp: int, *, n_chunks: int = 1,
                  wire_dtype=None, decompose=None) -> torch.Tensor:
    """Inverse of :func:`exchange_ragged`'s payload: (mp, bound, d_out)
    expert outputs go back to their source ranks, into the slots they were
    sent from (the tiled exchange is its own inverse)."""
    return pipeline.chunked_all_to_all(
        out, group, mp, n_chunks, wire_dtype=wire_dtype,
        decompose=n_chunks > 1 if decompose is None else decompose)


def exchange_ragged_intra(send: torch.Tensor, counts: torch.Tensor,
                          inner_group, n_inner: int, *,
                          decompose: bool = False, wire_dtype=None):
    """Hop 1 of the two-level ragged exchange: aggregate within the node.

    send: (n_nodes, n_inner, bound, d) per-peer shards, peers node-major
    (rank = node * n_inner + inner); counts: (n_nodes, n_inner, E_local)
    the matching kept-row counts.  Both take a dim-1 exchange over the
    node-local group, after which this rank is its node's forwarding agent
    for its own inner slot: entry ``[o, s]`` is sibling ``s``'s shard (and
    counts) for rank ``(o, my_inner)`` of every node ``o``, ready for the
    node-level compaction (``dispatch.make_hier_agg``)."""
    shards = pipeline.all_to_all_dim1(send, inner_group, n_inner,
                                      decompose=decompose,
                                      wire_dtype=wire_dtype)
    with torch.no_grad():
        cnt = pipeline.all_to_all_dim1(counts, inner_group, n_inner,
                                       decompose=decompose)
    return shards, cnt


def return_ragged_intra(out: torch.Tensor, inner_group, n_inner: int, *,
                        decompose: bool = False,
                        wire_dtype=None) -> torch.Tensor:
    """Inverse of :func:`exchange_ragged_intra`'s payload hop: the
    de-aggregated (n_nodes, n_inner, bound, d_out) outputs go back to their
    source siblings (the dim-1 exchange is its own inverse)."""
    return pipeline.all_to_all_dim1(out, inner_group, n_inner,
                                    decompose=decompose, wire_dtype=wire_dtype)


def exchange_ragged_inter(slim: torch.Tensor, kept_counts: torch.Tensor,
                          node_group, n_nodes: int, *, n_chunks: int = 1,
                          wire_dtype=None, decompose=None, fill_fn=None):
    """Hop 2 of the two-level ragged exchange: the slim inter-node leg.

    slim: (n_nodes, inter_bound, d) aggregated per-node shards (the rows
    truly needed, then tail padding); kept_counts: (n_nodes, n_inner,
    E_local) at per-source-rank granularity, so the receiver rebuilds the
    flat path's compaction exactly.  The payload moves the bounded shards
    (the reference's ``lax.ragged_all_to_all`` branch, valid prefixes
    only, has no counterpart here).  Returns ``(recv, incoming,
    fill_out)`` like :func:`exchange_ragged`."""
    decompose = n_chunks > 1 if decompose is None else decompose
    incoming = pipeline.counts_all_to_all(
        kept_counts.reshape(n_nodes, -1), node_group, n_nodes,
        decompose=decompose).reshape(kept_counts.shape)
    recv, fill_out = pipeline.ragged_pipelined_exchange(
        slim, node_group, n_nodes, n_chunks, fill_fn=fill_fn,
        wire_dtype=wire_dtype, decompose=decompose)
    return recv, incoming, fill_out


def return_ragged_inter(out: torch.Tensor, node_group, n_nodes: int, *,
                        n_chunks: int = 1, wire_dtype=None,
                        decompose=None) -> torch.Tensor:
    """Inverse of :func:`exchange_ragged_inter`'s payload leg: each rank
    returns what it received and gets back what it sent."""
    return pipeline.chunked_all_to_all(
        out, node_group, n_nodes, n_chunks, wire_dtype=wire_dtype,
        decompose=n_chunks > 1 if decompose is None else decompose)


def hierarchical_all_to_all(buf: torch.Tensor, inner_group,
                            outer_group) -> torch.Tensor:
    """Two hops for a node mesh: buf (n_outer, n_inner, ...), dim 0 the
    destination outer rank and dim 1 the destination inner rank.  First
    the node-local exchange over dim 1 (each inner rank then holds its
    node's traffic for one inner-peer slot), then one aggregated exchange
    over dim 0 across nodes.  Differentiable."""
    buf = pipeline.all_to_all_dim1(buf, inner_group, buf.shape[1])
    return all_to_all(buf, outer_group)


def all_to_all_bf16(buf: torch.Tensor, group) -> torch.Tensor:
    """The tiled dim-0 all-to-all with the payload cast to bf16 across the
    wire (half the bytes of f32) and back to its own dtype."""
    return all_to_all(buf.to(torch.bfloat16), group).to(buf.dtype)
