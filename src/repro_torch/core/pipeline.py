"""The smart schedule of the expert exchange — the paper's §5.2 pipelined
global data exchange.

The ``(mp, E_local, C, d)`` exchange buffer splits into ``n_chunks``
micro-shards along the capacity dim, and the exchanges and the expert
compute run in the order

    S0 | S1  C0  R0 | S2  C1  R1 | ...  C_{n-1}  R_{n-1}

where S_i / R_i are chunk i's forward / return exchanges and C_i its expert
compute: chunk i+1's send is issued before chunk i's compute, and chunk
i's return right after it.  Every exchange is issued with ``async_op=True``
and waited on only right before its output is read.  Under NCCL ``wait()``
orders the current stream behind NCCL's and returns at once, so the host
runs ahead and the sends, the compute and the returns overlap on the card
with no stream of the port's own.  With ``decompose`` an exchange is
``mp - 1`` shifts of point-to-point sends and receives (and a local copy of
the rank's own slice), the reference's ``ppermute`` decomposition; without
it, one all-to-all.  Each exchange is differentiable: its backward is the
same exchange of the gradient, issued when the gradient arrives and waited
on when the gradient of its input is read, so the backward is chunked as
the forward is.

The schedule is bit-exact against the serial one wherever the expert
compute's arithmetic for a row does not depend on how many rows it is
given (the capacity dim never regroups an expert's rows), and the
decomposed exchange moves the same bytes to the same slots.  ``wire_dtype``
casts a payload to that dtype across the exchange only.

``fill_fn`` is the shadowed experts' exchange-free compute (placement,
``placement/shadow.py``): it is issued after the first chunk's exchange
starts and before that exchange is waited on, so on the card it fills the
first wire bubble.  Its autograd graph is its own; no collective runs in
it, so the ranks' collectives keep their order in the backward.

:func:`wire_fraction` is the share of an exchange's buffer that crosses
the wire, which the telemetry counters (``obs/counters``) read.  Every
exchange issued here is entered in ``core.comm``'s collective tally.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

WIRE_DTYPES = {"bf16": torch.bfloat16}


def wire_torch_dtype(wire_dtype):
    """torch dtype for a ``DistConfig.wire_dtype`` name (None = none)."""
    if wire_dtype is None or isinstance(wire_dtype, torch.dtype):
        return wire_dtype
    if wire_dtype in WIRE_DTYPES:
        return WIRE_DTYPES[wire_dtype]
    raise ValueError(f"wire_dtype {wire_dtype!r}: 'bf16' or None")


def _to_wire(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Narrow to the wire dtype; the identity when x already has it (or no
    wire dtype is set).  Gloo and NCCL move bf16 as it is, so the
    reference's unsigned bitcast (an XLA workaround) has no counterpart."""
    wd = wire_torch_dtype(wire_dtype)
    return x if wd is None or x.dtype == wd else x.to(wd)


# ---------------------------------------------------------------------------
# One exchange in flight: issue, wait, and their autograd pair
# ---------------------------------------------------------------------------


class _Pending:
    """An exchange in flight: its output buffer and the handles to wait on,
    for the forward and, once the gradient has arrived, for the backward."""

    __slots__ = ("group", "mp", "decompose", "src", "out", "works",
                 "g_src", "g_out", "g_works")

    def __init__(self, group, mp: int, decompose: bool):
        self.group, self.mp, self.decompose = group, mp, decompose
        self.src = self.out = self.works = None
        self.g_src = self.g_out = self.g_works = None


def wire_fraction(mp: int, *, decompose: bool) -> float:
    """The fraction of a tiled dim-0 exchange that crosses the wire: the
    shifts keep each rank's own slice on the rank, so a decomposed
    exchange moves (mp - 1) / mp of the buffer; one all-to-all is counted
    at its whole output, as the reference counts its HLO op."""
    return (mp - 1) / mp if (decompose and mp > 0) else 1.0


def _issue(x: torch.Tensor, group, mp: int, decompose: bool):
    """Start the tiled dim-0 exchange of ``x`` (mp slices, one a peer):
    returns (the contiguous source, the output buffer, handles).  The
    buffer holds the result only after every handle's ``wait()``, and the
    source must live until then."""
    from repro_torch.core import comm  # comm imports this module
    x = x.contiguous()
    out = torch.empty_like(x)
    nbytes = x.numel() * x.element_size()
    if not decompose:
        comm.tally("all-to-all", nbytes)
        return x, out, [dist.all_to_all_single(out, x, group=group,
                                               async_op=True)]
    comm.tally("collective-permute",
               nbytes * wire_fraction(mp, decompose=True))
    # shift s: my slice for rank r+s goes there; rank r-s's slice for me
    # lands in slot r-s, where the tiled all-to-all puts it
    r = dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    xs, outs = x.view(mp, x.numel() // mp), out.view(mp, x.numel() // mp)
    outs[r].copy_(xs[r])
    ops = []
    for s in range(1, mp):
        dst, src = (r + s) % mp, (r - s) % mp
        ops.append(dist.P2POp(dist.isend, xs[dst], ranks[dst], group))
        ops.append(dist.P2POp(dist.irecv, outs[src], ranks[src], group))
    return x, out, dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for w in works:
        w.wait()


class _Start(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pending):
        ctx.pending = pending
        pending.src, pending.out, pending.works = _issue(
            x, pending.group, pending.mp, pending.decompose)
        return pending.out

    @staticmethod
    def backward(ctx, g):
        p = ctx.pending
        _wait(p.g_works)  # the gradient's exchange, issued by _Finish
        out = p.g_out
        p.g_src = p.g_out = p.g_works = None
        return out, None


class _Finish(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, pending):
        ctx.pending = pending
        _wait(pending.works)
        pending.src = pending.out = pending.works = None
        return out

    @staticmethod
    def backward(ctx, g):
        p = ctx.pending
        p.g_src, p.g_out, p.g_works = _issue(g, p.group, p.mp, p.decompose)
        return p.g_out, None


class Exchange:
    """One tiled dim-0 exchange (``x`` of mp slices, slice i for group rank
    i) started at construction and read by :meth:`result`, which waits on
    it.  Differentiable: the gradient's exchange is started when the
    gradient of the result arrives and waited on when the gradient of the
    input is read.  At ``mp == 1`` with ``decompose`` no collective is
    issued (the reference's ``ppermute_all_to_all`` at one rank).
    ``wire_dtype`` casts across the exchange only."""

    def __init__(self, x: torch.Tensor, group, mp: int, *,
                 decompose: bool = True, wire_dtype=None):
        assert x.shape[0] == mp, (x.shape, mp)
        self._orig = x.dtype
        w = _to_wire(x, wire_dtype)
        if decompose and mp == 1:
            self._out, self._pending = w, None
        else:
            self._pending = _Pending(group, mp, decompose)
            self._out = _Start.apply(w, self._pending)

    def result(self) -> torch.Tensor:
        out = self._out
        if self._pending is not None:
            out = _Finish.apply(out, self._pending)
        self._out = self._pending = None
        return out.to(self._orig)


def exchange(x: torch.Tensor, group, mp: int, *, decompose: bool = True,
             wire_dtype=None) -> torch.Tensor:
    """A tiled dim-0 exchange, issued and waited on at once: the shifts,
    or (``decompose=False``) one all-to-all, which ``comm.all_to_all``
    is."""
    return Exchange(x, group, mp, decompose=decompose,
                    wire_dtype=wire_dtype).result()


def ppermute_all_to_all(x: torch.Tensor, group, mp: int, *,
                        wire_dtype=None) -> torch.Tensor:
    """The tiled dim-0 all-to-all as ``mp - 1`` shifts: shift s sends rank
    r's slice for rank (r+s)%mp there, and the receiver q writes it at slot
    (q-s)%mp, where the all-to-all puts the data from rank (q-s)%mp.  x:
    (mp, ...) one slice per destination rank of ``group`` (the expert axis,
    ranks node-major on a node mesh)."""
    return exchange(x, group, mp, decompose=True, wire_dtype=wire_dtype)


def chunked_all_to_all(x: torch.Tensor, group, mp: int, n_chunks: int = 1, *,
                       wire_dtype=None, decompose: bool = True) -> torch.Tensor:
    """Tiled dim-0 all-to-all split into ``n_chunks`` exchanges along dim 1
    (which must divide by it), all in flight together.  x: (mp, ...) one
    slice per destination rank -> (mp, ...) one slice per source rank.
    Pure data movement: bit-exact against one exchange for any chunking."""
    if n_chunks <= 1:
        return exchange(x, group, mp, decompose=decompose,
                        wire_dtype=wire_dtype)
    ex = [Exchange(c, group, mp, decompose=decompose, wire_dtype=wire_dtype)
          for c in torch.chunk(x, n_chunks, dim=1)]
    return torch.cat([e.result() for e in ex], dim=1)


def counts_all_to_all(counts: torch.Tensor, group, mp: int, *,
                      decompose: bool = False) -> torch.Tensor:
    """The Fig-2 "exchange sizes" step: (mp, E_local) per-destination counts
    -> (mp, E_local) per-source counts.  ``decompose`` takes the shifts
    instead of the all-to-all, so a chunked schedule issues no all-to-all
    at all (the capacity and ragged paths share this helper).  Integer, no
    gradient."""
    assert counts.shape[0] == mp, (counts.shape, mp)
    with torch.no_grad():
        return exchange(counts, group, mp, decompose=decompose)


def resolve_chunks(requested: int, capacity: int) -> int:
    """Largest divisor of ``capacity`` that is <= ``requested`` (>= 1): the
    micro-shards tile the static capacity exactly, and a pair that does
    not divide falls back to the nearest feasible depth (1 = serial)."""
    n = max(1, min(int(requested), int(capacity)))
    while capacity % n:
        n -= 1
    return n


def _fill(fill_fn):
    return fill_fn() if fill_fn is not None else None


def ragged_pipelined_exchange(send: torch.Tensor, group, mp: int,
                              n_chunks: int = 1, *, fill_fn=None,
                              wire_dtype=None, decompose=None):
    """Forward half of the ragged (dropless) exchange, micro-sharded.

    send: (mp, bound, d) pad-to-max-per-peer shards.  With ``n_chunks >
    1`` the bound dim splits into decomposed micro-shards, all in flight
    together.  The expert compute is not interleaved per chunk: the
    grouped kernels need the compacted expert-sorted rows, which exist
    only after every shard lands.  ``fill_fn`` (the shadowed experts) runs
    once the first chunk's exchange is issued.  ``decompose`` None: when
    chunked.  Returns ``(recv, fill_out | None)``."""
    ex = dict(wire_dtype=wire_dtype,
              decompose=n_chunks > 1 if decompose is None else decompose)
    chunks = torch.chunk(send, n_chunks, dim=1) if n_chunks > 1 else [send]
    recv = [Exchange(chunks[0], group, mp, **ex)]  # S0
    fill_out = _fill(fill_fn)  # the shadowed experts fill S0's bubble
    recv += [Exchange(c, group, mp, **ex) for c in chunks[1:]]
    out = [r.result() for r in recv]
    return (out[0] if n_chunks <= 1 else torch.cat(out, dim=1)), fill_out


def all_to_all_dim1(x: torch.Tensor, group, mp: int, *,
                    decompose: bool = False, wire_dtype=None) -> torch.Tensor:
    """Tiled all-to-all over dim 1 (its size == mp): the intra-node hop of
    the two-level ragged exchange, whose buffers are laid out (n_nodes,
    n_inner, ...) and whose node-local exchange moves dim 1 while dim 0
    (the destination node) stays.  A transpose around the dim-0
    exchange."""
    return exchange(x.transpose(0, 1), group, mp, decompose=decompose,
                    wire_dtype=wire_dtype).transpose(0, 1)


def hier_ragged_pipeline(send: torch.Tensor, group, mp: int, n_chunks: int,
                         chunk_fn: Callable[[torch.Tensor, int], torch.Tensor],
                         *, fill_fn=None, wire_dtype=None, decompose=None):
    """Inter-node leg of the two-level ragged exchange, with the expert
    compute per received chunk.

    send: (mp, inter_bound, d) slim per-node shards (mp = n_nodes here).
    ``chunk_fn(recv_chunk, c)`` runs the expert compute on chunk ``c``'s
    received rows, (mp, w, d) -> (mp, w, d_out) with ``w = inter_bound //
    n_chunks``, through its own mini-compaction
    (``dispatch.hier_chunk_plans``).  The smart schedule on this leg alone:
    S_{c+1} is issued before C_c and R_c right after it; ``fill_fn`` (the
    shadowed experts) runs after S0 is issued.  Returns ``(ret (mp,
    inter_bound, d_out), fill_out | None)``.  ``decompose`` None: when
    chunked."""
    decompose = n_chunks > 1 if decompose is None else decompose
    ex = dict(decompose=decompose, wire_dtype=wire_dtype)
    if n_chunks <= 1:
        s0 = Exchange(send, group, mp, **ex)
        fill_out = _fill(fill_fn)
        return exchange(chunk_fn(s0.result(), 0), group, mp, **ex), fill_out
    chunks = torch.chunk(send, n_chunks, dim=1)
    recv = [Exchange(chunks[0], group, mp, **ex)]  # S0 warms the pipeline
    outs = []
    fill_out = None
    for c in range(n_chunks):
        if c + 1 < n_chunks:
            recv.append(Exchange(chunks[c + 1], group, mp, **ex))  # S_{c+1}
        if c == 0:
            fill_out = _fill(fill_fn)  # the shadowed experts fill S0's bubble
        y = chunk_fn(recv[c].result(), c)  # C_c
        outs.append(Exchange(y, group, mp, **ex))  # R_c
    return torch.cat([o.result() for o in outs], dim=1), fill_out


def pipelined_expert_exchange(
        buf: torch.Tensor, group, mp: int, n_chunks: int,
        compute_fn: Callable[[torch.Tensor], torch.Tensor], *,
        fill_fn=None, wire_dtype=None, decompose: bool = True):
    """Dispatch exchange -> expert compute -> return exchange, pipelined.

    buf: (mp, E_local, C, d), dim 0 the destination rank.  ``compute_fn``
    takes (E_local, rows, d) rows, source-major within an expert, and
    returns (E_local, rows, d_out), row-independent (the caller wraps any
    tp gather and scatter).  ``fill_fn``: exchange-free local work (the
    shadowed experts) issued once S0 is in flight.  Returns ``(out (mp,
    E_local, C, d_out), dim 0 the expert's rank, fill_out | None)``.
    ``n_chunks == 1`` is the serial schedule: one exchange each way."""
    mp_, E_local, C, d = buf.shape
    assert mp_ == mp and C % n_chunks == 0, (buf.shape, mp, n_chunks)
    ex = dict(decompose=decompose, wire_dtype=wire_dtype)

    def compute(recv, rows):
        x = recv.transpose(0, 1).reshape(E_local, mp * rows, d)
        y = compute_fn(x)
        return y.reshape(E_local, mp, rows, -1).transpose(0, 1)

    if n_chunks <= 1:
        s0 = Exchange(buf, group, mp, **ex)
        fill_out = _fill(fill_fn)
        return exchange(compute(s0.result(), C), group, mp, **ex), fill_out
    Cc = C // n_chunks
    chunks = torch.chunk(buf, n_chunks, dim=2)
    recv = [Exchange(chunks[0], group, mp, **ex)]  # S0 warms the pipeline
    outs = []
    fill_out = None
    for i in range(n_chunks):
        if i + 1 < n_chunks:
            recv.append(Exchange(chunks[i + 1], group, mp, **ex))  # S_{i+1}
        if i == 0:
            fill_out = _fill(fill_fn)  # the shadowed experts fill S0's bubble
        y = compute(recv[i].result(), Cc)  # C_i
        outs.append(Exchange(y, group, mp, **ex))  # R_i
    return torch.cat([o.result() for o in outs], dim=2), fill_out
