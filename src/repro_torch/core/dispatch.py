"""Token scatter/gather — the paper's §4 reordered computation (Fig 4).

Two realizations, as in the JAX package:

* ``capacity`` — GShard-style static buffers ``(E, C, d)``; overflow tokens
  are dropped (tracked), lower slots keep priority.
* ``ragged`` — expert-sorted token array + group sizes, no drops.  Here the
  scatter (``dispatch_ragged``) and the gate-weighted gather
  (``combine_ragged``) are the two token-shuffle kernels
  (``repro_torch.kernels.token_shuffle``).  The plan carries the sort's
  inverse, ``slot_rows`` (the sorted row of each (token, slot)), made once
  a plan: the scatter walks it source-major, reading each token once, and
  the gather reads each token's k rows through it.

and the plans of the expert-parallel ragged exchange (``make_ragged_xplan``,
``ragged_recv_compact``) and of its two-level form on a node mesh
(``make_hier_agg``, ``ragged_recv_compact_hier``, ``hier_chunk_plans``),
pure index arithmetic on the device with no host sync, whose packing and
compaction are plain index copies (``scatter_rows``, ``gather_rows_fill``),
as the reference's scatters and gathers are.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float, *, multiple: int = 8) -> int:
    """Static per-expert buffer length C."""
    c = math.ceil(num_tokens * top_k * capacity_factor / num_experts)
    return max(multiple, math.ceil(c / multiple) * multiple)


# ---------------------------------------------------------------------------
# Capacity (static-buffer) dispatch
# ---------------------------------------------------------------------------


class CapacityPlan(NamedTuple):
    """Routing of each (token, slot) pair into the (E, C) buffer grid."""

    expert_ids: torch.Tensor  # (T, k) int64
    positions: torch.Tensor  # (T, k) int64 — row in the expert buffer; ==C if dropped
    keep: torch.Tensor  # (T, k) bool
    load: torch.Tensor  # (E,) int64 — tokens *assigned* per expert (pre-drop)
    capacity: int


def make_capacity_plan(expert_ids: torch.Tensor, num_experts: int,
                       capacity) -> CapacityPlan:
    """Assign buffer positions with slot-major priority (top-1 choices first),
    matching GShard so lower-k choices survive overflow.

    ``capacity`` is an int or a per-expert sequence (placement shrinks the
    exchanged experts' buffers apart from the shadowed ones'); the buffer
    width ``plan.capacity`` is the largest, and a row past its own
    expert's capacity drops (position == width)."""
    T, k = expert_ids.shape
    if isinstance(capacity, (int, np.integer)):
        caps, width = None, int(capacity)
    else:
        caps_np = np.asarray(capacity, np.int64)
        if caps_np.shape != (num_experts,):
            raise ValueError(f"capacities {caps_np.shape} for {num_experts} "
                             f"experts")
        caps, width = caps_np, int(caps_np.max())
    flat = expert_ids.T.reshape(-1)  # slot-major (k*T,)
    onehot = F.one_hot(flat, num_experts)  # (kT, E)
    pos_in_expert = torch.cumsum(onehot, dim=0) - onehot
    pos = pos_in_expert.gather(1, flat[:, None])[:, 0]
    keep = pos < (width if caps is None
                  else _caps_on(tuple(caps.tolist()), str(flat.device))[flat])
    pos = torch.where(keep, pos, torch.full_like(pos, width))
    load = onehot.sum(0)

    def unflatten(a):
        return a.reshape(k, T).T

    return CapacityPlan(expert_ids, unflatten(pos), unflatten(keep), load,
                        width)


@functools.lru_cache(maxsize=64)
def _caps_on(caps: tuple, device: str) -> torch.Tensor:
    """Per-expert capacities on ``device``, made once: a copy from pageable
    host memory would wait for the stream at every layer."""
    return torch.tensor(caps, dtype=torch.int64, device=device)


def dispatch_capacity(x: torch.Tensor, plan: CapacityPlan,
                      num_experts: int) -> torch.Tensor:
    """Scatter tokens (T, d) into per-expert buffers (E, C, d).  Dropped rows
    (position C) land in a sacrificial extra row that is sliced off."""
    T, d = x.shape
    k = plan.expert_ids.shape[1]
    buf = torch.zeros(num_experts, plan.capacity + 1, d, dtype=x.dtype,
                      device=x.device)
    rows = torch.arange(T, device=x.device).repeat_interleave(k)
    buf[plan.expert_ids.reshape(-1), plan.positions.reshape(-1)] = x[rows]
    return buf[:, :plan.capacity]


def combine_capacity(out_buf: torch.Tensor, plan: CapacityPlan,
                     combine_weights: torch.Tensor) -> torch.Tensor:
    """Gather expert outputs (E, C, dout) back to token order, weighted-sum
    over k.  Dropped slots read a zero row and carry weight 0."""
    T, k = plan.expert_ids.shape
    E, _, dout = out_buf.shape
    padded = torch.cat([out_buf, out_buf.new_zeros(E, 1, dout)], dim=1)
    gathered = padded[plan.expert_ids.reshape(-1), plan.positions.reshape(-1)]
    gathered = gathered.reshape(T, k, dout)
    w = (combine_weights * plan.keep).to(gathered.dtype)
    return torch.einsum("tk,tkd->td", w, gathered)


def combine_capacity_slots(out_buf: torch.Tensor, plan: CapacityPlan,
                           combine_weights: torch.Tensor) -> torch.Tensor:
    """The per-slot weighted expert outputs (T, k, dout), no sum over k.

    The placed psum mode reduces these over the ranks *before* summing a
    token's k slots in a fixed order, so the result does not depend on
    which rank served a slot: a k-sum on a rank (``combine_capacity``'s
    einsum) may fuse a token's two co-located slots into one rounding.
    Here every slot's product is rounded once, on whichever rank computes
    it, and the sum over k is the same everywhere."""
    T, k = plan.expert_ids.shape
    E, _, dout = out_buf.shape
    padded = torch.cat([out_buf, out_buf.new_zeros(E, 1, dout)], dim=1)
    gathered = padded[plan.expert_ids.reshape(-1), plan.positions.reshape(-1)]
    w = (combine_weights * plan.keep).to(gathered.dtype)
    return w[:, :, None] * gathered.reshape(T, k, dout)


# ---------------------------------------------------------------------------
# Ragged (sorted) dispatch — FastMoE-faithful, no drops
# ---------------------------------------------------------------------------


class RaggedPlan(NamedTuple):
    sort_idx: torch.Tensor  # (T*k,) int64 — stable argsort of flat expert ids
    group_sizes: torch.Tensor  # (E,) int32
    token_rows: torch.Tensor  # (T*k,) int32 — source token per sorted row
    slot_rows: torch.Tensor  # (T, k) int32 — sorted row of each (token,
    # slot): sort_idx's inverse, so token_rows[slot_rows[t, j]] == t


def make_ragged_plan(expert_ids: torch.Tensor, num_experts: int) -> RaggedPlan:
    T, k = expert_ids.shape
    flat = expert_ids.reshape(-1)  # token-major
    sort_idx = torch.argsort(flat, stable=True)
    if flat.device.type == "meta":
        # the dry run: no values to count; the groups are taken as even (a
        # path's allocations follow its row counts and bounds, not how the
        # rows split among experts)
        group_sizes = torch.empty(num_experts, dtype=torch.int32,
                                  device=flat.device)
    else:
        group_sizes = torch.bincount(flat, minlength=num_experts).to(
            torch.int32)
    token_rows = torch.div(sort_idx, k, rounding_mode="floor").to(torch.int32)
    n = sort_idx.numel()
    slot_rows = torch.empty(n, dtype=torch.int32, device=flat.device).scatter_(
        0, sort_idx, torch.arange(n, dtype=torch.int32, device=flat.device))
    return RaggedPlan(sort_idx, group_sizes, token_rows, slot_rows.reshape(T, k))


def dispatch_ragged(x: torch.Tensor, plan: RaggedPlan) -> torch.Tensor:
    """Gather tokens (T, d) into expert-sorted order (T*k, d) — the
    ``gather_rows`` kernel, source-major through ``plan.slot_rows``."""
    return ops.gather_tokens(x, plan.token_rows, plan.slot_rows)


def combine_ragged(y_sorted: torch.Tensor, plan: RaggedPlan,
                   combine_weights: torch.Tensor) -> torch.Tensor:
    """Un-sort expert outputs (T*k, dout) and weighted-sum the k slots — the
    ``combine_topk`` kernel, reading slot (t, j) from sorted row
    ``plan.slot_rows[t, j]``.  The weights are rounded to the output dtype
    first, as the JAX einsum does; the kernel reads them as they are."""
    return ops.combine_tokens(y_sorted, plan.slot_rows,
                              combine_weights.to(y_sorted.dtype))


def combine_ragged_slots(y_sorted: torch.Tensor, plan: RaggedPlan,
                         combine_weights: torch.Tensor) -> torch.Tensor:
    """The ragged counterpart of :func:`combine_capacity_slots`: the
    un-sorted per-slot weighted outputs (T, k, dout), the sum over k left
    to the caller.  The ``combine_topk`` kernel at k = 1, one (token,
    slot) a row: row ``t * k + j`` reads sorted row ``plan.slot_rows[t,
    j]`` times ``w[t, j]``, multiplied in f32 and rounded once, which is
    the rounded product of the two (a product of two bf16 values is exact
    in f32)."""
    T, k = combine_weights.shape
    w = combine_weights.to(y_sorted.dtype).reshape(T * k, 1)
    rows = ops.combine_tokens(y_sorted, plan.slot_rows.reshape(T * k, 1), w)
    return rows.reshape(T, k, -1)


# ---------------------------------------------------------------------------
# Expert-choice dispatch — exact capacities by construction
# ---------------------------------------------------------------------------
#
# Each expert picks its top-C tokens, so every expert buffer is exactly C
# rows: no padding, no drops, a flat load.  Dispatch is a gather
# ``x[token_idx]`` into the (E, C, d) grid the capacity machinery exchanges,
# and the ragged layout is the uniform case ``group_sizes == C``.  A token
# may be taken by any number of experts, so the gather's gradient and the
# combine sum a variable count of rows a token: both in a fixed order
# (``ops.token_table``), deterministic on the card.


def ec_capacity(num_tokens: int, num_experts: int,
                capacity_factor: float) -> int:
    """Rows each expert picks: floor(T * cf / E), at least 1 and at most T
    (top-C over T tokens needs C <= T), as the reference."""
    return max(1, min(num_tokens,
                      int(num_tokens * capacity_factor / num_experts)))


def gather_ec(x: torch.Tensor, token_idx: torch.Tensor) -> torch.Tensor:
    """x (T, d) -> (*token_idx.shape, d): the rows the experts picked,
    through the by-destination ``gather_rows`` kernel
    (``ops.gather_rows_any``)."""
    return ops.gather_rows_any(x, token_idx).reshape(*token_idx.shape,
                                                     x.shape[-1])


class _CombineEC(torch.autograd.Function):
    """y[t] = sum over (e, c) with token_idx[e, c] == t of w[e, c] *
    out[e, c], in logical (e, c) order through ``ops.token_table``."""

    @staticmethod
    def forward(ctx, out, token_idx, weights, num_tokens):
        E, C, dout = out.shape
        flat = out.reshape(E * C, dout)
        w = weights.reshape(-1).to(out.dtype)
        table = ops.token_table(token_idx, num_tokens).long()
        rows = torch.cat([flat * w[:, None], flat.new_zeros(1, dout)])
        ctx.save_for_backward(out, token_idx, weights)
        return rows[table].sum(1)

    @staticmethod
    def backward(ctx, dy):
        out, token_idx, weights = ctx.saved_tensors
        dy_rows = dy[token_idx.reshape(-1).long()].reshape(out.shape)
        d_out = d_w = None
        if ctx.needs_input_grad[0]:
            d_out = dy_rows * weights.to(out.dtype)[..., None]
        if ctx.needs_input_grad[2]:
            d_w = (dy_rows * out).sum(-1).to(weights.dtype)
        return d_out, None, d_w, None


def combine_ec(out: torch.Tensor, token_idx: torch.Tensor,
               weights: torch.Tensor, num_tokens: int) -> torch.Tensor:
    """The weighted scatter-add of expert outputs (E, C, dout) back to
    token order (plain torch, as the reference's).  ``out`` must be in
    logical expert order, so the order of a token's sum does not depend on
    the expert layout."""
    return _CombineEC.apply(out, token_idx, weights, int(num_tokens))


def ec_to_physical(token_idx: torch.Tensor, table=None) -> torch.Tensor:
    """The (E, C) token grid from logical to physical expert order: row
    ``table[e]`` of the result is logical expert e's (uniform capacities
    make it a row permutation).  ``table``: the placement's logical ->
    physical ids (None = identity)."""
    if table is None:
        return token_idx
    return torch.empty_like(token_idx).index_copy_(0, table.long(), token_idx)


# ---------------------------------------------------------------------------
# Expert placement on the data plane: gate-id tables and the shadow split
# ---------------------------------------------------------------------------
#
# A placement (``repro_torch.placement.plan``) lays the experts out in a
# physical order: owned experts in slots ``[0, num_owned)``, contiguous per
# rank, and the shadowed experts, replicated on every expert-parallel rank,
# in ``[num_owned, E)``.  Shadowed rows are left out of the exchange and
# computed on the rank's own rows.  The layer reads a plan's tables and
# geometry only, so nothing here depends on the planner.


@functools.lru_cache(maxsize=256)
def _table_on(plan, device: str) -> torch.Tensor:
    return torch.as_tensor(
        np.asarray(plan.logical_to_physical).astype(np.int64), device=device)


def device_index_table(plan, device) -> torch.Tensor:
    """A plan's logical -> physical gate-id table(s) as an int64 tensor on
    ``device``: (E,) for a shared plan, (L, E) for a per-layer one.  Made
    once per (plan, device): a copy from pageable host memory waits for
    the stream, which a train step must not do at every layer."""
    return _table_on(plan, str(torch.device(device)))


class ShadowSpec(NamedTuple):
    """Split geometry of one (placement, per-rank capacity) pair."""

    num_experts: int
    num_owned: int
    main_capacity: int  # exchange buffer rows per owned expert
    shadow_capacity: int  # local buffer rows per shadowed expert

    @property
    def num_shadow(self) -> int:
        return self.num_experts - self.num_owned

    @property
    def width(self) -> int:
        """Dispatch buffer width (the largest per-expert capacity in use)."""
        if self.num_shadow == 0:
            return self.main_capacity
        return max(self.main_capacity, self.shadow_capacity)

    @property
    def capacities(self) -> np.ndarray:
        """Per-expert capacity in physical order."""
        caps = np.full(self.num_experts, self.main_capacity, np.int32)
        caps[self.num_owned:] = self.shadow_capacity
        return caps

    def a2a_elems(self, d_model: int) -> int:
        """Per-rank elements exchanged in one direction (for reporting)."""
        return self.num_owned * self.main_capacity * d_model


def shadow_spec(placement, num_experts: int, capacity: int) -> ShadowSpec:
    """Geometry under ``placement`` (an ``ExpertPlacement``; the identity
    geometry when None)."""
    if placement is None:
        return ShadowSpec(num_experts, num_experts, capacity, capacity)
    if placement.num_experts != num_experts:
        raise ValueError((placement.num_experts, num_experts))
    return ShadowSpec(num_experts, placement.num_owned,
                      placement.main_capacity(capacity), capacity)


def split_buffer(buf: torch.Tensor, spec: ShadowSpec):
    """(E, width, d) dispatch buffer -> (owned exchange part, local shadow
    part), views of ``buf``."""
    main = buf[:spec.num_owned, :spec.main_capacity]
    shadow = buf[spec.num_owned:, :spec.shadow_capacity]
    return main, shadow


def merge_outputs(out_main: torch.Tensor, out_shadow, spec: ShadowSpec
                  ) -> torch.Tensor:
    """The expert outputs reassembled into the (E, width, dout) combine
    buffer (rows past an expert's capacity zero)."""
    if spec.num_shadow == 0 and spec.main_capacity == spec.width:
        return out_main
    d_out = out_main.shape[-1]
    out = out_main.new_zeros(spec.num_experts, spec.width, d_out)
    out[:spec.num_owned, :spec.main_capacity] = out_main
    if out_shadow is not None and spec.num_shadow:
        out[spec.num_owned:, :spec.shadow_capacity] = out_shadow
    return out


def shadow_only(out_shadow: torch.Tensor, spec: ShadowSpec) -> torch.Tensor:
    """(S, shadow_capacity, dout) shadow outputs alone in a zeroed (E,
    width, dout) combine buffer: the placed psum mode's local addend.  The
    shadowed slots are left out of the reduction over the ranks and taken
    from this buffer instead (every rank of a model group holds the same
    tokens, so it is the same on each of them)."""
    out = out_shadow.new_zeros(spec.num_experts, spec.width,
                               out_shadow.shape[-1])
    out[spec.num_owned:, :spec.shadow_capacity] = out_shadow
    return out


# ---------------------------------------------------------------------------
# Cross-rank ragged plans — the expert-parallel dropless exchange (§3.2)
# ---------------------------------------------------------------------------
#
# Each rank's rows for peer p form one contiguous segment of its
# expert-sorted array (experts are contiguous per rank), laid into shard p
# of a (mp, bound, d) send buffer.  ``bound`` is the static pad-to-max-per-
# peer width; the valid lengths travel apart, as the (mp, E_local) counts
# all-to-all, so the receiver can compact the padded shards into one
# expert-sorted array for the grouped kernels.  bound = T*k never drops.


class RaggedXPlan(NamedTuple):
    """Send-side geometry of the ragged all-to-all, indexing the rank's
    expert-sorted rows (``make_ragged_plan`` order)."""

    send_dest: torch.Tensor  # (T*k,) int32 — slot in the flat (mp*bound)
    # send buffer; == mp*bound for rows not sent (over the bound)
    peer_counts: torch.Tensor  # (mp, E_local) int32 — rows that fit the
    # bound, per (destination rank, its local expert): the counts payload
    keep: torch.Tensor  # (T*k,) bool — owned rows that fit the bound
    num_owned_rows: torch.Tensor  # () int32 — rows routed to owned experts


def make_ragged_xplan(group_sizes: torch.Tensor, num_rows: int,
                      num_owned: int, num_peers: int,
                      bound: int) -> RaggedXPlan:
    """Lay this rank's ``num_rows`` sorted rows into per-peer shards of
    width ``bound``.

    group_sizes: (E,) of the local expert sort.  The first ``num_owned``
    experts take the exchange, ``num_owned // num_peers`` per peer in
    contiguous blocks.  A peer's rows keep their expert-sorted order inside
    its shard, and an over-full shard loses its trailing experts' rows.
    """
    dev = group_sizes.device
    e_pp = num_owned // num_peers
    raw = group_sizes[:num_owned].to(torch.int64).reshape(num_peers, e_pp)
    peer_tot = raw.sum(dim=1)
    cum = torch.cumsum(peer_tot, dim=0)  # (mp,) inclusive
    num_owned_rows = cum[-1]
    i = torch.arange(num_rows, dtype=torch.int64, device=dev)
    owned = i < num_owned_rows
    peer = torch.searchsorted(cum, i, right=True).clamp(0, num_peers - 1)
    within = i - (cum[peer] - peer_tot[peer])  # position inside the shard
    keep = owned & (within < bound)
    send_dest = torch.where(keep, peer * bound + within,
                            torch.full_like(i, num_peers * bound))
    off_in_peer = torch.cumsum(raw, dim=1) - raw  # exclusive, per peer
    peer_counts = torch.minimum(torch.clamp(bound - off_in_peer, min=0), raw)
    return RaggedXPlan(send_dest.to(torch.int32),
                       peer_counts.to(torch.int32), keep,
                       num_owned_rows.to(torch.int32))


def ragged_recv_compact(incoming: torch.Tensor, bound: int):
    """Compaction map for the received (mp, bound, d) shards.

    incoming: (mp, E_local) kept-row counts from each source rank (the
    counts all-to-all's output); shard s holds ``incoming[s].sum()`` valid
    rows, expert-sorted with segment lengths ``incoming[s]``.  Returns
    ``(dest, group_sizes)``: ``dest`` (mp*bound,) int32 maps each received
    slot to its row of the expert-sorted compact array (mp*bound for
    padding), and ``group_sizes`` (E_local,) int32 are the compact array's
    segments, source-major within an expert — global token order when
    ranks hold contiguous token blocks in rank order.
    """
    mp, e_local = incoming.shape
    inc = incoming.to(torch.int64)
    gs = inc.sum(dim=0)  # (E_local,)
    e_off = torch.cumsum(gs, dim=0) - gs  # exclusive expert offsets
    prior = torch.cumsum(inc, dim=0) - inc  # earlier sources' rows per e
    in_off = torch.cumsum(inc, dim=1) - inc  # within-source expert offsets
    cum_src = torch.cumsum(inc, dim=1)  # (mp, E_local) inclusive
    src_tot = inc.sum(dim=1)  # (mp,)
    idx = torch.arange(mp * bound, dtype=torch.int64, device=inc.device)
    s, j = idx // bound, idx % bound
    # expert of slot (s, j): how many inclusive boundaries j has passed
    e = (j[:, None] >= cum_src[s]).sum(dim=1).clamp(0, e_local - 1)
    valid = j < src_tot[s]
    dest = e_off[e] + prior[s, e] + (j - in_off[s, e])
    dest = torch.where(valid, dest, torch.full_like(dest, mp * bound))
    return dest.to(torch.int32), gs.to(torch.int32)


# ---------------------------------------------------------------------------
# Two-level (hierarchical) ragged exchange — node-level aggregation
# ---------------------------------------------------------------------------
#
# On a mesh with a node axis the flat per-peer shards first move within the
# node (a dim-1 exchange): each rank is then its node's forwarding agent for
# its own inner slot, holding every sibling's shard for rank (o, my_inner)
# of every node o.  The agent packs the n_inner valid prefixes into one
# slim shard per destination node (``inter_bound`` rows), so the inter-node
# exchange carries only the rows truly needed.  The receiver rebuilds the
# flat path's expert-sorted compact array (source-rank-major within an
# expert), so the two paths are bit-exact when nothing drops.


class HierAggPlan(NamedTuple):
    """Forwarding-agent geometry: n_inner padded shards -> one slim shard."""

    agg_dest: torch.Tensor  # (n_nodes*n_inner*bound,) int32 — slot in the
    # flat (n_nodes*inter_bound) slim buffer; == n_nodes*inter_bound when
    # the row is padding or over the inter bound
    kept_counts: torch.Tensor  # (n_nodes, n_inner, E_local) int32 — rows
    # that fit the inter bound, per (dest node, source sibling, expert)
    dropped: torch.Tensor  # () f32 — rows this agent dropped at the bound


def make_hier_agg(cnt_agg: torch.Tensor, bound: int,
                  inter_bound: int) -> HierAggPlan:
    """Pack per-sibling padded shards into slim per-node shards.

    cnt_agg: (n_nodes, n_inner, E_local), after the intra counts hop, the
    kept-row counts of sibling ``s``'s shard for destination node ``o``
    (each shard a valid prefix of ``cnt_agg[o, s].sum()`` rows padded to
    ``bound``).  The sibling prefixes follow each other in sibling order
    inside the slim shard; ``inter_bound`` cuts the trailing rows of an
    over-full node shard, counted in ``dropped``."""
    n_nodes, n_inner, e_local = cnt_agg.shape
    cnt = cnt_agg.to(torch.int64)
    seg = cnt.sum(-1)  # (n_nodes, n_inner) valid prefix lengths
    off = torch.cumsum(seg, dim=1) - seg  # sibling offsets in the slim shard
    idx = torch.arange(n_nodes * n_inner * bound, dtype=torch.int64,
                       device=cnt.device)
    o = idx // (n_inner * bound)
    s = (idx // bound) % n_inner
    b = idx % bound
    pos = off[o, s] + b
    valid = (b < seg[o, s]) & (pos < inter_bound)
    agg_dest = torch.where(valid, o * inter_bound + pos,
                           torch.full_like(idx, n_nodes * inter_bound))
    # experts fill each sibling run in order, so the bound cuts trailing
    # (sibling, expert) segments: make_ragged_xplan's clip pattern
    e_off = off[..., None] + (torch.cumsum(cnt, dim=-1) - cnt)
    kept = torch.minimum(torch.clamp(inter_bound - e_off, min=0), cnt)
    dropped = (cnt.sum() - kept.sum()).to(torch.float32)
    return HierAggPlan(agg_dest.to(torch.int32), kept.to(torch.int32), dropped)


def _hier_slots(incoming: torch.Tensor, inter_bound: int):
    """Per flat slot (n_nodes*inter_bound,) of the received slim shards:
    source node ``i``, source sibling ``s``, row ``r`` within the sibling's
    run, expert ``e``, and validity.  incoming: (n_nodes, n_inner, E_local)
    kept counts from every source rank (node-major); shard ``i`` holds
    sibling-major runs, each expert-sorted with lengths ``incoming[i, s]``."""
    n_nodes, n_inner, e_local = incoming.shape
    inc = incoming.to(torch.int64)
    seg = inc.sum(-1)  # (n_nodes, n_inner)
    soff = torch.cumsum(seg, dim=1) - seg
    cum_sib = torch.cumsum(seg, dim=1)  # inclusive
    cum_e = torch.cumsum(inc, dim=-1)  # inclusive, within a sibling
    idx = torch.arange(n_nodes * inter_bound, dtype=torch.int64,
                       device=inc.device)
    i, q = idx // inter_bound, idx % inter_bound
    s = (q[:, None] >= cum_sib[i]).sum(dim=1).clamp(0, n_inner - 1)
    r = q - soff[i, s]
    e = (r[:, None] >= cum_e[i, s]).sum(dim=1).clamp(0, e_local - 1)
    valid = q < cum_sib[i, n_inner - 1]
    return i, s, r, e, valid


def ragged_recv_compact_hier(incoming: torch.Tensor, inter_bound: int):
    """Two-level counterpart of :func:`ragged_recv_compact`: maps each
    received slim slot to its row of the same expert-sorted compact array
    the flat path builds (source-rank-major within an expert, ranks
    node-major).  Returns ``(dest (n_nodes*inter_bound,) int32, group_sizes
    (E_local,) int32)``; invalid slots map to ``n_nodes*inter_bound``."""
    n_nodes, n_inner, e_local = incoming.shape
    inc = incoming.to(torch.int64)
    flat_cnt = inc.reshape(n_nodes * n_inner, e_local)  # source-rank major
    gs = flat_cnt.sum(dim=0)
    e_off = torch.cumsum(gs, dim=0) - gs
    prior = torch.cumsum(flat_cnt, dim=0) - flat_cnt  # earlier sources' rows
    in_off = torch.cumsum(inc, dim=-1) - inc  # within-sibling expert offsets
    i, s, r, e, valid = _hier_slots(incoming, inter_bound)
    dest = e_off[e] + prior[i * n_inner + s, e] + (r - in_off[i, s, e])
    dest = torch.where(valid, dest, torch.full_like(dest,
                                                    n_nodes * inter_bound))
    return dest.to(torch.int32), gs.to(torch.int32)


def hier_chunk_plans(incoming: torch.Tensor, inter_bound: int,
                     n_chunks: int):
    """Per-chunk compaction maps for the expert compute per received chunk.

    Chunk ``c`` of the inter-node exchange delivers slots ``[c*w,
    (c+1)*w)`` of every source node's slim shard (``w = inter_bound //
    n_chunks``); its valid rows form their own expert-sorted mini array, so
    the grouped kernels can run on chunk ``c`` while chunk ``c+1`` is in
    flight.  Returns ``(dest (n_chunks, n_nodes*w) int32, gs (n_chunks,
    E_local) int32)``; ``dest`` maps a chunk's slots (node-major) into its
    mini array (invalid -> ``n_nodes*w``)."""
    n_nodes, n_inner, e_local = incoming.shape
    w = inter_bound // n_chunks
    _, _, _, e, valid = _hier_slots(incoming, inter_bound)

    def by_chunk(t):  # flat slots (i, q) -> (chunk c, node i, q within c)
        return t.reshape(n_nodes, n_chunks, w).transpose(0, 1).reshape(
            n_chunks, n_nodes * w)
    e_c, v_c = by_chunk(e), by_chunk(valid)
    onehot = F.one_hot(e_c, e_local) * v_c[..., None]
    gs = onehot.sum(dim=1)  # (n_chunks, E_local)
    g_off = torch.cumsum(gs, dim=-1) - gs
    before = torch.cumsum(onehot, dim=1) - onehot  # earlier slots per expert
    dest = (torch.gather(g_off, 1, e_c)
            + torch.gather(before, 2, e_c[..., None])[..., 0])
    dest = torch.where(v_c, dest, torch.full_like(dest, n_nodes * w))
    return dest.to(torch.int32), gs.to(torch.int32)


def scatter_rows(rows: torch.Tensor, dest: torch.Tensor,
                 num_slots: int) -> torch.Tensor:
    """(num_slots, d) buffer with ``rows[i]`` at slot ``dest[i]`` and zeros
    elsewhere; rows whose dest is ``num_slots`` are dropped (they land in a
    sacrificial extra row that is sliced off).  Differentiable in ``rows``."""
    buf = rows.new_zeros(num_slots + 1, rows.shape[-1])
    return buf.index_copy(0, dest.long(), rows)[:num_slots]


def gather_rows_fill(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``rows[idx]`` with zeros where ``idx == rows.shape[0]`` (the drop
    sentinel).  Differentiable in ``rows``."""
    padded = torch.cat([rows, rows.new_zeros(1, rows.shape[-1])])
    return padded.index_select(0, idx.long())
