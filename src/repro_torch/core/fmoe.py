"""The FMoE layer — paper §3 (system design) + §4 (reordered computation).

Functional analogue of FastMoE's ``FMoE`` / ``FMoETransformerMLP``:
arbitrary expert networks through an overloadable ``expert_fn`` (§3.1),
the scatter → per-expert GeMM → gather reordering (§4, Fig 4), with the
capacity and ragged dispatches of the JAX package and its three expert
implementations:

* ``einsum`` — plain PyTorch batched products (XLA's einsum in JAX);
* ``pallas`` — two passes of the grouped-GEMM kernel;
* ``fused``  — the fused GEMM1+act+GEMM2 kernel;

and expert parallelism across ranks (§3.2, Fig 2): a ``DistConfig`` over a
``launch.mesh.Mesh`` runs the counts all-to-all, the payload all-to-all,
the local experts, the return all-to-all and the combine, for both
dispatches, on ``torch.distributed``; or the psum mode (every rank
computes its own experts on all of its tokens and one all-reduce adds
them), which serves and trains.  Rank ``m`` of the model axis holds
experts ``[m * E_local, (m + 1) * E_local)`` (on a node mesh, index ``m``
over ``("node", "model")``, node-major); under expert-internal tensor
parallelism (``tp_axis``) rank ``d`` of the data axis holds hidden units
``[d * H_local, (d + 1) * H_local)`` of each of them.  The exchange runs
the §5.2 smart schedule (``overlap_chunks``, ``core/pipeline``) with an
optional narrower wire dtype, and on a node mesh the ragged exchange runs
two-level (``node_axis``).

Under an expert placement (``DistConfig.placement``, ``repro_torch.
placement``) the expert stacks are in the plan's physical order and the
gate's logical ids go through its table; the shadowed hot experts (the
physical tail, replicated on every rank after its owned block) are
computed on the rank's own rows: in the a2a mode outside the exchange, in
its first wire bubble, and in the psum mode outside the all-reduce, which
then reduces each (token, slot) apart so the output does not depend on
the layout.  The loads come back in logical order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import comm
from repro_torch.core import dispatch as D
from repro_torch.core import pipeline
from repro_torch.core.balance import (MoEMetrics, load_balance_loss,
                                      load_metrics, router_z_loss)
from repro_torch.core.gate import (EXPLORING, ROUTERS, expert_choice_forward,
                                   route_tokens, router_distill_loss,
                                   router_init)
from repro_torch.kernels import ops
from repro_torch.obs import counters as obs_counters


class DistConfig(NamedTuple):
    """How the MoE layer is distributed over a ``launch.mesh.Mesh``.

    mode "a2a" (tokens sharded over the expert axes too, the paper's §3.2
    all-to-all) when every expert axis is among ``token_axes``; otherwise
    "psum" (every rank of the expert group holds the same tokens, computes
    its own experts, and one all-reduce sums the outputs; its backward
    all-reduces the gradient, so it trains too).  ``x`` given to
    ``fmoe_apply`` is this rank's token shard; ranks hold contiguous token
    blocks in rank order.  ``expert_axis`` is "model", or ``("node",
    "model")`` on a node mesh (the mesh's ``expert_axes``).

      tp_axis — expert-internal tensor parallelism ("data", capacity
        dispatch, a2a mode): each expert's hidden dim stays sharded over
        the data axis; the rows are all-gathered over it before the expert
        FFN and the partial outputs reduce-scattered back.  The psum mode
        ignores it, as the reference does.
      overlap_chunks — the §5.2 smart schedule: split the payload into this
        many micro-shards (of the capacity, the ragged bound, or the slim
        inter-node bound) and pipeline the exchanges with the expert
        compute (``core/pipeline``).  0 or 1 = serial; a count that does
        not divide the dim falls back to the nearest that does.  Bit-exact
        against serial in the forward.
      wire_dtype — cast exchange payloads to this dtype across the wire
        only ("bf16" halves f32 bytes; the identity for a bf16 payload).
      ragged_bound — rows per peer shard of the ragged exchange: 0 = T_local
        * k, which never drops; a smaller bound drops the rows past it
        (counted in ``drop_frac``).
      node_axis — the two-level ragged exchange: the inter-node axis
        ("node"), which must lead ``expert_axis``.  The exchange then
        aggregates within the node (a hop over the node-local axes) and
        sends slim per-node shards over this axis, which carry only the
        rows truly needed.  Bit-exact against the flat exchange.  None, or
        a mesh without the axis, keeps the flat exchange.
      inter_bound — rows per slim per-node shard: 0 = n_inner *
        ragged_bound, which never drops there; a smaller bound drops the
        rows past it at the forwarding agent (also in ``drop_frac``).
      obs — compute the telemetry counters (``MoEMetrics.obs``,
        ``repro_torch.obs.counters``) from values the layer reduces anyway:
        no collective of their own, so turning them off leaves the
        collectives as they are.  Off: ``ObsCounters.zero()``.
      decompose — whether a chunked exchange takes the shifts of point-to-
        point sends (None: when chunked, as the reference) or one
        all-to-all a chunk (False).  The reference has it as an argument of
        its pipeline only; here it is a field because it is the one way a
        train step reaches the undecomposed exchange, and at one rank the
        shifts issue no collective: the card's single-rank runs take
        False to drive an async NCCL all-to-all a chunk, where a missing
        wait shows as a wrong result.

      router — the routing variant for this distribution in place of
        ``MoEConfig.router`` (None: the config's), as the reference's.
      placement — an ``ExpertPlacement`` (``repro_torch.placement``): the
        expert params are in its physical order (``placement.migrate``),
        the gate's ids go through its logical -> physical table, and in
        the a2a mode its shadowed experts run replicated outside the
        exchange, which carries the owned experts at the plan's (possibly
        shrunk) capacity.  At the model level it may be a
        ``PerLayerPlacement``; ``models.lm`` splits it into the shared
        geometry (which rides here) and each layer's table
        (``fmoe_apply``'s ``l2p``).  In the psum mode the shadowed experts
        run on every rank outside the all-reduce, which turns slot-wise
        (bit for bit the same output under any layout).  Shadowing refuses
        ``tp_axis``, as the reference does.

      fsdp_axis — the train layout's FSDP axis ("data"): the expert
        stacks arrive as hidden-dim shards over it, and the layer casts
        them to the compute dtype, then all-gathers them over it (the
        gather moves bf16; its backward reduce-scatters the gradient in
        f32), as the reference's ``fsdp_axis`` keeps the bf16 cast
        sharded.  ``tp_axis`` wins over it: under expert-internal TP the
        hidden shards are used as they are.
      layout — the rank's param layout (``launch.sharding.Layout``): the
        specs under which ``models.lm`` gathers each leaf at its use and
        ``core.sync`` syncs and clips by spec (:meth:`with_layout`).
        Training and serving on a mesh always have one (``launch.train``:
        the train layout; ``launch.serve.serve_setup``: serving's).  None:
        a lone MoE layer whose params are given as they are used.
    """

    mesh: Any
    token_axes: tuple
    expert_axis: Any = "model"
    tp_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    placement: Any = None
    overlap_chunks: int = 0
    wire_dtype: Optional[str] = None
    ragged_bound: int = 0
    node_axis: Optional[str] = None
    inter_bound: int = 0
    router: Optional[str] = None
    decompose: Optional[bool] = None
    obs: bool = True
    layout: Any = None

    @classmethod
    def local(cls, placement=None) -> "DistConfig":
        """Single-worker carrier: no mesh, no collectives; the way a
        placement rides to the single-worker path."""
        return cls(None, (), placement=placement)

    @property
    def expert_axes(self) -> tuple:
        return (tuple(self.expert_axis) if isinstance(self.expert_axis,
                                                      (tuple, list))
                else (self.expert_axis,))

    @property
    def mode(self) -> str:
        return ("a2a" if all(a in self.token_axes for a in self.expert_axes)
                else "psum")

    @property
    def expert_parallelism(self) -> int:
        return self.mesh.axes_size(self.expert_axes)

    @property
    def expert_tp(self) -> bool:
        """Whether the expert stacks are hidden-sharded over ``tp_axis``:
        set, and in the a2a mode (the psum mode ignores it)."""
        return self.tp_axis is not None and self.mode == "a2a"

    def with_layout(self, layout) -> "DistConfig":
        """This distribution over params held in ``layout``: where it
        shards the expert stacks' hidden dim over ``data`` and ``tp_axis``
        is unset, ``fsdp_axis="data"`` (the layer gathers them)."""
        fsdp = ("data" if self.tp_axis is None
                and "data" in layout.expert_hidden_axes() else None)
        return self._replace(layout=layout, fsdp_axis=fsdp)

    def decomposed(self, n_chunks: int) -> bool:
        """Whether an exchange split into ``n_chunks`` takes the shifts."""
        return n_chunks > 1 if self.decompose is None else self.decompose


def moe_dist(cfg, mesh, num_rows: int, *, expert_tp: bool = False,
             overlap_chunks: int = 0, wire_dtype: Optional[str] = None,
             ragged_bound=0, inter_bound: int = 0, placement=None,
             load_monitor=None, seq_len: int = 1,
             layout=None) -> DistConfig | None:
    """The expert-parallel mode for this (model config, mesh, global count
    of the rows that are split over the ranks: a layer's tokens, or the
    train entry's whole sequences of ``seq_len`` tokens).

    a2a (the paper's §3.2 exchange) when the rows split evenly over every
    rank; otherwise the psum mode, rows sharded over data where they split
    and else held whole by every rank.  The experts shard over the mesh's
    ``expert_axes``: "model", or ("node", "model") on a node mesh, whose
    ragged exchange then runs two-level (``node_axis="node"``).  The
    reference's options: ``expert_tp`` (``tp_axis="data"``),
    ``overlap_chunks``, ``wire_dtype``, ``ragged_bound`` and
    ``inter_bound``, all in the a2a mode; the psum fallbacks leave them
    unset.  ``placement`` rides on every mode.

    ``ragged_bound="auto"`` sizes the ragged shards from ``load_monitor``'s
    EMAs (``LoadMonitor.suggest_ragged_bound``, drop-guarded; and on a node
    mesh the slim inter-node shards too, unless ``inter_bound`` is given):
    a cold or missing monitor, or a bound that covers every local row,
    resolves to the dropless 0.  None when the config has no MoE or its
    experts do not split over the expert axes.

    ``layout`` (``launch.sharding.Layout``, the train layout) rides on
    every mode (:meth:`DistConfig.with_layout`)."""
    axes = mesh.expert_axes
    ep = mesh.axes_size(axes)
    if cfg.moe is None or cfg.moe.num_experts % ep:
        return None
    expert_axis = axes if len(axes) > 1 else axes[0]
    node = "node" if "node" in axes else None
    ib = int(inter_bound or 0)
    if ragged_bound == "auto":
        t_local = (num_rows * seq_len // mesh.size
                   if num_rows % mesh.size == 0 else 0)
        ragged_bound = 0
        if load_monitor is not None and t_local:
            k = cfg.moe.top_k
            ragged_bound = load_monitor.suggest_ragged_bound(t_local, k, ep)
            if ragged_bound >= t_local * k:
                ragged_bound = 0  # dropless: the canonical 0
            if node and ragged_bound and not ib:
                # a slim shard pools n_inner source ranks' rows; the peak is
                # still one rank block's share of them
                ib = load_monitor.suggest_ragged_bound(
                    t_local * (ep // mesh.shape["node"]), k, ep)
    if num_rows % mesh.size == 0:
        dist = DistConfig(mesh, tuple(mesh.axis_names),
                          expert_axis=expert_axis,
                          tp_axis="data" if expert_tp else None,
                          placement=placement,
                          overlap_chunks=int(overlap_chunks or 0),
                          wire_dtype=wire_dtype or None,
                          ragged_bound=int(ragged_bound or 0),
                          node_axis=node, inter_bound=ib)
    else:
        d_axes = tuple(a for a in mesh.axis_names if a == "data")
        dist = DistConfig(mesh, d_axes if num_rows % mesh.axes_size(d_axes)
                          == 0 else (), expert_axis=expert_axis,
                          placement=placement)
    return dist if layout is None else dist.with_layout(layout)


def _check_dist(dist: DistConfig) -> None:
    """Refuse settings the layer cannot run."""
    pipeline.wire_torch_dtype(dist.wire_dtype)  # refuses an unknown name
    if dist.mesh is None:
        return
    if dist.expert_axes != dist.mesh.expert_axes:
        raise ValueError(f"the port's mesh has axes {dist.mesh.axis_names}; "
                         f"experts shard over {dist.mesh.expert_axes}, not "
                         f"{dist.expert_axis!r}")
    if dist.tp_axis not in (None, "data"):
        raise ValueError(f"expert-internal tensor parallelism shards the "
                         f"hidden dim over 'data', not {dist.tp_axis!r}")
    if dist.fsdp_axis not in (None, "data"):
        raise ValueError(f"the train layout shards the expert stacks' hidden "
                         f"dim over 'data', not {dist.fsdp_axis!r}")


def _fsdp_gather(experts: dict, dist: DistConfig, dtype) -> dict:
    """Under ``fsdp_axis`` (and no ``tp_axis``, which wins): each expert
    stack's hidden-dim shard cast to ``dtype`` and all-gathered over the
    axis (``core.comm.gather_shard``: bf16 on the wire, the gradient
    reduce-scattered in f32).  Otherwise the stacks as they are."""
    if dist is None or dist.mesh is None or not dist.fsdp_axis or dist.tp_axis:
        return experts
    axes = (dist.fsdp_axis,)
    return {k: comm.gather_shard(v, [(1 if k == "wo" else 2, axes)],
                                 dist.mesh, dtype)
            for k, v in experts.items()}


def _check_placement(place, cfg: MoEConfig, dist: DistConfig) -> None:
    """Refuse a plan this layer cannot run: a per-layer plan (split by
    ``models.lm``), another expert count or rank count, shadowing with
    ``tp_axis``, or owned experts that do not split over the ranks."""
    if hasattr(place, "geometry"):  # a PerLayerPlacement
        raise TypeError(
            "fmoe_apply applies one layer; split a PerLayerPlacement into its "
            "geometry and per-layer l2p tables (models.lm does this for the "
            "whole stack)")
    if place.num_experts != cfg.num_experts:
        raise ValueError(f"placement has {place.num_experts} experts, config "
                         f"has {cfg.num_experts}")
    if dist.mesh is None:
        return
    mp = dist.expert_parallelism
    if place.num_ranks != mp:
        raise ValueError(f"placement built for {place.num_ranks} ranks, mesh "
                         f"expert parallelism is {mp}")
    if place.num_shadow:
        if dist.tp_axis:
            raise NotImplementedError(
                "expert shadowing with expert-internal TP (tp_axis) is "
                "refused, as the reference refuses it (ROADMAP §1 item 4)")
        if place.num_owned % mp or place.num_owned == 0:
            raise ValueError(f"owned experts {place.num_owned} must be a "
                             f"positive multiple of {mp}")


def _route_table(place, l2p, device):
    """The logical -> physical gate-id table of one layer: ``l2p`` (this
    layer's row of a per-layer plan) where given, else the shared plan's
    table; None for the identity routing."""
    if l2p is not None:
        return torch.as_tensor(l2p, device=device).long()
    if place is not None and not place.is_identity:
        return D.device_index_table(place, device)
    return None


# ---------------------------------------------------------------------------
# Expert networks (the default expert: a transformer FFN)
# ---------------------------------------------------------------------------


def _ffn_leaves(act: str) -> tuple:
    """The FFN's weight names, in tree order."""
    return ("wi_gate", "wi_up", "wo") if act == "swiglu" else ("wi", "wo")


def _ffn_init(gen: torch.Generator, d: int, h: int, act: str, *, device,
              dtype=torch.float32) -> dict:
    """Dense FFN weights in the JAX layout: wi (d, h), wo (h, d)."""
    return {name: (torch.randn((h, d) if name == "wo" else (d, h),
                               generator=gen, device=device)
                   * (h if name == "wo" else d) ** -0.5).to(dtype)
            for name in _ffn_leaves(act)}


_M64 = (1 << 64) - 1


def expert_seed(*parts: int) -> int:
    """A 63-bit generator seed mixed from integers (splitmix64 rounds)."""
    h = 0x9E3779B97F4A7C15
    for v in parts:
        h = ((h ^ (v & _M64)) * 0xBF58476D1CE4E5B9) & _M64
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & _M64
        h ^= h >> 29
    return h >> 1


def _expert_init(key: int, num: int, d: int, h: int, act: str, *, device,
                 dtype=torch.float32, experts: slice = slice(None),
                 hidden: slice = slice(None)) -> dict:
    """Routed expert stacks in the JAX layout, wi (num, d, h) and wo (num,
    h, d), or the shard ``experts`` x ``hidden`` of them.

    Expert ``e`` of leaf ``i`` is drawn alone from a generator seeded by
    ``expert_seed(key, i, e)``, so a rank draws only its experts, one at a
    time, and its shard equals the whole stack's slice bit for bit."""
    ids = range(num)[experts]
    hid = range(h)[hidden]
    meta = torch.device(device).type == "meta"  # the dry run: shapes only
    gen = None if meta else torch.Generator(device=device)
    p = {}
    for i, name in enumerate(_ffn_leaves(act)):
        wo = name == "wo"
        shape, scale = ((h, d), h ** -0.5) if wo else ((d, h), d ** -0.5)
        out = torch.empty((len(ids), len(hid), d) if wo
                          else (len(ids), d, len(hid)), dtype=dtype,
                          device=device)
        for j, e in enumerate([] if meta else ids):
            gen.manual_seed(expert_seed(key, i, e))
            w = torch.randn(shape, generator=gen, device=device) * scale
            out[j] = w[hidden] if wo else w[:, hidden]
        p[name] = out
    return p


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    if act == "gelu":
        return F.gelu(h, approximate="tanh")  # jax.nn.gelu's default form
    if act == "rwkv":  # squared relu (RWKV channel-mix)
        return torch.square(F.relu(h))
    return F.silu(h)  # swiglu gate handled by caller


def dense_ffn(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """Plain (non-expert) FFN on (..., d)."""
    if act == "swiglu":
        h = F.silu(x @ params["wi_gate"]) * (x @ params["wi_up"])
    else:
        h = _act(x @ params["wi"], act)
    return h @ params["wo"]


def expert_ffn(params: dict, xs: torch.Tensor, act: str) -> torch.Tensor:
    """Default ``expert_fn``: batched per-expert FFN on (E, n, d) buffers,
    plain PyTorch batched products."""
    if act == "swiglu":
        h = F.silu(torch.bmm(xs, params["wi_gate"]))
        h = h * torch.bmm(xs, params["wi_up"])
    else:
        h = _act(torch.bmm(xs, params["wi"]), act)
    return torch.bmm(h, params["wo"])


def _expert_ws(params: dict, act: str) -> tuple:
    """(wi_gate, wi_up) for swiglu, (wi,) otherwise — the kernels' contract."""
    return ((params["wi_gate"], params["wi_up"]) if act == "swiglu"
            else (params["wi"],))


def _equal_sizes(E: int, n: int, device) -> torch.Tensor:
    return torch.full((E,), n, dtype=torch.int32, device=device)


def expert_ffn_pallas(params: dict, xs: torch.Tensor, act: str) -> torch.Tensor:
    """expert_fn backed by the grouped-GEMM kernel (equal-size groups)."""
    E, n, d = xs.shape
    flat = xs.reshape(E * n, d)
    ys = ops.ffn_two_pass(flat, _expert_ws(params, act), params["wo"],
                          _equal_sizes(E, n, xs.device), act, "pallas")
    return ys.reshape(E, n, -1)


def expert_ffn_fused(params: dict, xs: torch.Tensor, act: str, *,
                     plan_rows: int = 0, plan_groups: int = 0) -> torch.Tensor:
    """expert_fn backed by the fused GEMM1+act+GEMM2 kernel: the (M, H)
    hidden activation never reaches device memory.  ``plan_rows`` and
    ``plan_groups``: the rows and experts the kernels plan their hidden
    split for (0 = the E * n and E given; the §5.2 schedule's micro-shards
    and the placed psum mode's launches pass the whole buffer's)."""
    E, n, d = xs.shape
    flat = xs.reshape(E * n, d)
    ys = ops.fused_grouped_ffn(flat, _expert_ws(params, act), params["wo"],
                               _equal_sizes(E, n, xs.device), act,
                               plan_rows=plan_rows, plan_groups=plan_groups)
    return ys.reshape(E, n, -1)


EXPERT_FNS: dict[str, Callable] = {
    "einsum": expert_ffn,
    "pallas": expert_ffn_pallas,
    "fused": expert_ffn_fused,
}


# Ragged (dropless) analogues: expert-sorted (T*k, d) rows with variable
# group sizes; the same selection axis as EXPERT_FNS.


def ragged_ffn_two_pass(params: dict, xs: torch.Tensor,
                        group_sizes: torch.Tensor, act: str,
                        impl: str = "pallas") -> torch.Tensor:
    return ops.ffn_two_pass(xs, _expert_ws(params, act), params["wo"],
                            group_sizes, act, impl)


def ragged_ffn_fused(params: dict, xs: torch.Tensor, group_sizes: torch.Tensor,
                     act: str, *, plan_rows: int = 0,
                     plan_groups: int = 0) -> torch.Tensor:
    return ops.fused_grouped_ffn(xs, _expert_ws(params, act), params["wo"],
                                 group_sizes, act, plan_rows=plan_rows,
                                 plan_groups=plan_groups)


def _ragged_einsum(params, xs, group_sizes, act):
    return ragged_ffn_two_pass(params, xs, group_sizes, act, impl="plain")


RAGGED_FNS: dict[str, Callable] = {
    # "einsum" = the plain PyTorch grouped product (XLA's ragged_dot in JAX)
    "einsum": _ragged_einsum,
    "pallas": ragged_ffn_two_pass,
    "fused": ragged_ffn_fused,
}


# ---------------------------------------------------------------------------
# Layer init
# ---------------------------------------------------------------------------


def fmoe_init(gen: torch.Generator, d_model: int, cfg: MoEConfig, *,
              act: str = "swiglu", d_ff_dense: int = 0, device,
              dtype=torch.float32, expert_key: int | None = None,
              shard: tuple = (slice(None), slice(None))) -> dict:
    """Parameters for one MoE FFN block (the router is always f32).

    The router and the shared and dense FFNs are drawn from ``gen``; the
    routed experts from ``expert_key`` (default: drawn from ``gen``), one
    expert at a time (``_expert_init``), ``shard`` = (experts, hidden
    units) of them (``launch.mesh.Mesh.expert_shard``)."""
    if expert_key is None:
        expert_key = int(torch.randint(1 << 62, (1,), generator=gen,
                                       device=device))
    params = {
        "router": router_init(gen, d_model, cfg, device=device),
        "experts": _expert_init(expert_key, cfg.num_experts, d_model,
                                cfg.d_expert_hidden, act, device=device,
                                dtype=dtype, experts=shard[0],
                                hidden=shard[1]),
    }
    if cfg.num_shared_experts:
        params["shared"] = _ffn_init(
            gen, d_model, cfg.num_shared_experts * cfg.d_expert_hidden,
            act, device=device, dtype=dtype)
    if cfg.dense_residual:
        params["dense"] = _ffn_init(gen, d_model,
                                    d_ff_dense or cfg.d_expert_hidden, act,
                                    device=device, dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# Local (single-worker) forward — paper §4 reordering
# ---------------------------------------------------------------------------


def _aux_loss(router: dict, x: torch.Tensor, g, cfg: MoEConfig) -> torch.Tensor:
    """The balance loss, plus the StableMoE stage-1 distillation term
    whenever a frozen router-to-be rides along and the router is not
    ``frozen`` (its gradient reaches only ``w_frozen``)."""
    aux = load_balance_loss(g.probs, g.expert_ids, cfg.num_experts)
    if cfg.router != "frozen" and "w_frozen" in router:
        aux = aux + router_distill_loss(router, x, g)
    return aux


def _ec_route(router: dict, x: torch.Tensor, cfg: MoEConfig, table=None):
    """Expert-choice routing shared by the MoE paths: (C, token_idx (E, C)
    in logical order, the same grid in physical order, weights (E, C),
    logits).  Under a2a each rank's experts pick from the tokens that rank
    holds, as the reference's."""
    C = D.ec_capacity(x.shape[0], cfg.num_experts, cfg.capacity_factor)
    token_idx, weights, _, logits = expert_choice_forward(router, x, cfg,
                                                          capacity=C)
    return C, token_idx, D.ec_to_physical(token_idx, table), weights, logits


def _logical(out: torch.Tensor, table) -> torch.Tensor:
    """Physical expert rows -> logical order (the combines sum a token's
    rows in logical order, whatever the layout)."""
    return out if table is None else out[table]


def _ec_flat_load(E: int, device) -> torch.Tensor:
    """Expert-choice load is flat by construction: every expert takes
    exactly C rows."""
    return torch.full((E,), 1.0 / E, device=device)


def _ec_metrics(x: torch.Tensor, logits: torch.Tensor, E: int) -> MoEMetrics:
    z = x.new_zeros((), dtype=torch.float32)
    return MoEMetrics(z, router_z_loss(logits), _ec_flat_load(E, x.device), z,
                      obs_counters.local_counters(dropped=0.0))


def _ec_uniform(E: int, C: int, device) -> torch.Tensor:
    return torch.full((E,), C, dtype=torch.int32, device=device)


def _moe_local(x: torch.Tensor, router: dict, experts: dict, cfg: MoEConfig,
               act: str, expert_fn: Callable, impl: str = "einsum",
               noise_seed=None, table=None):
    """The single-worker §4 path.  ``table``: a placement's logical ->
    physical gate ids (the experts are in its physical order); the load
    comes back in logical order."""
    T = x.shape[0]
    E = cfg.num_experts
    if cfg.router == "expert_choice":
        C, token_idx, ti_phys, ec_w, logits = _ec_route(router, x, cfg, table)
        if cfg.dispatch == "ragged":
            # the uniform-ragged case: group_sizes == C everywhere
            xs = D.gather_ec(x, ti_phys.reshape(-1))  # (E*C, d)
            out = RAGGED_FNS[impl](experts, xs, _ec_uniform(E, C, x.device),
                                   act).reshape(E, C, -1)
        else:
            out = expert_fn(experts, D.gather_ec(x, ti_phys), act)
        return (D.combine_ec(_logical(out, table), token_idx, ec_w, T),
                _ec_metrics(x, logits, E))
    g = route_tokens(router, x, cfg, noise_seed=noise_seed)
    expert_ids = g.expert_ids if table is None else table[g.expert_ids]
    if cfg.dispatch == "ragged":
        plan = D.make_ragged_plan(expert_ids, cfg.num_experts)
        xs = D.dispatch_ragged(x, plan)  # (T*k, d) expert-sorted
        ys = RAGGED_FNS[impl](experts, xs, plan.group_sizes, act)
        y = D.combine_ragged(ys, plan, g.combine_weights)
        load, drop = load_metrics(plan.group_sizes, None, T * cfg.top_k)
    else:
        C = D.expert_capacity(T, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
        plan = D.make_capacity_plan(expert_ids, cfg.num_experts, C)
        buf = D.dispatch_capacity(x, plan, cfg.num_experts)  # scatter (Fig 4)
        out = expert_fn(experts, buf, act)  # per-expert GeMM
        y = D.combine_capacity(out, plan, g.combine_weights)  # gather
        load, drop = load_metrics(plan.load, plan.keep, T * cfg.top_k)
    metrics = MoEMetrics(_aux_loss(router, x, g, cfg),
                         router_z_loss(g.logits), _logical(load, table), drop,
                         obs_counters.local_counters(
                             dropped=drop * (T * cfg.top_k)))
    return y, metrics


# ---------------------------------------------------------------------------
# Distributed forward — paper §3.2 global data exchange
# ---------------------------------------------------------------------------


def _dist_metrics(dist: DistConfig, load_part: torch.Tensor, aux, z, drop,
                  E: int, table=None, counters=None) -> MoEMetrics:
    """The layer's metrics over every token rank, in one all-reduce.

    ``load_part`` (E,) is this rank's share of the global assigned load in
    physical order (summed over the token ranks it is the global count per
    expert; ``table`` then puts it in logical order); aux, z and drop are
    this rank's and come back as their mean over the token ranks.  The aux
    and z losses keep their local gradient: the train step's gradient sync
    sums every rank's loss, which is the gradient of the mean.
    ``counters(global physical load, mean drop)`` makes the telemetry
    counters from the reduced values (with ``dist.obs``)."""
    group = dist.mesh.group(dist.token_axes)
    n = dist.mesh.axes_size(dist.token_axes)
    red = torch.cat([load_part.float(),
                     torch.stack([aux, z, drop]).detach().float()])
    comm.all_reduce_(red, group)
    load_global = _logical(red[:E], table)
    load = load_global / load_global.sum().clamp_min(1.0)
    aux_pm, z_pm, drop_pm = red[E:] / n
    obs = (counters(red[:E], drop_pm) if dist.obs and counters is not None
           else obs_counters.ObsCounters.zero())
    return MoEMetrics(_keep_grad(aux, aux_pm), _keep_grad(z, z_pm), load,
                      drop_pm, obs)


def _keep_grad(v: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` forward, ``v``'s gradient backward."""
    return v + (value - v.detach())


def _noise_rows(dist: DistConfig, t: int) -> tuple:
    """(start, total) of this rank's t tokens in the token set of its
    token axes (ranks hold contiguous blocks in rank order): the rows of
    the exploration draw that are this rank's, so that every mesh routes
    as the single rank would on the whole."""
    return (dist.mesh.axis_index(dist.token_axes) * t,
            dist.mesh.axes_size(dist.token_axes) * t)


def _moe_a2a(x: torch.Tensor, router: dict, experts: dict, cfg: MoEConfig,
             act: str, expert_fn: Callable, dist: DistConfig,
             noise_seed=None, shadow=None, table=None):
    """Tokens sharded over every mesh axis, experts over the expert axes.

    Per rank: gate -> dispatch into (E, C, d), C from the local token count
    -> the counts all-to-all (Fig 2's "exchange sizes", which feeds the
    load metric) -> the payload exchange -> the local experts on
    (E_local, mp*C, d) -> the return exchange -> combine.  With
    ``overlap_chunks > 1`` the exchanges and the expert compute run as the
    §5.2 smart schedule over capacity micro-shards.  The fused kernels plan
    every launch's hidden split for the whole (E, C) buffer's rows, so a
    row's sums depend neither on the chunking nor on the placement.
    Expert-choice fills the same (E, C, d) grid by a gather of the picked
    rows (exact capacities, nothing dropped) and combines with
    ``combine_ec`` in logical order.

    Under ``dist.placement`` (``experts`` the rank's owned block,
    ``shadow`` the shadowed experts, ``table`` the gate-id table): the
    owned slots ``[0, E_ns)`` take the exchange at the plan's main
    capacity, and the shadowed slots are computed on the rank's own rows
    at the full capacity, a launch of their own issued in the first wire
    bubble (``placement.shadow``)."""
    mesh = dist.mesh
    group = mesh.group(dist.expert_axes)
    mp = dist.expert_parallelism
    E = cfg.num_experts
    t, d = x.shape
    place = dist.placement
    ec = cfg.router == "expert_choice"
    if ec:
        C, token_idx, ti_phys, ec_w, logits = _ec_route(router, x, cfg, table)
        # exact uniform capacities: a shrink would only drop
        spec = D.shadow_spec(place, E, C)._replace(main_capacity=C,
                                                 shadow_capacity=C)
        buf = D.gather_ec(x, ti_phys)  # (E, C, d)
        assigned = _ec_uniform(E, C, x.device)
    else:
        g = route_tokens(router, x, cfg, noise_seed=noise_seed,
                         noise_rows=_noise_rows(dist, t))
        C = D.expert_capacity(t, E, cfg.top_k, cfg.capacity_factor)
        spec = D.shadow_spec(place, E, C)
        expert_ids = g.expert_ids if table is None else table[g.expert_ids]
        caps = C if place is None else tuple(int(c) for c in spec.capacities)
        plan = D.make_capacity_plan(expert_ids, E, caps)
        buf = D.dispatch_capacity(x, plan, E)  # (E, width, d)
        assigned = plan.load
    E_ns = spec.num_owned  # physical slots [0, E_ns) take the exchange
    E_local = E_ns // mp
    Cm = spec.main_capacity
    buf, buf_shadow = D.split_buffer(buf, spec)
    n_chunks = pipeline.resolve_chunks(dist.overlap_chunks or 1, Cm)
    tp = mesh.group(dist.tp_axis) if dist.tp_axis else None
    if expert_fn is expert_ffn_fused:
        tp_size = mesh.axes_size(dist.tp_axis) if tp else 1
        expert_fn = functools.partial(expert_ffn_fused,
                                      plan_rows=E * C * tp_size)

    def compute(b):  # (E_local, rows, d), row-independent
        if tp is None:
            return expert_fn(experts, b, act)
        # expert-internal tensor parallelism: the tp ranks hold different
        # rows and each a slice of every expert's hidden units (the act is
        # per hidden unit, so the FFN splits over them exactly); gather the
        # rows, compute the partial outputs, reduce-scatter them back
        out = expert_fn(experts, comm.all_gather_rows(b, tp, 1), act)
        return comm.reduce_scatter_rows(out, tp, 1)

    fill_fn = None
    if spec.num_shadow:
        def fill_fn():  # every rank, its own rows, no exchange
            return expert_fn(shadow, buf_shadow, act)
    decompose = dist.decomposed(n_chunks)
    incoming = pipeline.counts_all_to_all(assigned[:E_ns].reshape(mp, E_local),
                                          group, mp, decompose=decompose)
    out, out_shadow = pipeline.pipelined_expert_exchange(
        buf.reshape(mp, E_local, Cm, d), group, mp, n_chunks, compute,
        fill_fn=fill_fn, wire_dtype=dist.wire_dtype, decompose=decompose)
    d_out, out_dtype = out.shape[-1], out.dtype
    out = D.merge_outputs(out.reshape(E_ns, Cm, -1), out_shadow, spec)
    if ec:
        y = D.combine_ec(_logical(out, table), token_idx, ec_w, t)
    else:
        y = D.combine_capacity(out, plan, g.combine_weights)

    # the global load in physical order: my owned experts' received counts
    # in my slots and the shadowed experts' local assignments, summed over
    # the token ranks (an all-gather over the expert axes, a psum over data)
    m = mesh.axis_index(dist.expert_axes)
    load_part = x.new_zeros(E, dtype=torch.float32)
    load_part[m * E_local:(m + 1) * E_local] = incoming.sum(0).float()
    load_part[E_ns:] = assigned[E_ns:].float()
    n_ranks = mesh.axes_size(dist.token_axes)

    def counters(load_phys, drop_pm):  # the owned slots took the exchange
        return obs_counters.exchange_counters(
            frac=pipeline.wire_fraction(mp, decompose=decompose),
            fwd_rows=E_ns * Cm, d_in=d, in_dtype=x.dtype, ret_rows=E_ns * Cm,
            d_out=d_out, out_dtype=out_dtype, counts_elems=E_ns,
            wire_dtype=dist.wire_dtype,
            dropped=drop_pm * (t * cfg.top_k * n_ranks),
            shadow_hits=load_phys[E_ns:].sum() if spec.num_shadow else 0.0,
            imbalance=obs_counters.imbalance(load_phys[:E_ns], mp, E_local))
    if ec:
        zero = x.new_zeros((), dtype=torch.float32)
        return y, _dist_metrics(dist, load_part, zero, router_z_loss(logits),
                                zero, E, table, counters)
    _, drop = load_metrics(plan.load, plan.keep, t * cfg.top_k)
    metrics = _dist_metrics(
        dist, load_part, _aux_loss(router, x, g, cfg),
        router_z_loss(g.logits), drop, E, table, counters)
    return y, metrics


class _PinnedBackward(torch.autograd.Function):
    """``run(slim, weights)`` forward, and the gradient of ``serial(slim,
    weights)`` backward: the serial leg recomputed under grad and
    differentiated (the reference's ``custom_vjp`` around the inter-node
    leg's per-chunk compute, which keeps both directions bit-exact against
    the flat exchange)."""

    @staticmethod
    def forward(ctx, run, serial, slim, *weights):
        ctx.serial = serial
        ctx.save_for_backward(slim, *weights)
        return run(slim, weights)

    @staticmethod
    def backward(ctx, g):
        wants = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(w)
                   for t, w in zip(ctx.saved_tensors, wants)]
            out = ctx.serial(ins[0], tuple(ins[1:]))
            need = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, need, g) if need else ())
        return (None, None, *(next(got) if w else None for w in wants))


def _hier_exchange(send, xplan, experts, act, dist: DistConfig, impl: str,
                   B: int, E_local: int, fill_fn=None):
    """The two-level ragged exchange on a node mesh, from the flat (mp, B,
    d) send shards to the returned (mp, B, d_out) ones: the intra-node hop
    (every rank becomes its node's forwarding agent for its inner slot),
    the agents' slim per-node shards (``make_hier_agg``), the inter-node
    leg with the expert compute (serial or chunked; per received chunk for
    ``pallas`` and ``fused``, its backward pinned to the serial leg's),
    the de-aggregation and the intra-node return.  ``fill_fn`` (the
    shadowed experts) runs in the inter leg's first wire bubble, or just
    before the per-chunk leg, as the reference's.  Returns (ret, rows the
    agent dropped at the inter bound, fill_out, (n_inner, IB, decomposed))."""
    mesh = dist.mesh
    mp, _, d = send.shape
    node_ax = dist.node_axis
    if dist.expert_axes[0] != node_ax:
        raise ValueError(f"node_axis {node_ax!r} must lead expert_axes "
                         f"{dist.expert_axes!r} (ranks are node-major)")
    n_nodes = mesh.shape[node_ax]
    n_inner = mp // n_nodes
    inner_g = mesh.group(tuple(a for a in dist.expert_axes if a != node_ax))
    node_g = mesh.group(node_ax)
    IB = dist.inter_bound or n_inner * B  # slim shard rows (0: no drops)
    # the inter-node leg is chunked; the node-local hops run serially, and
    # decomposed alongside
    n_chunks = pipeline.resolve_chunks(dist.overlap_chunks or 1, IB)
    decomp = dist.decomposed(n_chunks)
    wire = dist.wire_dtype
    shards, cnt_agg = comm.exchange_ragged_intra(
        send.reshape(n_nodes, n_inner, B, d),
        xplan.peer_counts.reshape(n_nodes, n_inner, E_local), inner_g,
        n_inner, decompose=decomp, wire_dtype=wire)
    aplan = D.make_hier_agg(cnt_agg, B, IB)
    slim = D.scatter_rows(shards.reshape(-1, d), aplan.agg_dest,
                          n_nodes * IB).reshape(n_nodes, IB, d)
    if n_chunks > 1 and impl in ("pallas", "fused"):
        # each inter chunk's counts are known before its payload lands, so
        # the grouped kernels run on chunk c while chunk c+1 is in flight;
        # the fused kernels plan each chunk's hidden split for the whole
        # leg's rows.  Splitting dW over chunks would reassociate its f32
        # sums, so the backward is the serial leg's.
        w = IB // n_chunks
        incoming = pipeline.counts_all_to_all(
            aplan.kept_counts.reshape(n_nodes, -1), node_g, n_nodes,
            decompose=decomp).reshape(cnt_agg.shape)
        cplan, gs_local = D.ragged_recv_compact_hier(incoming, IB)
        cdest, cgs = D.hier_chunk_plans(incoming, IB, n_chunks)
        fn = RAGGED_FNS[impl]
        if impl == "fused":
            fn = functools.partial(ragged_ffn_fused, plan_rows=n_nodes * IB)
        names = list(experts)
        ex = dict(wire_dtype=wire, decompose=decomp)

        def serial_leg(slim_, ws):
            p = dict(zip(names, ws))
            recv = pipeline.chunked_all_to_all(slim_, node_g, n_nodes,
                                               n_chunks, **ex)
            xs = D.scatter_rows(recv.reshape(-1, d), cplan, n_nodes * IB)
            out = D.gather_rows_fill(fn(p, xs, gs_local, act), cplan)
            return pipeline.chunked_all_to_all(
                out.reshape(n_nodes, IB, -1), node_g, n_nodes, n_chunks, **ex)

        def chunked_leg(slim_, ws):
            p = dict(zip(names, ws))

            def chunk_fn(rc, c):
                mini = D.scatter_rows(rc.reshape(-1, d), cdest[c],
                                      n_nodes * w)
                ys = fn(p, mini, cgs[c], act)
                return D.gather_rows_fill(ys, cdest[c]).reshape(n_nodes, w, -1)
            return pipeline.hier_ragged_pipeline(slim_, node_g, n_nodes,
                                                 n_chunks, chunk_fn, **ex)[0]

        fill_out = fill_fn() if fill_fn is not None else None
        ret_slim = _PinnedBackward.apply(chunked_leg, serial_leg, slim,
                                         *experts.values())
    else:
        ex = dict(n_chunks=n_chunks, wire_dtype=wire, decompose=decomp)
        recv, incoming, fill_out = comm.exchange_ragged_inter(
            slim, aplan.kept_counts, node_g, n_nodes, fill_fn=fill_fn, **ex)
        cplan, gs_local = D.ragged_recv_compact_hier(incoming, IB)
        xs = D.scatter_rows(recv.reshape(-1, d), cplan, n_nodes * IB)
        ys = RAGGED_FNS[impl](experts, xs, gs_local, act)
        out = D.gather_rows_fill(ys, cplan)
        ret_slim = comm.return_ragged_inter(
            out.reshape(n_nodes, IB, -1), node_g, n_nodes, **ex)
    # de-aggregate (the outputs back to the padded sibling shards), then
    # invert the intra hop: ret lands in the flat (mp, B) shard layout
    d_out = ret_slim.shape[-1]
    padded = D.gather_rows_fill(ret_slim.reshape(-1, d_out), aplan.agg_dest)
    ret = comm.return_ragged_intra(
        padded.reshape(n_nodes, n_inner, B, d_out), inner_g, n_inner,
        decompose=decomp, wire_dtype=wire)
    return (ret.reshape(mp, B, d_out), aplan.dropped, fill_out,
            (n_inner, IB, decomp))


def _moe_a2a_ragged(x: torch.Tensor, router: dict, experts: dict,
                    cfg: MoEConfig, act: str, dist: DistConfig,
                    impl: str = "einsum", noise_seed=None, shadow=None,
                    table=None):
    """Dropless expert parallelism — the load-sized exchange.

      1. the counts all-to-all: each rank tells peer p how many rows it
         routed to each of p's experts;
      2. the payload exchange: the expert-sorted rows in (mp, bound, d)
         pad-to-max-per-peer shards (``dist.ragged_bound``; 0 = T_local*k,
         which never drops), micro-sharded with ``overlap_chunks``;
      3. the receiver compacts the valid prefixes into one expert-sorted
         array and runs the grouped kernels (``RAGGED_FNS[impl]``);
      4. the return exchange brings the rows back into the slots they
         were sent from, and ``combine_ragged`` applies the gate weights.

    On a node mesh with ``node_axis`` the exchange runs two-level
    (:func:`_hier_exchange`), bit-exact against this flat one when nothing
    drops.  The packing and compaction are plain index copies, with a zero
    row for the drop sentinel, as the reference's scatters and gathers
    are.  Expert-choice is the uniform case: its (E, C) grid flattened
    expert-major, group sizes C.

    Under ``dist.placement`` the rows of the shadowed experts, the sorted
    tail ``[num_owned_rows, n)``, never cross the wire: shifted to offset
    0 they go through the grouped kernels over the ``shadow`` stacks, a
    launch of its own issued in the first wire bubble (planned, for
    ``fused``, for the exchange compute's rows)."""
    mesh = dist.mesh
    mp = dist.expert_parallelism
    E = cfg.num_experts
    t, d = x.shape
    place = dist.placement
    E_ns = E if place is None else place.num_owned  # the rest: shadowed
    ec = cfg.router == "expert_choice"
    if ec:
        C, token_idx, ti_phys, ec_w, logits = _ec_route(router, x, cfg, table)
        n = E * C
        gs = _ec_uniform(E, C, x.device)
        x_sorted = D.gather_ec(x, ti_phys.reshape(-1))  # (n, d)
    else:
        g = route_tokens(router, x, cfg, noise_seed=noise_seed,
                         noise_rows=_noise_rows(dist, t))
        n = t * cfg.top_k
        expert_ids = g.expert_ids if table is None else table[g.expert_ids]
        plan = D.make_ragged_plan(expert_ids, E)  # physical-order sort
        gs = plan.group_sizes
        x_sorted = D.dispatch_ragged(x, plan)  # (n, d), the gather_rows kernel
    B = dist.ragged_bound or n
    xplan = D.make_ragged_xplan(gs, n, E_ns, mp, B)
    send = D.scatter_rows(x_sorted, xplan.send_dest, mp * B).reshape(mp, B, d)

    fill_fn = shadow_dest = None
    if E_ns < E:
        i = torch.arange(n, device=x.device)
        shadow_dest = torch.where(i >= xplan.num_owned_rows,
                                  i - xplan.num_owned_rows, n)
        xs_sh = D.scatter_rows(x_sorted, shadow_dest, n)
        fn = RAGGED_FNS[impl]
        if impl == "fused":
            fn = functools.partial(ragged_ffn_fused, plan_rows=mp * B)

        def fill_fn():  # every rank, its own rows, no exchange
            return fn(shadow, xs_sh, gs[E_ns:], act)

    node_ax = dist.node_axis
    n_nodes = (mesh.shape[node_ax] if node_ax in dist.expert_axes else 1)
    agg_dropped = 0.0
    hier = 1 < n_nodes < mp
    if hier:
        ret, agg_dropped, fill_out, (n_inner, IB, decomp) = _hier_exchange(
            send, xplan, experts, act, dist, impl, B, E_ns // mp, fill_fn)
    else:
        group = mesh.group(dist.expert_axes)
        n_chunks = pipeline.resolve_chunks(dist.overlap_chunks or 1, B)
        ex = dict(n_chunks=n_chunks, wire_dtype=dist.wire_dtype,
                  decompose=dist.decomposed(n_chunks))
        recv, incoming, fill_out = comm.exchange_ragged(
            send, xplan.peer_counts, group, mp, fill_fn=fill_fn, **ex)
        # source-major within an expert = global token order, as ranks hold
        # contiguous token blocks in rank order
        cplan, gs_local = D.ragged_recv_compact(incoming, B)
        xs = D.scatter_rows(recv.reshape(mp * B, d), cplan, mp * B)
        ys = RAGGED_FNS[impl](experts, xs, gs_local, act)
        out = D.gather_rows_fill(ys, cplan)  # back to the shard slots
        ret = comm.return_ragged(out.reshape(mp, B, -1), group, mp, **ex)
        decomp = ex["decompose"]
    y_sorted = D.gather_rows_fill(ret.reshape(mp * B, -1), xplan.send_dest)
    if fill_fn is not None:
        y_sorted = y_sorted + D.gather_rows_fill(fill_out, shadow_dest)
    if ec:
        y = D.combine_ec(_logical(y_sorted.reshape(E, C, -1), table),
                         token_idx, ec_w, t)
        aux = x.new_zeros((), dtype=torch.float32)
        z = router_z_loss(logits)
    else:
        y = D.combine_ragged(y_sorted, plan, g.combine_weights)
        aux, z = _aux_loss(router, x, g, cfg), router_z_loss(g.logits)

    # rows over the peer bound, and those the forwarding agent dropped at
    # the inter bound: the mean over the ranks is the global fraction
    dropped = (xplan.num_owned_rows - xplan.keep.sum()).float() + agg_dropped
    n_ranks = mesh.axes_size(dist.token_axes)

    def counters(load_phys, drop_pm):
        kw = dict(d_in=d, in_dtype=x.dtype, d_out=ret.shape[-1],
                  out_dtype=ret.dtype, counts_elems=E_ns,
                  wire_dtype=dist.wire_dtype, dropped=drop_pm * (n * n_ranks),
                  shadow_hits=load_phys[E_ns:].sum() if E_ns < E else 0.0,
                  imbalance=obs_counters.imbalance(load_phys[:E_ns], mp,
                                                   E_ns // mp))
        if hier:
            return obs_counters.hier_exchange_counters(
                intra_frac=pipeline.wire_fraction(n_inner, decompose=decomp),
                inter_frac=pipeline.wire_fraction(n_nodes, decompose=decomp),
                intra_rows=mp * B, inter_rows=n_nodes * IB, **kw)
        return obs_counters.exchange_counters(
            frac=pipeline.wire_fraction(mp, decompose=decomp),
            fwd_rows=mp * B, ret_rows=mp * B, **kw)
    return y, _dist_metrics(dist, gs, aux, z, dropped / n, E, table, counters)


def _psum_fns(impl: str, expert_fn: Callable, rows: int, groups: int):
    """The psum mode's (ragged, capacity) expert functions: for ``fused``
    every launch (the rank's owned segment, the shadowed tail) plans its
    hidden split for the whole buffer's ``rows`` and ``groups``, so a
    row's sums do not depend on which launch holds its expert."""
    if impl != "fused":
        return RAGGED_FNS[impl], expert_fn
    return (functools.partial(ragged_ffn_fused, plan_rows=rows,
                              plan_groups=groups),
            functools.partial(expert_ffn_fused, plan_rows=rows,
                              plan_groups=groups))


def _moe_psum(x: torch.Tensor, router: dict, experts: dict, cfg: MoEConfig,
              act: str, expert_fn: Callable, dist: DistConfig,
              impl: str = "einsum", noise_seed=None, shadow=None, table=None):
    """Tokens not sharded over the expert axis (decode, and batches that do
    not split over every rank): every rank gates all of its tokens,
    computes only its own experts, and one all-reduce (SUM) over the model
    group adds the ranks' parts.  No all-to-all.

    capacity: the rank's (E_local, C, d) slice of the dispatch buffer, its
    output placed in an otherwise zero (E, C, d) buffer for the combine;
    ragged: the rank's contiguous segment of the expert-sorted rows, shifted
    to offset 0 (``scatter_rows``) for the grouped kernels on the rank's
    group sizes (rows past them come out zero) and back
    (``gather_rows_fill``) — dropless, as the local path.  load, drop_frac,
    aux and z are the means over ``token_axes`` (the load averaged in
    physical order, then put in logical order).  At world size 1 with no
    placement this is the local path bit for bit: the segment is every row
    at offset 0 and the all-reduce of a one-rank group is an identity.

    Under a placement (``table`` the gate-id table, ``experts`` the rank's
    block of the owned experts, ``shadow`` the shadowed ones): the owned
    experts form rank blocks of ``num_owned // mp``; the shadowed experts
    run on every rank on its own (identical) tokens, from its replicas,
    and are added *after* the all-reduce.  The reduction is then slot-wise:
    the per-slot weighted outputs (``combine_*_slots``, each rounded once,
    on whichever rank serves the slot) are all-reduced, the shadow addend
    added, and the k slots summed in a fixed order, so no rounding sees
    which rank served a slot: permuting or shadowing experts leaves the
    output bit for bit as it was.  Without a placement the cheaper combined
    (t, d) all-reduce stays (the slot-wise one carries k times the
    payload).  The capacity branch keeps the full capacity C whatever the
    plan's shrink: there is no wire here, so a smaller buffer would only
    drop rows.

    Training: the all-reduce's backward sums the ranks' gradients of ``y``,
    so each model rank's owned experts, router and upstream take M times
    their part of its data block's gradient (M ranks in the model group
    hold the same loss), the shadow path once on each of the M ranks; aux
    and z keep the rank's own gradient.  ``core.sync``'s sum over the world
    (owned experts: over data) divided by the world size is then the mean
    over the data blocks, as in the a2a mode."""
    mp = dist.expert_parallelism
    m = dist.mesh.axis_index(dist.expert_axes)
    E = cfg.num_experts
    place = dist.placement
    E_ns = E if place is None else place.num_owned  # the rest: shadowed
    E_local = E_ns // mp
    mine = slice(m * E_local, (m + 1) * E_local)
    t = x.shape[0]
    if cfg.router == "expert_choice":
        return _moe_psum_ec(x, router, experts, cfg, act, expert_fn, dist,
                            impl, shadow, table)
    g = route_tokens(router, x, cfg, noise_seed=noise_seed,
                     noise_rows=_noise_rows(dist, t))
    expert_ids = g.expert_ids if table is None else table[g.expert_ids]
    group = dist.mesh.group(dist.expert_axes)
    # the layout-invariant slot-wise reduction only under a placement
    slotwise = table is not None or bool(shadow)
    if cfg.dispatch == "ragged":
        n = t * cfg.top_k
        ragged_fn, _ = _psum_fns(impl, expert_fn, n, E)
        plan = D.make_ragged_plan(expert_ids, E)
        x_sorted = D.dispatch_ragged(x, plan)  # (n, d), the gather_rows kernel
        gs = plan.group_sizes
        offs = torch.cumsum(gs, 0) - gs  # each expert's first sorted row
        i = torch.arange(n, device=x.device)

        def segment(lo, count):  # sorted rows [lo, lo + count) -> [0, count)
            return torch.where((i >= lo) & (i < lo + count), i - lo, n)

        dest = segment(offs[m * E_local], gs[mine].sum())
        ys = ragged_fn(experts, D.scatter_rows(x_sorted, dest, n), gs[mine],
                       act)
        y_sorted = D.gather_rows_fill(ys, dest)
        if slotwise:
            c = comm.all_reduce_sum(
                D.combine_ragged_slots(y_sorted, plan, g.combine_weights),
                group)
            payload = c
            if shadow:  # the sorted tail [offs[E_ns], n), at offset 0
                dest_sh = segment(offs[E_ns], n)
                ys_sh = ragged_fn(shadow, D.scatter_rows(x_sorted, dest_sh, n),
                                  gs[E_ns:], act)
                c = c + D.combine_ragged_slots(
                    D.gather_rows_fill(ys_sh, dest_sh), plan,
                    g.combine_weights)
            payload = c
            y = c.sum(1)
        else:
            y = payload = comm.all_reduce_sum(
                D.combine_ragged(y_sorted, plan, g.combine_weights), group)
        load, drop = load_metrics(gs, None, n)
        denom = n
    else:
        C = D.expert_capacity(t, E, cfg.top_k, cfg.capacity_factor)
        _, cap_fn = _psum_fns(impl, expert_fn, E * C, E)
        # the full capacity for every expert: no wire, so no shrink
        spec = D.shadow_spec(place, E, C)._replace(main_capacity=C)
        plan = D.make_capacity_plan(expert_ids, E, C)
        buf_main, buf_shadow = D.split_buffer(D.dispatch_capacity(x, plan, E),
                                              spec)  # (E, C, d) scatter
        out_local = cap_fn(experts, buf_main[mine], act)
        out = out_local.new_zeros(E, C, out_local.shape[-1])
        out[mine] = out_local  # the shadowed slots stay zero here
        if slotwise:
            c = comm.all_reduce_sum(
                D.combine_capacity_slots(out, plan, g.combine_weights), group)
            payload = c
            if shadow:
                out_sh = cap_fn(shadow, buf_shadow, act)
                c = c + D.combine_capacity_slots(D.shadow_only(out_sh, spec),
                                                 plan, g.combine_weights)
            y = c.sum(1)
        else:
            y = payload = comm.all_reduce_sum(
                D.combine_capacity(out, plan, g.combine_weights), group)
        load, drop = load_metrics(plan.load, plan.keep, t * cfg.top_k)
        denom = t * cfg.top_k
    n_ranks = dist.mesh.axes_size(dist.token_axes)

    def counters(load_pm, drop_pm):  # normalized loads, physical order
        return obs_counters.reduction_counters(
            payload_elems=payload.numel(), payload_dtype=payload.dtype,
            dropped=drop_pm * (denom * n_ranks),
            shadow_hits=(load_pm[E_ns:].sum() * (denom * n_ranks)
                         if E_ns < E else 0.0),
            imbalance=obs_counters.imbalance(load_pm[:E_ns], mp, E_local))
    return y, _psum_metrics(dist, MoEMetrics(_aux_loss(router, x, g, cfg),
                                             router_z_loss(g.logits), load,
                                             drop), table, counters)


def _psum_metrics(dist: DistConfig, m: MoEMetrics, table=None,
                  counters=None) -> MoEMetrics:
    """The psum mode's metrics: the means over the token ranks, in one
    all-reduce (aux and z keep the rank's own gradient); the load, given
    in physical order, comes back in logical order (``table``).
    ``counters(mean physical load, mean drop)`` makes the telemetry
    counters from the reduced values (with ``dist.obs``)."""
    ranks = dist.mesh.axes_size(dist.token_axes)
    zero = obs_counters.ObsCounters.zero()
    if ranks == 1:
        obs = (counters(m.load, m.drop_frac)
               if dist.obs and counters is not None else zero)
        return m._replace(load=_logical(m.load, table), obs=obs)
    E = m.load.shape[0]
    red = torch.cat([m.load, torch.stack([m.aux_loss, m.z_loss, m.drop_frac])
                     .detach().float()])
    comm.all_reduce_(red, dist.mesh.group(dist.token_axes))
    red = red / ranks
    obs = (counters(red[:E], red[E + 2])
           if dist.obs and counters is not None else zero)
    return MoEMetrics(_keep_grad(m.aux_loss, red[E]),
                      _keep_grad(m.z_loss, red[E + 1]),
                      _logical(red[:E], table), red[E + 2], obs)


def _moe_psum_ec(x: torch.Tensor, router: dict, experts: dict,
                 cfg: MoEConfig, act: str, expert_fn: Callable,
                 dist: DistConfig, impl: str = "einsum", shadow=None,
                 table=None):
    """Expert-choice in the psum mode: every rank of the model group routes
    the same tokens to the same (E, C) grid, computes its own experts' rows
    of it (zeros elsewhere), and one all-reduce of the grid over the model
    group adds the disjoint blocks (exact: the other ranks add zeros).
    Under a placement the grid is in physical order (``table``), the
    all-reduce carries the owned experts' rows, and the shadowed experts'
    rows, computed on every rank, are appended outside it; the combine
    then runs in logical order, as the local path's, so the result does
    not depend on the layout."""
    mp = dist.expert_parallelism
    m = dist.mesh.axis_index(dist.expert_axes)
    E = cfg.num_experts
    place = dist.placement
    E_ns = E if place is None else place.num_owned
    E_local = E_ns // mp
    mine = slice(m * E_local, (m + 1) * E_local)
    t = x.shape[0]
    C, token_idx, ti_phys, ec_w, logits = _ec_route(router, x, cfg, table)
    group = dist.mesh.group(dist.expert_axes)
    ragged_fn, cap_fn = _psum_fns(impl, expert_fn, E * C, E)
    if cfg.dispatch == "ragged":
        n = E * C
        x_sorted = D.gather_ec(x, ti_phys.reshape(-1))  # (n, d)
        i = torch.arange(n, device=x.device)

        def segment(lo, count):  # rows [lo, lo + count) -> [0, count)
            return torch.where((i >= lo) & (i < lo + count), i - lo, n)

        dest = segment(m * E_local * C, E_local * C)
        ys = ragged_fn(experts, D.scatter_rows(x_sorted, dest, n),
                       _ec_uniform(E_local, C, x.device), act)
        rows = payload = comm.all_reduce_sum(D.gather_rows_fill(ys, dest),
                                             group)
        if shadow:  # the tail [E_ns * C, n), at offset 0
            dest_sh = segment(E_ns * C, n)
            ys_sh = ragged_fn(shadow, D.scatter_rows(x_sorted, dest_sh, n),
                              _ec_uniform(E - E_ns, C, x.device), act)
            rows = rows + D.gather_rows_fill(ys_sh, dest_sh)
        out = rows.reshape(E, C, -1)
    else:
        buf = D.gather_ec(x, ti_phys)  # (E, C, d)
        out_local = cap_fn(experts, buf[mine], act)
        out = out_local.new_zeros(E_ns, C, out_local.shape[-1])
        out[mine] = out_local
        out = payload = comm.all_reduce_sum(out, group)
        if E_ns < E:  # every rank, its own tokens, outside the reduction
            out = torch.cat([out, cap_fn(shadow, buf[E_ns:], act)])
    y = D.combine_ec(_logical(out, table), token_idx, ec_w, t)
    n_ranks = dist.mesh.axes_size(dist.token_axes)

    def counters(load_pm, drop_pm):  # exact capacities: nothing dropped
        return obs_counters.reduction_counters(
            payload_elems=payload.numel(), payload_dtype=payload.dtype,
            dropped=0.0, shadow_hits=float((E - E_ns) * C * n_ranks),
            imbalance=1.0)
    return y, _psum_metrics(dist, _ec_metrics(x, logits, E), None, counters)


def fmoe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
               act: str = "swiglu", dist=None, impl: str = "einsum",
               noise_seed: Optional[int] = None, l2p=None):
    """Apply the MoE FFN to ``x`` of shape (..., d_model).

    Returns ``(y, MoEMetrics)``.  ``impl`` selects the expert kernels
    ("einsum" | "pallas" | "fused") on both dispatch modes.  ``dist=None``
    (or a ``DistConfig`` without a mesh) runs the single-worker §4 path;
    a ``DistConfig`` over a mesh runs the §3.2 exchange (a2a) or the psum
    mode, with ``x`` this rank's token shard and ``params["experts"]`` its
    expert shard (its hidden slice of them under ``tp_axis``).  The
    shared and dense residual FFNs run on the local tokens.

    ``dist.placement`` (an ``ExpertPlacement``): ``params["experts"]`` are
    in its physical order (on a mesh: the rank's owned block, then the
    shadowed experts, in the a2a and the psum mode alike), and routing
    stays in logical expert space through its table; ``DistConfig.local(placement=plan)`` carries it to the
    single-worker path.  ``l2p`` is this layer's logical -> physical table
    when the plan is per-layer (``models.lm`` splits a
    ``PerLayerPlacement`` into the shared geometry on ``dist.placement``
    and the per-layer tables); a ``PerLayerPlacement`` itself is refused
    here.

    ``cfg.router`` (or ``dist.router`` where set) picks the router on every
    path.  ``noise_seed`` arms the exploration of ``noisy_topk`` and
    ``gumbel`` (``gate.route_tokens``): a rank draws its rows of the noise
    over its token axes' whole token set, so any mesh routes as one rank
    would.  Expert-choice picks from the tokens a rank holds.
    """
    place = None
    if dist is not None:
        _check_dist(dist)
        if dist.router is not None and dist.router != cfg.router:
            # the dist channel pins the routing variant (serve-time frozen
            # routing, say) without touching the model config
            cfg = dataclasses.replace(cfg, router=dist.router)
        if dist.mesh is not None and dist.tp_axis and cfg.dispatch == "ragged":
            # as the reference: the grouped ragged kernels take flat sorted
            # rows, to which the capacity path's per-row tp gather and
            # scatter do not apply
            raise NotImplementedError(
                "ragged dispatch + expert-internal TP (use capacity)")
        place = dist.placement
        if place is not None:
            _check_placement(place, cfg, dist)
            if place.is_identity:
                place = None
                dist = dist._replace(placement=None)
    if cfg.router not in ROUTERS:
        raise ValueError(f"unknown router {cfg.router!r}; one of {ROUTERS}")
    expert_fn = EXPERT_FNS[impl]
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    router = params["router"]
    experts = _fsdp_gather(params["experts"], dist, x.dtype)
    table = _route_table(place, l2p, x.device)
    if cfg.router not in EXPLORING:
        noise_seed = None  # every other router runs without a draw
    kw = dict(noise_seed=noise_seed)
    if dist is None or dist.mesh is None:
        y, metrics = _moe_local(xf, router, experts, cfg, act, expert_fn,
                                impl=impl, table=table, **kw)
    else:
        shadow = {}
        if place is not None and place.num_shadow:
            # the shadowed experts: the tail of the rank's stacks
            own = place.num_owned // dist.expert_parallelism
            for k, v in experts.items():
                if v.shape[0] != own + place.num_shadow:
                    raise ValueError(
                        f"experts/{k} holds {v.shape[0]} experts; the plan "
                        f"puts {own} owned + {place.num_shadow} shadowed on "
                        f"a rank (placement.migrate lays them out)")
            # one split: its backward writes each leaf's gradient once
            parts = {k: v.split([own, place.num_shadow])
                     for k, v in experts.items()}
            experts = {k: v[0] for k, v in parts.items()}
            shadow = {k: v[1] for k, v in parts.items()}
        kw.update(shadow=shadow, table=table)
        if dist.mode == "psum":
            y, metrics = _moe_psum(xf, router, experts, cfg, act, expert_fn,
                                   dist, impl=impl, **kw)
        elif cfg.dispatch == "ragged":
            y, metrics = _moe_a2a_ragged(xf, router, experts, cfg, act, dist,
                                         impl=impl, **kw)
        else:
            y, metrics = _moe_a2a(xf, router, experts, cfg, act, expert_fn,
                                  dist, **kw)
    for k in ("shared", "dense"):
        if k in params:
            y = y + dense_ffn(params[k], xf, act)
    return y.reshape(shape), metrics
