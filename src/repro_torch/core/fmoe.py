"""The FMoE layer — paper §3 (system design) + §4 (reordered computation),
single worker.

Functional analogue of FastMoE's ``FMoE`` / ``FMoETransformerMLP``:
arbitrary expert networks through an overloadable ``expert_fn`` (§3.1) and
the scatter → per-expert GeMM → gather reordering (§4, Fig 4), with the
capacity and ragged dispatches of the JAX package and its three expert
implementations:

* ``einsum`` — plain PyTorch batched products (XLA's einsum in JAX);
* ``pallas`` — two passes of the grouped-GEMM kernel;
* ``fused``  — the fused GEMM1+act+GEMM2 kernel.

Expert parallelism (§3.2, a ``dist`` with a mesh) is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core import dispatch as D
from repro_torch.core.balance import (MoEMetrics, load_balance_loss,
                                      load_metrics, router_z_loss)
from repro_torch.core.gate import route_tokens, router_init
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Expert networks (the default expert: a transformer FFN)
# ---------------------------------------------------------------------------


def _ffn_init(gen: torch.Generator, num: int, d: int, h: int, act: str, *,
              device, dtype=torch.float32) -> dict:
    """Expert FFN weights in the JAX layout: wi (num, d, h), wo (num, h, d);
    ``num == 0`` drops the expert dim (a dense FFN)."""
    si, so = d ** -0.5, h ** -0.5
    shape_i, shape_o = ((num, d, h), (num, h, d)) if num else ((d, h), (h, d))

    def normal(shape, scale):
        t = torch.randn(shape, generator=gen, device=device) * scale
        return t.to(dtype)

    p = {}
    if act == "swiglu":
        p["wi_gate"] = normal(shape_i, si)
        p["wi_up"] = normal(shape_i, si)
    else:
        p["wi"] = normal(shape_i, si)
    p["wo"] = normal(shape_o, so)
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


def expert_ffn_fused(params: dict, xs: torch.Tensor, act: str) -> torch.Tensor:
    """expert_fn backed by the fused GEMM1+act+GEMM2 kernel: the (M, H)
    hidden activation never reaches device memory."""
    E, n, d = xs.shape
    flat = xs.reshape(E * n, d)
    ys = ops.fused_grouped_ffn(flat, _expert_ws(params, act), params["wo"],
                               _equal_sizes(E, n, xs.device), act)
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
                     act: str) -> torch.Tensor:
    return ops.fused_grouped_ffn(xs, _expert_ws(params, act), params["wo"],
                                 group_sizes, act)


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
              dtype=torch.float32) -> dict:
    """Parameters for one MoE FFN block (the router is always f32)."""
    params = {
        "router": router_init(gen, d_model, cfg, device=device),
        "experts": _ffn_init(gen, cfg.num_experts, d_model,
                             cfg.d_expert_hidden, act, device=device,
                             dtype=dtype),
    }
    if cfg.num_shared_experts:
        params["shared"] = _ffn_init(
            gen, 0, d_model, cfg.num_shared_experts * cfg.d_expert_hidden,
            act, device=device, dtype=dtype)
    if cfg.dense_residual:
        params["dense"] = _ffn_init(gen, 0, d_model,
                                    d_ff_dense or cfg.d_expert_hidden, act,
                                    device=device, dtype=dtype)
    return params


# ---------------------------------------------------------------------------
# Local (single-worker) forward — paper §4 reordering
# ---------------------------------------------------------------------------


def _moe_local(x: torch.Tensor, router: dict, experts: dict, cfg: MoEConfig,
               act: str, expert_fn: Callable, impl: str = "einsum"):
    T = x.shape[0]
    g = route_tokens(router, x, cfg)
    if cfg.dispatch == "ragged":
        plan = D.make_ragged_plan(g.expert_ids, cfg.num_experts)
        xs = D.dispatch_ragged(x, plan)  # (T*k, d) expert-sorted
        ys = RAGGED_FNS[impl](experts, xs, plan.group_sizes, act)
        y = D.combine_ragged(ys, plan, g.combine_weights)
        load, drop = load_metrics(plan.group_sizes, None, T * cfg.top_k)
    else:
        C = D.expert_capacity(T, cfg.num_experts, cfg.top_k, cfg.capacity_factor)
        plan = D.make_capacity_plan(g.expert_ids, cfg.num_experts, C)
        buf = D.dispatch_capacity(x, plan, cfg.num_experts)  # scatter (Fig 4)
        out = expert_fn(experts, buf, act)  # per-expert GeMM
        y = D.combine_capacity(out, plan, g.combine_weights)  # gather
        load, drop = load_metrics(plan.load, plan.keep, T * cfg.top_k)
    metrics = MoEMetrics(load_balance_loss(g.probs, g.expert_ids, cfg.num_experts),
                         router_z_loss(g.logits), load, drop)
    return y, metrics


def fmoe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *,
               act: str = "swiglu", dist=None, impl: str = "einsum"):
    """Apply the MoE FFN to ``x`` of shape (..., d_model).

    Returns ``(y, MoEMetrics)``.  ``impl`` selects the expert kernels
    ("einsum" | "pallas" | "fused") on both dispatch modes.  Only the
    single-worker §4 path is ported: a ``dist`` carrying a mesh raises.
    """
    if dist is not None and getattr(dist, "mesh", None) is not None:
        raise NotImplementedError(
            "expert parallelism (a dist with a mesh) is not ported to "
            "repro_torch yet; see ROADMAP.md")
    expert_fn = EXPERT_FNS[impl]
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    y, metrics = _moe_local(xf, params["router"], params["experts"], cfg, act,
                            expert_fn, impl=impl)
    for k in ("shared", "dense"):
        if k in params:
            y = y + dense_ffn(params[k], xf, act)
    return y.reshape(shape), metrics
