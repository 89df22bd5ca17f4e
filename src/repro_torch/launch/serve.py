"""Serving: a static batch (one prefill pass over the prompts, then one
decode step per token, greedy or sampled) and continuous batching over a
request stream (``launch/scheduler.ContinuousBatcher``, paged KV cache).

    python -m repro_torch.launch.serve --arch fastmoe-gpt [--reduced] \
        --batch 8 --prompt_len 128 --gen 32 --impl fused --dispatch ragged \
        [--temperature 0.8] [--device cpu] [--seed 0]
    python -m repro_torch.launch.serve --continuous --requests 24 --slots 8 \
        --block_size 16 --prompt_len 128 --gen 32 [--max_len 160] \
        [--policy static] [--device cpu]

Expert-parallel decode in the psum mode over a DxM mesh of ranks, one
process each (gloo on the CPU, NCCL with one card a rank), with expert
placement: a serve-time replan every N ticks, or (static batch) a
per-layer plan measured on the prompt:

    torchrun --nproc_per_node 2 -m repro_torch.launch.serve --continuous \
        --mesh 1x2 --device cpu --reduced --replan_every 2
    torchrun --nproc_per_node 4 -m repro_torch.launch.serve --continuous \
        --mesh 2x2 --device cpu --reduced
    torchrun --nproc_per_node 2 -m repro_torch.launch.serve --mesh 1x2 \
        --device cpu --reduced --per_layer_plans

Every rank runs the same loop on the same requests; rank 0 prints.  On a
DxM mesh each data group decodes its block of the slots (of the static
batch's rows).  The params are held in the reference's serving layout
(``launch/sharding.serve_layout``): by default its train-mode specs (FSDP
over ``data``, heads, ffn columns and vocab rows over ``model``), under
``opts={"serve_tp": True}`` (an argument of :func:`make_serve_step`, of
``ContinuousBatcher`` and of :func:`serve_continuous`, as in the
reference; the CLI has no flag for it) its serve-mode specs.  GQA
attention, the dense and shared FFNs, the embedding and the head run
tensor-parallel over ``model`` (``models.layers.TP``); every other split
is gathered at use.  Dense configs serve on a mesh as MoE ones do.
``--impl`` picks the expert kernels (einsum = plain PyTorch, pallas = the
grouped-GEMM kernel, fused = the fused FFN kernel); ``--dispatch`` the MoE
dispatch (capacity | ragged); ``--router`` the routing variant (serving
draws no noise, so gumbel routes as topk).  Runs on the GPU unless ``--device cpu``.

Telemetry: ``--metrics_out`` writes JSONL records (the static batch: one
``decode_step`` record a step with its latency, tokens/s, drop fraction
and wire/drop/shadow counters; continuous batching: ``serve_admit``,
``serve_retire`` and the replan hook's records), ``--trace`` a Chrome
trace of the host's ``decode_step`` spans.  With either, each decode step
is synchronized so its wall time is real.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dispatch import expert_capacity
from repro_torch.core.fmoe import DistConfig, moe_dist
from repro_torch.core.gate import ROUTERS
from repro_torch.device import resolve
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.launch.serve_api import Request, ServeConfig
from repro_torch.launch.sharding import serve_layout
from repro_torch.models import lm
from repro_torch.obs import JsonlSink
from repro_torch.obs import trace as obs_trace
from repro_torch.placement import (from_logical, load_calibration,
                                   plan_placement, plan_placement_per_layer)

SWA_CAP = 8192  # ring-buffer cap for the long-context sliding-window variant


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Ring length: full seq when it fits the attention pattern, else the
    sliding window; 1 for the ssm family's pure recurrent state (no
    ring)."""
    if cfg.family == "ssm":
        return 1
    a = cfg.attention
    if seq_len > 32768:
        w = a.sliding_window if a.sliding_window else SWA_CAP
        return min(seq_len, max(w, 1))
    if a is not None and a.sliding_window:
        return min(seq_len, max(a.sliding_window,
                                1 if not a.global_layers else seq_len))
    return seq_len


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def check_serving_mesh(node: int) -> None:
    """The port serves DxM meshes (a batcher per data group).  A node axis
    is refused: the two-level exchange is a training path, and the
    reference's serving has none."""
    if node > 1:
        raise NotImplementedError(
            f"serving over a node axis of {node}: the reference's serve has "
            f"no node path (the two-level exchange trains); use a DxM mesh")


def decode_dist(cfg: ModelConfig, mesh, batch: int):
    """The MoE layers' ``DistConfig`` for decode over ``mesh``, pinned to
    the psum mode: the model axis leaves the token axes, and the data axis
    stays a token axis only where the batch splits over it.  None when the
    config has no MoE or its experts do not split over the model axis."""
    d = moe_dist(cfg, mesh, batch)
    if d is None or d.mode == "psum":
        return d
    tok = tuple(a for a in d.token_axes if a not in d.expert_axes)
    if mesh.axes_size(tok) > 1 and batch % mesh.axes_size(tok):
        tok = ()
    return d._replace(token_axes=tok)


def serve_dist(cfg: ModelConfig, mesh, batch: int, layout):
    """The serving ``DistConfig`` of ``batch`` rows over ``mesh`` with the
    params in ``layout``: the MoE layers' psum mode (:func:`decode_dist`),
    or for a dense config one that only carries the layout and the data
    axis where the batch splits over it."""
    d = decode_dist(cfg, mesh, batch)
    if d is None:
        if cfg.moe is not None:
            raise ValueError(f"{cfg.moe.num_experts} experts do not split "
                             f"over the model axis of {mesh}")
        data = mesh.shape["data"]
        d = DistConfig(mesh, ("data",) if data > 1 and batch % data == 0
                       else ())
    return d.with_layout(layout)


def serve_setup(cfg: ModelConfig, mesh, batch: int, opts: dict | None = None):
    """(layout, dist) of serving ``batch`` rows on ``mesh`` under the
    reference's ``opts`` (``serve_tp``, ``head_aware``; ``launch/
    sharding.serve_layout``); (None, None) without a mesh."""
    if mesh is None:
        return None, None
    layout = serve_layout(cfg, mesh, batch, opts)
    return layout, serve_dist(cfg, mesh, batch, layout)


def make_serve_step(cfg: ModelConfig, mesh, batch: int, *,
                    opts: dict | None = None, impl: str = "fused",
                    device="cuda", layer_loads: bool = False):
    """The one-token serve step of ``batch`` rows on ``mesh``, the
    counterpart of the reference's ``jit_serve_step`` and (called with
    ``block_tables``) ``jit_paged_serve_step``.  Returns ``(step, layout,
    dist)``: the params (``lm.init_params(layout=layout)``) and the cache
    (``lm.init_cache`` / ``init_paged_cache(layout=layout)``) are held in
    ``layout``, and ``step(params, tokens, pos, cache, block_tables=None)``
    is ``lm.decode_step`` under ``dist``."""
    layout, dist = serve_setup(cfg, mesh, batch, opts)

    def step(params, tokens, pos, cache, block_tables=None):
        return lm.decode_step(params, cfg, tokens, pos, cache, impl=impl,
                              device=device, dist=dist,
                              block_tables=block_tables,
                              layer_loads=layer_loads)
    return step, layout, dist


def data_rows(rows: torch.Tensor, dist) -> torch.Tensor:
    """This rank's block of a batch's ``rows`` under ``dist``: its data
    group's B/D where "data" is among the token axes, else every row."""
    if dist is None or "data" not in dist.token_axes:
        return rows
    n = rows.shape[0] // dist.mesh.shape["data"]
    g = dist.mesh.axis_index("data")
    return rows[g * n:(g + 1) * n]


def plan_for_serving(params, cfg: ModelConfig, prompt, num_ranks: int, *,
                     per_layer: bool = True, dist=None, impl: str = "einsum",
                     device="cuda", constants=None):
    """Measure each layer's expert load on the prompt and plan a decode
    layout, as the reference's: one ``forward(layer_loads=True)`` over the
    (B, S) prompt (this rank's data block of it under ``dist``, the decode
    dist: the loads are then the means over the blocks), the per-layer
    planner (or the shared one on the summed load) for inference
    (``train=False``: no gradient sync to charge; ``shrink_capacity=
    False``: the psum mode has no wire, so a shrink would only drop) at
    the capacity of B rows, with ``constants`` (default: the card's,
    ``load_calibration``).  Returns ``(plan, params)``, the params
    migrated into the plan's physical order in place (across the expert
    axes on ``dist``'s mesh).  The cost model rarely shadows here (in the
    psum mode a shadow saves no wire bytes and replicates weight reads);
    the per-layer permutation balances the owned compute."""
    moe = cfg.moe
    prompt = torch.as_tensor(prompt, device=resolve(device))
    with torch.no_grad():
        _, _, loads = lm.forward(params, cfg, data_rows(prompt, dist),
                                 impl=impl, device=device, dist=dist,
                                 layer_loads=True)
    loads = loads.float().cpu().numpy()
    kw = dict(d_model=cfg.d_model, d_hidden=moe.d_expert_hidden,
              capacity=expert_capacity(prompt.shape[0], moe.num_experts,
                                       moe.top_k, moe.capacity_factor),
              capacity_factor=moe.capacity_factor, train=False,
              shrink_capacity=False,
              constants=load_calibration() if constants is None else constants)
    if per_layer:
        plan = plan_placement_per_layer(loads, num_ranks, **kw)
    else:
        plan = plan_placement(loads.sum(0), num_ranks, **kw)
    return plan, from_logical(params, plan,
                              mesh=None if dist is None else dist.mesh)


def decode_metrics(metrics, cfg: ModelConfig) -> dict:
    """A decode step's telemetry: the drop fraction averaged over the
    layers and the wire/drop/shadow counters summed over them
    (``lm.obs_aux``), as the reference packs its serve step's metrics."""
    L = max(cfg.num_layers, 1)
    return {"drop_frac": metrics.drop_frac / L,
            **lm.obs_aux(metrics, L, metrics.drop_frac.device)}


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """(B, V) logits -> (B, 1) tokens: the argmax at temperature 0, else
    one draw a row from softmax(logits / temperature) with ``generator``
    (on the logits' device)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)[:, None]
    if generator is None:
        raise ValueError("temperature sampling takes an explicit "
                         "torch.Generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)


def generate(params, cfg: ModelConfig, prompt, steps: int, *,
             cache_len: int = 256, impl: str = "fused",
             use_prefill: bool = True, device="cuda",
             timings: dict | None = None, temperature: float = 0.0,
             generator: torch.Generator | None = None,
             dist=None, sink=None) -> torch.Tensor:
    """Greedy or sampled decoding: (B, S) prompt -> (B, S + steps) tokens.

    ``use_prefill=True`` fills the cache with one full pass over the prompt
    (the serving path); otherwise the prompt goes in token by token (the
    cross-check: both paths must agree).  ``temperature`` > 0 samples each
    token from softmax(logits / temperature) with ``generator`` (a
    ``torch.Generator`` on the device); 0, the default, is greedy.
    ``dist``: the serving ``DistConfig`` (:func:`serve_setup`; its
    layout holds ``params`` and sizes the cache).  A
    ``timings`` dict, when given, receives ``prefill_s`` and the per-token
    ``decode_s`` list, each taken after a device synchronize.  ``sink``
    (``repro_torch.obs.sink``) takes a ``decode_step`` record a step
    (:func:`decode_metrics` with its latency); each step runs in a
    ``decode_step`` span (``repro_torch.obs.trace``)."""
    lm.check_tokens_only(cfg)
    dev = resolve(device)
    prompt = torch.as_tensor(prompt, device=dev)
    B, S = prompt.shape
    cache = lm.init_cache(cfg, B, cache_len, device=dev,
                          layout=None if dist is None else dist.layout)

    def step(tok, pos, cache):
        return lm.decode_step(params, cfg, tok, pos, cache, impl=impl,
                              device=dev, dist=dist)

    def next_token(logits):
        return sample(logits[:, -1], temperature, generator).to(prompt.dtype)

    t0 = time.perf_counter()
    if use_prefill:
        logits, cache, _ = lm.prefill(params, cfg, prompt, cache, impl=impl,
                                      device=dev, dist=dist)
    else:
        for pos in range(S):
            logits, cache, _ = step(prompt[:, pos:pos + 1], pos, cache)
    out = [prompt]
    tok = next_token(logits)
    out.append(tok)
    if timings is not None:
        _sync(dev)
        timings["prefill_s"] = time.perf_counter() - t0
        timings["decode_s"] = []
    telemetry = sink is not None or obs_trace.enabled()
    for pos in range(S, S + steps - 1):
        t0 = time.perf_counter()
        with obs_trace.span("decode_step", pos=pos):
            logits, cache, m = step(tok, pos, cache)
            tok = next_token(logits)
            if telemetry:  # real per-step latency, not dispatch time
                _sync(dev)
        out.append(tok)
        if timings is not None:
            _sync(dev)
            timings["decode_s"].append(time.perf_counter() - t0)
        if sink is not None:
            wall = time.perf_counter() - t0
            sink.emit({"kind": "decode_step", "pos": pos, "wall_s": wall,
                       "tokens_per_s": B / max(wall, 1e-9),
                       **decode_metrics(m, cfg)})
    return torch.cat(out, dim=1)


def request_stream(cfg: ModelConfig, *, prompt_len: int, gen: int,
                   num_requests: int, seed: int = 1) -> list:
    """The synthetic stream of ``serve --continuous``, drawn as the JAX
    package draws it: prompt lengths in (prompt_len // 2, prompt_len],
    tokens uniform over the vocabulary, ``gen`` new tokens each."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(num_requests):
        s = max(1, prompt_len - int(rng.randint(0, max(prompt_len // 2, 1))))
        reqs.append(Request(
            id=i, prompt=rng.randint(0, cfg.vocab_size, s).astype(np.int64),
            max_new_tokens=gen))
    return reqs


def _pct(sorted_vals: list, q: float) -> float:
    return sorted_vals[min(len(sorted_vals) - 1, int(len(sorted_vals) * q))]


def serving_stats(completions: list, seconds: float, ticks: int) -> dict:
    """Requests, generated tokens and tok/s, ticks, time to first token and
    per-token latency (the gaps after the first token), p50 and p99."""
    toks = sum(len(c.tokens) for c in completions)
    ttft = sorted(c.ttft for c in completions) or [0.0]
    lats = sorted(x for c in completions for x in c.latencies[1:]) or [0.0]
    return {"requests": len(completions), "tokens": toks, "seconds": seconds,
            "tok_s": toks / max(seconds, 1e-9), "ticks": ticks,
            "ttft_p50": _pct(ttft, 0.5), "ttft_p99": _pct(ttft, 0.99),
            "token_p50": _pct(lats, 0.5), "token_p99": _pct(lats, 0.99)}


def format_stats(s: dict) -> str:
    return (f"{s['requests']} requests, {s['tokens']} tokens in "
            f"{s['seconds']:.3f} s ({s['tok_s']:.1f} tok/s) over {s['ticks']} "
            f"ticks; TTFT p50 {s['ttft_p50'] * 1e3:.1f} ms p99 "
            f"{s['ttft_p99'] * 1e3:.1f} ms; per-token p50 "
            f"{s['token_p50'] * 1e3:.2f} ms p99 {s['token_p99'] * 1e3:.2f} ms")


def serve_continuous(params, cfg: ModelConfig, scfg: ServeConfig, *,
                     prompt_len: int, gen: int, num_requests: int,
                     impl: str = "fused", device="cuda", mesh=None,
                     sink=None, opts: dict | None = None):
    """Drive the continuous batcher over ``request_stream``: every request
    submitted at the start, then ticks until all are done.  ``params``:
    on a mesh, the rank's shard under the batcher's layout (``opts``).
    Returns ``(batcher, serving_stats(...))``."""
    from repro_torch.launch.scheduler import ContinuousBatcher

    batcher = ContinuousBatcher(params, cfg, scfg, mesh=mesh, impl=impl,
                                device=device, sink=sink, opts=opts)
    reqs = request_stream(cfg, prompt_len=prompt_len, gen=gen,
                          num_requests=num_requests)
    t0 = time.time()
    for r in reqs:
        batcher.submit(r)
    batcher.run()
    dt = time.time() - t0
    return batcher, serving_stats(batcher.completions, dt, batcher.ticks)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="fastmoe-gpt")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8,
                    help="the static batch, and the slots when --slots is "
                         "not given")
    ap.add_argument("--prompt_len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--impl", default="fused", choices=["einsum", "pallas", "fused"])
    ap.add_argument("--dispatch", default="ragged", choices=["capacity", "ragged"])
    ap.add_argument("--router", default="", choices=["", *ROUTERS],
                    help="override the MoE routing variant (no noise is "
                         "drawn at decode: gumbel routes as topk)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample the static batch's tokens at this "
                         "temperature (0 = greedy)")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a synthetic request stream by continuous "
                         "batching (launch/scheduler) instead of one static "
                         "batch")
    ap.add_argument("--requests", type=int, default=0,
                    help="requests for --continuous (0 = 3x slots)")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots (ServeConfig.slots; default --batch)")
    ap.add_argument("--block_size", type=int, default=None,
                    help="paged KV cache block rows (ServeConfig.block_size)")
    ap.add_argument("--max_len", type=int, default=None,
                    help="per-request prompt + gen cap (default prompt_len "
                         "+ gen)")
    ap.add_argument("--policy", default=None, choices=["continuous", "static"],
                    help="admission policy (static = admit only when every "
                         "slot is free)")
    ap.add_argument("--mesh", default="",
                    help="DxM: serve on a mesh of ranks, one a process (run "
                         "under torchrun): params in the reference's "
                         "serving layout, experts in the psum mode, a "
                         "batcher per data group")
    ap.add_argument("--replan_every", type=int, default=None,
                    help="--continuous: decode ticks between serve-time "
                         "placement replans (0 = off; an MoE config)")
    ap.add_argument("--per_layer_plans", action="store_true",
                    help="plan each layer apart: the serve-time replans "
                         "of --continuous, and with --mesh (M > 1) the "
                         "static batch, served under a per-layer plan "
                         "measured on its prompt")
    ap.add_argument("--metrics_out", default="",
                    help="write telemetry records (JSONL): per decode step "
                         "latency, tokens/s, drop fraction and the "
                         "wire/drop/shadow counters; under --continuous "
                         "the admissions, retirements and replans")
    ap.add_argument("--trace", default="",
                    help="write a Chrome trace of the host-side "
                         "decode_step spans (chrome://tracing / perfetto)")
    args = ap.parse_args(argv)

    scfg = ServeConfig.from_args(args)
    if args.max_len is None:
        scfg.max_len = args.prompt_len + args.gen
    if args.continuous and args.temperature:
        raise ValueError("the continuous batcher decodes greedily; "
                         "--temperature applies to the static batch")
    if not scfg.mesh:
        return _run(args, scfg, resolve(args.device), None)
    data, model = scfg.mesh_shape()
    dev = init_distributed(args.device)
    try:
        _run(args, scfg, dev, make_local_mesh(data, model))
        # no rank tears its groups down while a peer's last collective on
        # them is still in flight
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


def _run(args, scfg: ServeConfig, dev: torch.device, mesh) -> None:
    lead = mesh is None or mesh.rank == 0
    sink = JsonlSink(scfg.metrics_out) if scfg.metrics_out and lead else None
    if scfg.trace:
        obs_trace.configure(enabled=True)
    try:
        _serve(args, scfg, dev, mesh, sink)
    finally:
        if sink is not None:
            sink.close()
    if lead and sink is not None:
        print(f"metrics written to {scfg.metrics_out}")
    if lead and scfg.trace:
        obs_trace.export(scfg.trace)
        print(f"trace written to {scfg.trace}")


def _serve(args, scfg: ServeConfig, dev: torch.device, mesh, sink) -> None:
    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch)
    lm.check_tokens_only(cfg)
    if args.reduced:
        cfg = reduced(cfg, num_layers=4, d_model=256)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=args.dispatch,
            router=args.router or cfg.moe.router))
    # each rank makes its own shard of the serving layout from the seed
    layout, dist = serve_setup(cfg, mesh, scfg.slots if args.continuous
                               else args.batch)
    params = lm.init_params(cfg, seed=args.seed, device=dev, layout=layout)
    where = f"{dev}" + (f", mesh {scfg.mesh} ({'psum' if cfg.moe else 'dense'})"
                        if mesh else "")
    if args.continuous:
        batcher, stats = serve_continuous(
            params, cfg, scfg, prompt_len=args.prompt_len, gen=args.gen,
            num_requests=args.requests or 3 * scfg.slots, impl=args.impl,
            device=dev, mesh=mesh, sink=sink)
        if lead:
            print(f"{cfg.name} on {where}, continuous ({scfg.policy}, "
                  f"{'paged' if batcher.paged else 'ring'}, {scfg.slots} slots): "
                  + format_stats(stats) + f"; replans={batcher.replans}")
            print(min(batcher.completions, key=lambda c: c.request_id).tokens)
        return
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    if (args.per_layer_plans and cfg.moe is not None and dist is not None
            and mesh.shape["model"] > 1):
        plan, params = plan_for_serving(params, cfg, prompt,
                                        dist.expert_parallelism, dist=dist,
                                        impl=args.impl, device=dev)
        dist = dist._replace(placement=plan)
        if lead:
            print(f"serving plan: shadow={plan.num_shadow} "
                  f"cap_scale={plan.capacity_scale:.2f}")
    timings: dict = {}
    seq = generate(params, cfg, data_rows(prompt, dist), args.gen,
                   impl=args.impl, device=dev,
                   cache_len=cache_len_for(cfg, args.prompt_len + args.gen),
                   timings=timings, temperature=args.temperature,
                   generator=gen, dist=dist, sink=sink)
    dec = sorted(timings["decode_s"]) or [0.0]
    p50 = dec[len(dec) // 2]
    if lead:
        print(f"{cfg.name} on {where}: prefill {args.batch}x{args.prompt_len} "
              f"in {timings['prefill_s'] * 1e3:.1f} ms; decode p50 "
              f"{p50 * 1e3:.2f} ms/step ({args.batch / max(p50, 1e-9):.1f} "
              f"tok/s) over {len(timings['decode_s'])} steps")
        print(seq[0].tolist())


if __name__ == "__main__":
    main()
