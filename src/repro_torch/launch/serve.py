"""Greedy serving: one prefill pass over the prompts, then one decode step
per token, for a static batch.

    python -m repro_torch.launch.serve --arch fastmoe-gpt [--reduced] \
        --batch 8 --prompt_len 128 --gen 32 --impl fused --dispatch ragged \
        [--device cpu] [--seed 0]

``--impl`` picks the expert kernels (einsum = plain PyTorch, pallas = the
grouped-GEMM kernel, fused = the fused FFN kernel); ``--dispatch`` the MoE
dispatch (capacity | ragged).  Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import lm

SWA_CAP = 8192  # ring-buffer cap for the long-context sliding-window variant


def cache_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Ring length: full seq when it fits the attention pattern, else the
    sliding window."""
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


def generate(params, cfg: ModelConfig, prompt, steps: int, *,
             cache_len: int = 256, impl: str = "fused",
             use_prefill: bool = True, device="cuda",
             timings: dict | None = None) -> torch.Tensor:
    """Greedy decoding: (B, S) prompt -> (B, S + steps) tokens.

    ``use_prefill=True`` fills the cache with one full pass over the prompt
    (the serving path); otherwise the prompt goes in token by token (the
    cross-check: both paths must agree).  A ``timings`` dict, when given,
    receives ``prefill_s`` and the per-token ``decode_s`` list, each taken
    after a device synchronize."""
    dev = resolve(device)
    prompt = torch.as_tensor(prompt, device=dev)
    B, S = prompt.shape
    cache = lm.init_cache(cfg, B, cache_len, device=dev)

    def step(tok, pos, cache):
        return lm.decode_step(params, cfg, tok, pos, cache, impl=impl,
                              device=dev)

    def greedy(logits):
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(prompt.dtype)

    t0 = time.perf_counter()
    if use_prefill:
        logits, cache, _ = lm.prefill(params, cfg, prompt, cache, impl=impl,
                                      device=dev)
        out = [prompt]
    else:
        for pos in range(S):
            logits, cache, _ = step(prompt[:, pos:pos + 1], pos, cache)
        out = [prompt]
    tok = greedy(logits)
    out.append(tok)
    if timings is not None:
        _sync(dev)
        timings["prefill_s"] = time.perf_counter() - t0
        timings["decode_s"] = []
    for pos in range(S, S + steps - 1):
        t0 = time.perf_counter()
        logits, cache, _ = step(tok, pos, cache)
        tok = greedy(logits)
        out.append(tok)
        if timings is not None:
            _sync(dev)
            timings["decode_s"].append(time.perf_counter() - t0)
    return torch.cat(out, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="fastmoe-gpt")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt_len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--impl", default="fused", choices=["einsum", "pallas", "fused"])
    ap.add_argument("--dispatch", default="ragged", choices=["capacity", "ragged"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, num_layers=4, d_model=256)
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch=args.dispatch))
    params = lm.init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    timings: dict = {}
    seq = generate(params, cfg, prompt, args.gen, impl=args.impl, device=dev,
                   cache_len=cache_len_for(cfg, args.prompt_len + args.gen),
                   timings=timings)
    dec = sorted(timings["decode_s"]) or [0.0]
    p50 = dec[len(dec) // 2]
    print(f"{cfg.name} on {dev}: prefill {args.batch}x{args.prompt_len} in "
          f"{timings['prefill_s'] * 1e3:.1f} ms; decode p50 {p50 * 1e3:.2f} "
          f"ms/step ({args.batch / max(p50, 1e-9):.1f} tok/s) over "
          f"{len(timings['decode_s'])} steps")
    print(seq[0].tolist())


if __name__ == "__main__":
    main()
