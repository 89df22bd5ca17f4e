#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. builds the CUDA kernels from src/repro_torch/csrc into build/ and
   prints each kernel's registers and spills from -Xptxas -v, failing if
   a kernel redesigned for registers (the grouped GEMM's and the fused
   FFN's ring kernels, the fused FFN backward's dX and dW ring kernels,
   the bf16 flash forward and backward) spills, and the dynamic shared
   memory the fused FFN's and its backward's ring kernels and the bf16
   flash forward ask for at each of their tile choices (the backward's and
   the flash forward's held equal to the host's mirrors);
2. holds each kernel against its plain PyTorch version at the serving
   path's shapes (d 1024, H 2048, 96 experts; gelu, plus swiglu) in bf16
   and f32, with ragged group sizes, empty groups and sum(group_sizes) < M,
   and times kernel, plain version and the library call where one exists
   (events, and the device time alone from torch.profiler), and, as a
   labelled reference line, the unfused FFN by PyTorch calls
   (torch._grouped_mm, GELU, torch._grouped_mm);
3. holds the reduced f32 model served through the kernels on the card
   against the same model on the CPU (the plain path the CPU tests hold
   against the JAX package);
4. serves full-width fastmoe-gpt (12 layers x 96 experts, bf16, weights from
   a seed) greedily: 8 prompts x 128 tokens of prefill, then 32 decode
   steps, for impl in {fused, pallas} x dispatch in {ragged, capacity}, with
   the launch counters set to 0 just before and read just after, failing
   if the simple grouped GEMM, the simple fused FFN or the first-version
   backward kernels (f32 and unaligned shapes) ran at a model shape (also
   on the training paths);
5. holds each combination's prefill and first-decode logits against the
   plain einsum experts and plain attention on the same dispatch;
6. holds the fused FFN's backward kernels (dX, grouped dW) against their
   plain versions at the training shapes (2048 tokens top-2: 4096 ragged
   rows, or 96 x 56 capacity rows), with an empty group, rows past
   sum(group_sizes), a hidden tail, swiglu and a skewed routing (one
   expert over the dW kernel's 64-row batch) — bf16 on the ring kernels,
   f32 on the first versions, as the launch counters must show, and the
   first versions in bf16 too, called directly — and times them beside
   their bounds by events and device time, with the first versions on the
   same inputs (also at the skewed routing), an unfused reference by
   PyTorch calls
   (torch._grouped_mm), the fused FFN forward (events and device time,
   and its unfused reference) and the grouped GEMM (forward, and dX
   reading w transposed) on the same rows;
7. trains the reduced f32 model 3 steps through the kernels on the card
   against the CPU plain path (per-step loss and per-leaf gradients);
8. trains full-width fastmoe-gpt cut to 10 layers (f32 masters, bf16
   compute, AdamW) from seed 0 on SyntheticLM batches of 8 x 256 tokens,
   for fused/capacity, fused/ragged and pallas/ragged, with the launch
   counters set to 0 just before and read just after, printing step time,
   tokens/s, the forward/backward/optimizer split and peak memory; then
   times the backward kernels (ring and first version) at the group sizes
   of each layer of fused/ragged's profiled step (the model's own routing),
   holding them against their plain versions at its most skewed layer;
9. holds one step's gradients of each kernel path (full width, 2 layers)
   no further from an f32 einsum oracle than the bf16 einsum path is (both
   on plain attention);
10. holds the flash-attention kernels (forward; backward dq, dk, dv — the
   bf16 backward twice, bit-equal over the runs where its dQ has a slot
   per kv tile, at the fastmoe-gpt shapes, and each run to the tolerance
   where it adds by atomics, at the starcoder2 kv group)
   against their plain versions in bf16 and f32 at the fastmoe-gpt prefill
   (8 x 128) and training (8 x 256) shapes, one starcoder2-15b kv group
   (2 x 8192, 12 heads over 1, window 4096), window 1 and sequences that
   are no tile multiple, and times them beside their bounds, the plain
   version and SDPA (run before the model phases, while the plain
   version's f32 scores fit the card), and takes the forward's device time
   at the fastmoe-gpt training shape apart (SMALL_SHAPE_PARTS);
11. holds 2-layer full-width starcoder2-15b logits (1 x 8192) of the
   kernel path no further from an f32 plain-attention path than the bf16
   plain path is, and profiles one 2-layer prefill of 2 x 8192 (busy
   share, the flash forward's share, top kernels);
12. serves full-width 40-layer starcoder2-15b (15.96 B params, bf16 layers)
   greedily: 2 prompts x 8192 tokens into a 4096-slot ring, then 32
   decode steps, with the launch counters set to 0 just before and read
   just after, printing prefill ms, decode ms/step and peak memory.

Prints the kernel times beside their bounds, the serving and training
rates, the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, the ``{"ok": true, "device": ...}`` line.  Any failure exits non-zero
before the last line.  It needs a CUDA card and the repository's src/
beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and FLOP/s by the
# unit the kernels use — bf16 on the tensor cores, f32 on the FMA units.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

E, D, H = 96, 1024, 2048  # fastmoe-gpt experts, d_model, expert hidden
BATCH, PROMPT, GEN = 8, 128, 32
# training: 8 sequences x 256 tokens = 2048 tokens per step; full width at
# 10 of the 12 layers (f32 params + grads + two AdamW moments are 16 B per
# param: 12 layers are 79.8 GB, 10 layers 66.8 GB of the card's 80 GB; the
# per-layer recompute keeps the rest to a few GB)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LAYERS = 8, 256, 10
TRAIN_WARM, TRAIN_STEPS = 1, 4
TRAIN_COMBOS = [("fused", "capacity"), ("fused", "ragged"), ("pallas", "ragged")]
# kernel vs plain version on the same inputs: bf16 outputs are rounded once
# from f32 sums of identical products, so they differ by at most a bf16 ulp
# where a sum straddles a rounding boundary (plus one hidden-tile ulp in the
# fused kernel); f32 sums differ by reassociation over K <= 2048 terms.
KERNEL_TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2),
              "float32": dict(rtol=1e-4, atol=1e-4)}
# Full-width logits in bf16 against the einsum oracle in f32.  bf16 rounds
# at different points on each path (the fused kernel once per hidden tile,
# the two-pass paths after each product and the activation), ~2^-8 relative
# per rounding, compounding over 12 layers; and where a token's 2nd and 3rd
# expert scores nearly tie, the rounding switches its expert and moves its
# logits by O(1).  So the plain bf16 einsum path's own distance to the f32
# oracle is the floor, and each kernel path must stay within it: median
# per-position relative error <= 1.25 x floor + 0.01, argmax agreement >=
# floor - 0.05.  A wrong kernel lands far outside (the f32 reduced-model
# check above holds the kernels to 1e-4 where rounding does not hide them).
SERVE_REL_SLACK, SERVE_ABS_SLACK, SERVE_AGREE_SLACK = 1.25, 0.01, 0.05
# The dW kernel's f32 outputs sum products of bf16-rounded intermediates
# (h, dg): where the kernel's and the plain version's f32 recomputes differ
# in the last bit, an intermediate rounds to the neighbouring bf16 value —
# one bf16 ulp (2^-6 at |dg| ~ 3) times the other operand (|x|, |dy| up to
# ~5 at the training shapes), up to ~0.2 on one output.  So bf16 dW is held
# elementwise to atol 0.25 and, as a whole, to a relative Frobenius error
# of 1e-3 (such flips are rare; a wrong product shows there).  f32 dW keeps
# the f32 tolerance.
DW_TOL = {"bfloat16": dict(rtol=2e-2, atol=0.25),
          "float32": KERNEL_TOL["float32"]}
DW_FRO = 1e-3
# Flash attention against its plain version.  At the starcoder2 shape a
# row averages ~4096 keys, so a typical |o| is ~0.02, at or below the bf16
# atol: the elementwise tolerance alone would pass a wrong bf16 kernel.  So
# each output and gradient is also held, as a whole, to a relative
# Frobenius error (bf16: the backward rounds P and dS to bf16 once, ~2^-9
# relative per element, and both sides round the result once; f32: sums
# reassociated), and the bf16 forward, which splits P into bf16 high and
# low parts, must equal the plain version bit for bit on >= 99% of outputs
# (it rounds one f32 sum, reassociated, where the plain version rounds its
# own).
FLASH_FRO = {"bfloat16": 1e-2, "float32": 1e-4}
FLASH_EQUAL = 0.99
SMALL_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 card vs CPU, reduced model
# Training it: step-0 gradients elementwise to SMALL_TOL (atol scaled by the
# leaf's largest entry); every step's gradients per leaf to a relative L2
# distance of 1e-3.  Adam's first update is sign-like, so an entry whose
# gradient is ~0 moves by +-lr on either side, and later gradients differ
# by more than f32 reassociation in a few entries.
SMALL_GRAD_L2 = 1e-3
# Gradients at full width in bf16 against the f32 einsum oracle: the same
# rule as the logits.  Per leaf, the relative L2 distance to the oracle;
# each kernel path's median over leaves must stay within 1.25 x the bf16
# einsum path's median + 0.01, and its worst leaf within 1.25 x the einsum
# path's worst leaf + 0.05 (the router's gradient moves most where a
# rounding switches a token's expert).
GRAD_REL_SLACK, GRAD_MED_SLACK, GRAD_MAX_SLACK = 1.25, 0.01, 0.05
# starcoder2-15b, 2 layers: the bf16 kernel path's logits against the f32
# plain path.  Its floor (the bf16 plain path's distance, ~0.007) is far
# below fastmoe-gpt's (~0.2: no experts to switch), so the slack is
# relative only: median <= 1.25 x floor, argmax agreement >= floor - 0.01.
SC2_REL_SLACK, SC2_AGREE_SLACK = 1.25, 0.01


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def close(name: str, got, ref, tol: dict) -> float:
    import torch
    err = (got.float() - ref.float()).abs().max().item() if got.numel() else 0.0
    ok = torch.allclose(got.float(), ref.float(), **tol)
    check(ok, f"{name}: kernel disagrees with its plain version "
              f"(max |err| {err:.3e}, tolerance {tol})")
    return err


def frobenius(name: str, got, ref, limit: float) -> float:
    """Relative Frobenius error ||got - ref|| / ||ref||, held to limit.  An
    all-zero reference (dq and dk at window 1, where each row's only key
    has P = 1 and dS = dP - rowsum(dO o) = 0) has no relative error: the
    caller's elementwise tolerance holds it alone, and this returns 0."""
    den = ref.float().norm().item()
    if den == 0.0:
        return 0.0
    err = (got.float() - ref.float()).norm().item() / den
    check(err <= limit, f"{name}: relative Frobenius error {err:.3e} > {limit}")
    return err


def time_ms(fn, flush, reps: int = 15) -> float:
    """Median device time of fn over reps, L2 flushed before each rep."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Summed device time of the kernels and memsets one call of fn runs,
    mean over reps, from torch.profiler, L2 warm.  Where the host takes
    longer to issue a call than the device to run it (small shapes, and
    autograd around a library call), the event time above holds host time
    too; this is the device's part alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def bound(nbytes: float, flops: float, dtype_name: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def routed(tokens: int, k: int, lo: int, dev):
    """Random top-k ids over experts lo..E-1 (experts < lo stay empty)."""
    import torch
    g = torch.Generator().manual_seed(tokens)
    scores = torch.rand(tokens, E - lo, generator=g)
    ids = scores.topk(k, dim=-1).indices + lo
    return ids.to(dev)


def kernel_phase(dev, flush):
    """Every kernel against its plain version in bf16 and f32 at the decode
    and prefill shapes; bf16 (the serving dtype) timed beside its bound."""
    import torch
    from repro_torch.core import dispatch as Dsp
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import token_shuffle as ts

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    # decode: 8 tokens' top-2 is 16 rows, here one token short (sum < M);
    # prefill: 1024 tokens are 2048 rows, 4 tokens short, experts 0..9 empty
    shapes = {"decode": (16, routed(7, 2, 0, dev)),
              "prefill": (2048, routed(1020, 2, 10, dev))}
    errs, timed = {}, {}

    def measure(name, shape, kern, plain, nbytes, flops, peak, lib=None):
        ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, peak)
        timed[(name, shape)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms)
        dev_ms = device_ms(kern)
        lib_dev = f"{device_ms(lib):.4f} ms" if lib is not None else "n/a"
        print(f"kernel {name:12s} {shape:7s} bf16: {ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})  plain {plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; device "
              f"(profiler, L2 warm) {dev_ms:.4f} ms, library {lib_dev}",
              flush=True)

    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        tol = KERNEL_TOL[dn]
        wi = randn(E, D, H, scale=D ** -0.5, dtype=dtype)
        wu = randn(E, D, H, scale=D ** -0.5, dtype=dtype)
        wo = randn(E, H, D, scale=H ** -0.5, dtype=dtype)
        for shape, (M, ids) in shapes.items():
            gs = torch.bincount(ids.flatten(), minlength=E).to(torch.int32)
            n, used = int(gs.sum()), int((gs > 0).sum())
            check(n < M and used < E, "test groups malformed")
            x = randn(M, D, dtype=dtype)
            x[n:] = 0  # the ops contract: rows past the groups arrive zero
            h = randn(M, H, dtype=dtype)
            h[n:] = 0
            cases = {
                "grouped_gemm": (lambda: gg.grouped_gemm(x, wi, gs),
                                 lambda: gg.grouped_gemm_plain(x, wi, gs)),
                "grouped_gemm_wo": (lambda: gg.grouped_gemm(h, wo, gs),
                                    lambda: gg.grouped_gemm_plain(h, wo, gs)),
                "fused_ffn": (lambda: ff.fused_ffn(x, (wi,), wo, gs, "gelu"),
                              lambda: ff.fused_ffn_plain(x, (wi,), wo, gs, "gelu")),
                "fused_ffn_swiglu": (
                    lambda: ff.fused_ffn(x, (wi, wu), wo, gs, "swiglu"),
                    lambda: ff.fused_ffn_plain(x, (wi, wu), wo, gs, "swiglu")),
            }
            for name, (kern, plain) in cases.items():
                got = kern()
                torch.cuda.synchronize()
                errs[(name, dn, shape)] = close(f"{name} {dn} {shape}", got,
                                                plain(), tol)
                check(not got[n:].any(), f"{name} {dn} {shape}: rows past "
                                         f"sum(group_sizes) are not zero")

            # the token shuffle on this routing: tokens -> expert order -> back
            T = ids.shape[0]
            plan = Dsp.make_ragged_plan(ids, E)
            rows = plan.token_rows
            xt = randn(T, D, dtype=dtype)
            got = ts.gather_rows(xt, rows)
            torch.cuda.synchronize()
            check(torch.equal(got, ts.gather_rows_plain(xt, rows)),
                  f"gather_rows {dn} {shape}: not bitwise equal")
            errs[("gather_rows", dn, shape)] = 0.0
            inv = torch.empty_like(plan.sort_idx)
            inv[plan.sort_idx] = torch.arange(inv.numel(), device=dev)
            idx = inv.reshape(T, 2).to(torch.int32)
            w = torch.softmax(randn(T, 2), -1)
            src = randn(2 * T, D, dtype=dtype)
            got = ts.combine_topk(src, idx, w)
            torch.cuda.synchronize()
            errs[("combine_topk", dn, shape)] = close(
                f"combine_topk {dn} {shape}", got,
                ts.combine_topk_plain(src, idx, w), tol)

            if dtype != torch.bfloat16:
                continue
            e, offs = 2, torch.cumsum(gs, 0).to(torch.int32)
            measure("grouped_gemm", shape, *cases["grouped_gemm"],
                    e * (M * D + used * D * H + M * H) + 4 * E,
                    2 * n * D * H, "bfloat16",
                    lib=grouped_mm_call(x, wi, offs))
            measure("fused_ffn", shape, *cases["fused_ffn"],
                    e * (2 * M * D + used * 2 * D * H) + 4 * E,
                    4 * n * D * H, "bfloat16")
            unfused_ffn(f"fused_ffn {shape}", x, wi, wo, offs, flush)
            measure("gather_rows", shape, lambda: ts.gather_rows(xt, rows),
                    lambda: ts.gather_rows_plain(xt, rows),
                    e * D * (int(rows.unique().numel()) + rows.numel())
                    + 4 * rows.numel(), 0, "bfloat16",
                    lib=lambda: torch.index_select(xt, 0, rows))
            measure("combine_topk", shape, lambda: ts.combine_topk(src, idx, w),
                    lambda: ts.combine_topk_plain(src, idx, w),
                    e * D * (int(idx.unique().numel()) + T) + 8 * idx.numel(),
                    2 * idx.numel() * D, "float32")
        del wi, wu, wo
    print(f"kernel checks passed: {len(errs)} cases (bf16 tol "
          f"{KERNEL_TOL['bfloat16']}, f32 tol {KERNEL_TOL['float32']}, gather "
          f"bitwise)", flush=True)
    return errs, timed


def grouped_mm_call(x, w, offs):
    """PyTorch's own grouped product, timed beside the kernel as a yardstick
    (the port never calls it); None where this PyTorch build lacks it."""
    import torch
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print("library: torch._grouped_mm is not in this PyTorch")
        return None
    try:
        fn(x, w, offs=offs)
    except RuntimeError as exc:
        print(f"library: torch._grouped_mm refused these inputs: {exc}"[:300])
        return None
    return lambda: fn(x, w, offs=offs)


def unfused_ffn(label, x, wi, wo, offs, flush):
    """A reference line, not the library column: the fastmoe-gpt FFN as
    three PyTorch calls (torch._grouped_mm, tanh GELU, torch._grouped_mm),
    which write the (M, H) hidden to device memory; it shows whether fusion
    pays.  Events and device time, or a note where this PyTorch lacks the
    grouped product."""
    import torch
    import torch.nn.functional as F
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print(f"reference {label}: torch._grouped_mm is not in this PyTorch")
        return

    def run():
        h = F.gelu(fn(x, wi, offs=offs), approximate="tanh")
        return fn(h, wo, offs=offs)
    try:
        run()
    except RuntimeError as exc:
        print(f"reference {label}: unfused FFN not timed: {exc}"[:300], flush=True)
        return
    print(f"reference {label}: unfused FFN (torch._grouped_mm + GELU + "
          f"torch._grouped_mm) {time_ms(run, flush):.4f} ms, device (profiler, "
          f"L2 warm) {device_ms(run):.4f} ms", flush=True)


def unfused_ffn_bwd(label, x, wi, wo, dy, offs, flush):
    """A reference line, not the library column: the fastmoe-gpt FFN's
    backward by PyTorch calls, each half recomputing what it needs as the
    fused kernels do, the (M, H) hidden in device memory.  dX: g = x wi and
    dh = dy wo^T (torch._grouped_mm), dg = gelu'(g) dh, dX = dg wi^T.  dW:
    g, dh, dg and h = gelu(g) likewise, then dwi = x^T dg and dwo = h^T dy
    by torch._grouped_mm with the offsets on the contracted rows, where this
    PyTorch takes them (else the line says so).  Events and device time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_ffn_bwd as fb
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print(f"reference {label}: torch._grouped_mm is not in this PyTorch")
        return
    wo_t, wi_t = wo.transpose(1, 2), wi.transpose(1, 2)

    def grads():
        g = fn(x, wi, offs=offs)
        dh = fn(dy, wo_t, offs=offs)
        dg, _ = fb.act_vjp(g.float(), None, dh.float(), "gelu")
        return g, dg.to(x.dtype)

    def dx_run():
        return fn(grads()[1], wi_t, offs=offs)

    def dw_run():
        g, dg = grads()
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype)
        return fn(x.t(), dg, offs=offs), fn(h.t(), dy, offs=offs)
    parts = []
    for what, run in (("dX", dx_run), ("dW", dw_run)):
        try:
            run()
        except RuntimeError as exc:
            parts.append(f"{what} not timed: {exc}"[:200])
            continue
        parts.append(f"{what} {time_ms(run, flush):.4f} ms, device (profiler, "
                     f"L2 warm) {device_ms(run):.4f} ms")
    print(f"reference {label}: unfused backward (torch._grouped_mm, GELU', "
          f"torch._grouped_mm): " + "; ".join(parts), flush=True)


# ---------------------------------------------------------------------------
# flash attention against its plain version
# ---------------------------------------------------------------------------

FULL_WINDOW = 1 << 30
# (B, S, H, KV, d, window): fastmoe-gpt prefill and training (16 heads of
# 64, causal, no window); one starcoder2-15b layer (48 heads of 128 over 4
# kv heads, window 4096) on one kv group, where the plain version's f32
# scores fit the card (all 48 heads would need 4 x 6.4 GB per copy); and
# the edges: window 1 and sequences that are no tile multiple.
FLASH_SHAPES = {
    "prefill": (BATCH, PROMPT, 16, 16, 64, FULL_WINDOW),
    "train": (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, FULL_WINDOW),
    "starcoder2": (2, 8192, 12, 1, 128, 4096),
    "window1": (2, 1000, 12, 4, 128, 1),
    "tail": (3, 333, 16, 16, 64, 100),
}
STARCODER2_FULL = (2, 8192, 48, 4, 128, 4096)  # the kernel alone, all heads


def visible_pairs(S: int, window: int) -> int:
    """Causal (i, j) pairs with 0 <= i - j < window over S positions: what
    this input needs (tiles outside the band are never computed)."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_bound(B, S, H, KV, d, window, *, backward: bool):
    """(bytes, operations) of the forward (q, k, v, o once; 4 d per visible
    pair and head) or the backward (q, k, v, o, dO, dq, dk, dv and the f32
    lse once; 10 d per pair and head) in bf16."""
    e = 2
    qo, kv = B * S * H * d * e, B * S * KV * d * e
    pairs = B * H * visible_pairs(S, window)
    if backward:
        return 4 * qo + 4 * kv + 4 * B * H * S, 10 * d * pairs
    return 2 * qo + 2 * kv, 4 * d * pairs


def sdpa_calls(q, k, v, do, window):
    """PyTorch's scaled_dot_product_attention on the same inputs, forward
    and backward, timed beside the kernels as a yardstick (the port never
    calls it): is_causal at full window, else a boolean band mask.  Prints
    the backend that takes it; (None, None) where SDPA refuses."""
    import torch
    import torch.nn.functional as F
    S = q.shape[1]
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)
    kw = dict(enable_gqa=True)
    if window >= S:
        kw["is_causal"] = True
    else:
        i = torch.arange(S, device=q.device)
        dist = i[:, None] - i[None, :]
        kw["attn_mask"] = (dist >= 0) & (dist < window)
    choice = getattr(torch, "_fused_sdp_choice", None)
    try:  # the backend's name is informative only
        from torch.nn.attention import SDPBackend
        backend = SDPBackend(choice(qt, kt, vt, **kw)).name if choice else "unknown"
    except (ImportError, RuntimeError, TypeError, ValueError) as exc:
        backend = f"unknown ({type(exc).__name__})"
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    except RuntimeError as exc:
        print(f"library: SDPA refused {tuple(q.shape)}: {exc}"[:300])
        return None, None
    print(f"library: SDPA backend for {tuple(q.shape)} window {window}: "
          f"{backend}", flush=True)

    def fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, **kw)

    def bwd():
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
    return fwd, bwd


@contextlib.contextmanager
def plain_attention():
    """The model's full-sequence attention on the plain version (one masked
    softmax over materialised f32 scores) instead of the kernels: the
    reference paths of the logit and gradient checks, so that no kernel
    attention runs on the side a kernel path is held against."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as A
    kernel = A.blockwise_attention
    before = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    A.blockwise_attention = fa.attention_plain
    try:
        yield
    finally:
        A.blockwise_attention = kernel
    check(before == (fa.flash_attention_fwd.launches,
                     fa.flash_attention_bwd.launches),
          "a flash kernel ran on the plain-attention reference path")


# Where the forward's device time goes at the fastmoe-gpt training shape
# (8 x 256, 16 heads x 64, causal): (B, S, causal) cases that take it apart
SMALL_SHAPE_PARTS = {
    "the training shape": (8, 256, True),
    "its 64 heaviest blocks alone (4 kv tiles each)": (1, 256, True),
    "every block 4 kv tiles (not causal)": (8, 256, False),
    "512 blocks of one kv tile": (32, 64, True),
    "one block of one kv tile": (1, 64, True),
}


def flash_small_shapes(dev):
    """Device times of the bf16 flash forward and SDPA's at SMALL_SHAPE_PARTS
    (16 heads x 64; the last case one head), beside one tiny elementwise
    kernel (the launch floor): what the forward loses to cuDNN at the
    fastmoe-gpt shapes, launch, per-tile latency or the tail."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(11)
    tiny = torch.zeros(16, device=dev)
    parts = [f"launch floor {device_ms(lambda: tiny.add_(1)):.4f} ms"]
    for label, (B, S, causal) in SMALL_SHAPE_PARTS.items():
        H = 1 if B == 1 and S == 64 else 16
        q, k, v = (torch.randn(B, S, H, 64, generator=g, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ours = device_ms(lambda: fa.flash_attention_fwd(
            q, k, v, window=FULL_WINDOW, causal=causal))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        parts.append(f"{label} ({B}x{S}x{H}) {ours:.4f} ms, SDPA {sdpa:.4f} ms")
    print("flash forward small shapes, device (profiler, L2 warm): "
          + "; ".join(parts), flush=True)


def flash_phase(dev, flush):
    """flash_attention_fwd / _bwd against their plain versions in bf16 and
    f32 at FLASH_SHAPES; bf16 timed beside its bound, the plain version and
    SDPA at the three model shapes; the kernels alone at all 48 heads of a
    starcoder2 layer."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(7)
    errs, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        tol = KERNEL_TOL[dn]
        for name, (B, S, H, KV, d, window) in FLASH_SHAPES.items():
            q, do = (torch.randn(B, S, H, d, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            k, v = (torch.randn(B, S, KV, d, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            kw = dict(window=window)
            o, lse = fa.flash_attention_fwd(q, k, v, **kw)
            # bf16 runs twice: where its dQ scratch has a slot per kv tile
            # (the fastmoe-gpt shapes) the two runs must be equal bit for
            # bit; where the kv tiles add into one scratch by atomics (a
            # starcoder2 kv group: its slots would exceed the budget) the
            # order of the adds changes from run to run, and each run must
            # pass on its own
            runs = [fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                    for _ in range(2 if dtype == torch.bfloat16 else 1)]
            torch.cuda.synchronize()
            slots = fa.dq_slots(q, S) if dtype == torch.bfloat16 else 0
            if slots:
                for gname, a, b in zip(("dq", "dk", "dv"), *runs):
                    check(torch.equal(a, b), f"flash_attention_bwd {name}: "
                                             f"{gname} differs between two runs")
            if dtype == torch.bfloat16:
                print(f"flash backward {name} bf16: dq " + (
                    f"bit-equal over two runs ({slots} per-kv-tile slots)"
                    if slots else
                    f"by atomic adds (slots would exceed "
                    f"{fa.DQ_SLOT_BUDGET >> 20} MiB), max |run 0 - run 1| "
                    f"{(runs[0][0].float() - runs[1][0].float()).abs().max().item():.3e}"),
                      flush=True)
            ro, rlse = fa.flash_attention_fwd_plain(q, k, v, **kw)
            e1 = close(f"flash_attention_fwd {name} {dn}", o, ro, tol)
            fro = {"o": frobenius(f"flash_attention_fwd {name} {dn}", o, ro,
                                  FLASH_FRO[dn])}
            same = (o == ro).float().mean().item()
            check(dtype != torch.bfloat16 or same >= FLASH_EQUAL,
                  f"flash_attention_fwd {name} {dn}: {100 * same:.2f}% of "
                  f"outputs equal to the plain version's (< {FLASH_EQUAL})")
            close(f"flash_attention_fwd lse {name} {dn}", lse, rlse,
                  KERNEL_TOL["float32"])
            del ro, rlse
            e2 = 0.0
            ref = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
            for run, grads in enumerate(runs):
                for gname, a, b in zip(("dq", "dk", "dv"), grads, ref):
                    # atol scaled by the gradient's largest entry where > 1
                    scale = max(b.float().abs().max().item(), 1.0)
                    tag = f"flash_attention_bwd {gname} {name} {dn} run {run}"
                    e2 = max(e2, close(tag, a, b, dict(rtol=tol["rtol"],
                                                       atol=tol["atol"] * scale)))
                    fro[f"{gname}{run}"] = frobenius(tag, a, b, FLASH_FRO[dn])
            del ref
            errs[("flash_attention_fwd", dn, name)] = e1
            errs[("flash_attention_bwd", dn, name)] = e2
            print(f"flash {name} {dn}: max |err| forward {e1:.3e} "
                  f"({100 * same:.2f}% of outputs equal to the plain "
                  f"version's), backward {e2:.3e}; relative Frobenius "
                  + " ".join(f"{k} {v:.2e}" for k, v in fro.items()), flush=True)
            del runs
            torch.cuda.empty_cache()
            if dtype != torch.bfloat16 or name in ("window1", "tail"):
                continue
            reps = 5 if name == "starcoder2" else 15
            lib_f, lib_b = sdpa_calls(q, k, v, do, window)
            cases = (
                ("flash_attention_fwd",
                 lambda: fa.flash_attention_fwd(q, k, v, **kw),
                 lambda: fa.attention_plain(q, k, v, **kw), lib_f, False),
                ("flash_attention_bwd",
                 lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, do, **kw),
                 lib_b, True))
            for kname, kern, plain, lib, back in cases:
                nbytes, flops = flash_bound(B, S, H, KV, d, window, backward=back)
                ms = time_ms(kern, flush)
                plain_ms = time_ms(plain, flush, reps)
                lib_ms = time_ms(lib, flush, reps) if lib is not None else None
                b_ms, b_by = bound(nbytes, flops, "bfloat16")
                timed[(kname, name)] = dict(ms=ms, plain_ms=plain_ms,
                                            bound_ms=b_ms, bound_by=b_by,
                                            library_ms=lib_ms)
                on_device = ""
                if name != "starcoder2":  # small: the host may hide the device
                    on_device = (f"; device (profiler, L2 warm) "
                                 f"{device_ms(kern):.4f} ms, SDPA "
                                 + (f"{device_ms(lib):.4f} ms"
                                    if lib is not None else "n/a"))
                print(f"kernel {kname} {name:10s} bf16 {B}x{S} {H}/{KV} heads "
                      f"x {d}, window {window}: {ms:.4f} ms  bound {b_ms:.4f} "
                      f"ms ({b_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} "
                      f"GFLOP)  plain {plain_ms:.4f} ms  SDPA "
                      f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}{on_device}",
                      flush=True)
            del lib_f, lib_b
            torch.cuda.empty_cache()
    flash_small_shapes(dev)
    # one starcoder2 layer at all its heads: the kernels alone
    B, S, H, KV, d, window = STARCODER2_FULL
    q, do = (torch.randn(B, S, H, d, generator=g, device=dev, dtype=torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, d, generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    o, lse = fa.flash_attention_fwd(q, k, v, window=window)
    for kname, kern, back in (
            ("flash_attention_fwd",
             lambda: fa.flash_attention_fwd(q, k, v, window=window), False),
            ("flash_attention_bwd",
             lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, window=window),
             True)):
        nbytes, flops = flash_bound(B, S, H, KV, d, window, backward=back)
        ms = time_ms(kern, flush, 5)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        timed[(kname, "starcoder2_full")] = dict(ms=ms, bound_ms=b_ms)
        print(f"kernel {kname} starcoder2 layer bf16 {B}x{S} {H}/{KV} heads x "
              f"{d}, window {window}: {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}, "
              f"{flops / 1e12:.3f} TFLOP: {flops / ms / 1e9:.1f} TFLOP/s)",
              flush=True)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    print(f"flash attention checks passed: {len(errs)} cases (bf16 tol "
          f"{KERNEL_TOL['bfloat16']}, f32 tol {KERNEL_TOL['float32']}; lse f32 "
          f"tol; gradients' atol x max(1, largest entry); relative Frobenius "
          f"<= {FLASH_FRO}; bf16 forward equal to the plain version on >= "
          f"{FLASH_EQUAL} of outputs)", flush=True)
    return errs, timed


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def with_dispatch(cfg, dispatch):
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            dispatch=dispatch))


def small_reference(dev):
    """Reduced f32 model: kernels on the card against the plain path on the
    CPU, prefill and two decode steps."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import lm

    base = reduced(get_config("fastmoe-gpt"), num_layers=2, d_model=256)
    params = lm.init_params(base, seed=0, device="cpu")
    params_dev = _to(params, dev)
    prompt = torch.randint(0, base.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(3))
    worst = 0.0
    for dispatch in ("ragged", "capacity"):
        cfg = with_dispatch(base, dispatch)
        for impl in ("fused", "pallas"):
            outs = []
            for where, p in (("cpu", params), (dev, params_dev)):
                cache = lm.init_cache(cfg, 2, 32, device=where)
                lp, cache, _ = lm.prefill(p, cfg, prompt, cache, impl=impl,
                                          device=where)
                tok = torch.argmax(outs[0][0][:, -1] if outs else lp[:, -1],
                                   -1)[:, None]
                ld, cache, _ = lm.decode_step(p, cfg, tok.cpu(), 16, cache,
                                              impl=impl, device=where)
                outs.append((lp.cpu(), ld.cpu()))
            for a, b in zip(outs[1], outs[0]):
                worst = max(worst, close(f"reduced model {impl}/{dispatch}",
                                         a, b, SMALL_TOL))
    print(f"reduced fastmoe-gpt f32, card vs CPU plain path: max |err| "
          f"{worst:.3e} (tol {SMALL_TOL})", flush=True)


SERVE_KERNELS = ("grouped_gemm", "gather_rows", "combine_topk", "fused_ffn",
                 "flash_attention_fwd")
# the first versions, for f32 and shapes the ring kernels do not take: no
# model path may run them
SIMPLE_KERNELS = ("grouped_gemm_simple", "fused_ffn_simple",
                  "fused_ffn_bwd_dx_simple", "fused_ffn_bwd_dw_simple")


def counters():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_ffn_bwd as fb
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import token_shuffle as ts
    return {"grouped_gemm": gg.grouped_gemm,
            "grouped_gemm_simple": gg.grouped_gemm_simple,
            "gather_rows": ts.gather_rows,
            "combine_topk": ts.combine_topk, "fused_ffn": ff.fused_ffn,
            "fused_ffn_simple": ff.fused_ffn_simple,
            "fused_ffn_bwd_dx": fb.fused_ffn_bwd_dx,
            "fused_ffn_bwd_dx_simple": fb.fused_ffn_bwd_dx_simple,
            "fused_ffn_bwd_dw": fb.fused_ffn_bwd_dw,
            "fused_ffn_bwd_dw_simple": fb.fused_ffn_bwd_dw_simple,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd": fa.flash_attention_bwd}


def serve_phase(dev):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    base = get_config("fastmoe-gpt")
    t0 = time.perf_counter()
    params = lm.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"fastmoe-gpt: {n / 1e9:.3f} B params (layers bf16, embed/head f32) "
          f"made from seed 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    prompt = torch.randint(0, base.vocab_size, (BATCH, PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    cache_len = serve.cache_len_for(base, PROMPT + GEN)
    combos = [("fused", "ragged"), ("pallas", "ragged"),
              ("fused", "capacity"), ("pallas", "capacity")]
    for impl, dispatch in combos:  # warm-up: first-call costs out of the timing
        serve.generate(params, with_dispatch(base, dispatch), prompt[:, :8], 2,
                       impl=impl, cache_len=16, device=dev)
    torch.cuda.synchronize()

    # ---- the main path: counters at 0 just before, read just after
    for fn in counters().values():
        fn.launches = 0
    results = {}
    for impl, dispatch in combos:
        timings: dict = {}
        seq = serve.generate(params, with_dispatch(base, dispatch), prompt, GEN,
                             impl=impl, cache_len=cache_len, device=dev,
                             timings=timings)
        check(seq.shape == (BATCH, PROMPT + GEN), f"generate shape {seq.shape}")
        check(bool(((seq >= 0) & (seq < base.vocab_size)).all()), "bad tokens")
        check(torch.equal(seq[:, :PROMPT], prompt), "prompt not kept")
        results[(impl, dispatch)] = (seq, timings)
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (serving): {json.dumps(launches)}", flush=True)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the serving path")
    for simple in SIMPLE_KERNELS:
        check(launches[simple] == 0,
              f"the serving path ran {simple} at a model shape")

    for (impl, dispatch), (seq, t) in results.items():
        dec = statistics.median(t["decode_s"])
        total = t["prefill_s"] + sum(t["decode_s"])
        print(f"serve {impl}/{dispatch}: prefill {BATCH}x{PROMPT} "
              f"{t['prefill_s'] * 1e3:.2f} ms ({BATCH * PROMPT / t['prefill_s']:.0f} "
              f"tok/s); decode {dec * 1e3:.3f} ms/step median over "
              f"{len(t['decode_s'])} ({BATCH / dec:.1f} tok/s); end to end "
              f"{BATCH * GEN / total:.1f} generated tok/s", flush=True)
    ref_seq = results[("fused", "ragged")][0]
    for key, (seq, _) in results.items():
        agree = (seq[:, PROMPT:] == ref_seq[:, PROMPT:]).float().mean().item()
        print(f"generated tokens equal to fused/ragged: {key[0]}/{key[1]} "
              f"{agree:.3f}")

    # ---- logits against the einsum oracle, and launches per decode step.
    # The oracle runs the plain einsum experts on the model cast to f32; the
    # bf16 einsum path's distance to it is the bf16 noise floor the kernel
    # paths are held to (see SERVE_* above).  Both run the plain attention,
    # so no kernel runs on the reference side.
    params32 = dict(params, layers=[lm.cast_params(l, torch.float32)
                                    for l in params["layers"]])
    per_step = {}
    for dispatch in ("ragged", "capacity"):
        cfg = with_dispatch(base, dispatch)
        with plain_attention():
            oracle = first_logits(params32, dataclasses.replace(cfg, dtype="float32"),
                                  prompt, "einsum", cache_len, dev)
        floor = None
        for impl in ("einsum", "fused", "pallas"):
            with plain_attention() if impl == "einsum" else contextlib.nullcontext():
                lp, ld, _, step = first_logits(params, cfg, prompt, impl,
                                               cache_len, dev, tok=oracle[2])
            rel_p, rel_d = rel_err(lp, oracle[0]), rel_err(ld, oracle[1])
            med_p, med_d = rel_p.median().item(), rel_d.median().item()
            agree = (lp.argmax(-1) == oracle[0].argmax(-1)).float().mean().item()
            print(f"logits {impl}/{dispatch} bf16 vs f32 einsum oracle: "
                  f"per-position relative error prefill p50 {med_p:.4f} p90 "
                  f"{rel_p.quantile(0.9).item():.4f} max {rel_p.max().item():.4f}, "
                  f"argmax agree {agree:.4f}; first decode p50 {med_d:.4f} max "
                  f"{rel_d.max().item():.4f}", flush=True)
            if floor is None:
                floor = (med_p, med_d, agree)
                continue
            per_step[(impl, dispatch)] = step
            check(med_p <= SERVE_REL_SLACK * floor[0] + SERVE_ABS_SLACK
                  and med_d <= SERVE_REL_SLACK * floor[1] + SERVE_ABS_SLACK
                  and agree >= floor[2] - SERVE_AGREE_SLACK,
                  f"{impl}/{dispatch} logits further from the f32 oracle than "
                  f"the bf16 einsum path (floor {floor}; slack x{SERVE_REL_SLACK} "
                  f"+{SERVE_ABS_SLACK}, agreement -{SERVE_AGREE_SLACK})")
    del params32
    for impl, dispatch in (("fused", "ragged"), ("pallas", "capacity")):
        profile_step(params, with_dispatch(base, dispatch), prompt, impl,
                     cache_len, dev)
    print(f"launches per decode step: "
          f"{json.dumps({f'{i}/{d}': v for (i, d), v in per_step.items()})}")
    return launches


def first_logits(params, cfg, prompt, impl, cache_len, dev, tok=None):
    """(prefill logits, first decode logits, the token fed to the decode
    step — by default the prefill's argmax —, the decode step's kernel
    launches)."""
    import torch
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, prompt.shape[0], cache_len, device=dev)
    lp, cache, _ = lm.prefill(params, cfg, prompt, cache, impl=impl, device=dev)
    if tok is None:
        tok = torch.argmax(lp[:, -1], -1)[:, None]
    before = {k: fn.launches for k, fn in counters().items()}
    ld, cache, _ = lm.decode_step(params, cfg, tok, prompt.shape[1], cache,
                                  impl=impl, device=dev)
    torch.cuda.synchronize()
    launches = {k: fn.launches - before[k] for k, fn in counters().items()}
    for t in (lp, ld):
        check(t.shape[0] == prompt.shape[0] and t.shape[-1] == cfg.vocab_size
              and bool(torch.isfinite(t).all()), f"{impl} logits malformed")
    return lp.float(), ld.float(), tok, launches


def profile_step(params, cfg, prompt, impl, cache_len, dev):
    """One decode step under torch.profiler: wall time, summed kernel time
    (so the device's busy share), kernel launches and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, prompt.shape[0], cache_len, device=dev)
    lp, cache, _ = lm.prefill(params, cfg, prompt, cache, impl=impl, device=dev)
    tok = torch.argmax(lp[:, -1], -1)[:, None]
    for pos in range(prompt.shape[1], prompt.shape[1] + 2):  # warm
        lm.decode_step(params, cfg, tok, pos, cache, impl=impl, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lm.decode_step(params, cfg, tok, prompt.shape[1] + 2, cache, impl=impl,
                       device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3  # us -> ms
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile decode step {impl}/{cfg.moe.dispatch} (profiler on): wall "
          f"{wall * 1e3:.2f} ms, kernels {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}% "
          f"busy), {len(kernels)} kernel launches; top: "
          + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top), flush=True)


# ---------------------------------------------------------------------------
# training: the fused FFN backward kernels, the reduced model card vs CPU,
# full-width training and its gradients against an f32 oracle
# ---------------------------------------------------------------------------


def _to(tree, where):
    if isinstance(tree, dict):
        return {k: _to(v, where) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, where) for v in tree]
    return tree.detach().to(where).clone()


def skewed_sizes(gs):
    """The ragged group sizes with 256 rows moved to expert 7 (~300 rows:
    five of the dW ring kernel's 64-row batches, so the later four read
    back and add to the first's output), taken one at a time from experts
    8.. in turn; the sum is kept."""
    import torch
    sizes = gs.tolist()
    sizes[7] += 256
    i, left = 8, 256
    while left:
        if sizes[i] > 1:
            sizes[i] -= 1
            left -= 1
        i = 8 + (i - 7) % (len(sizes) - 8)
    return torch.tensor(sizes, dtype=torch.int32, device=gs.device)


def bwd_counts():
    from repro_torch.kernels import fused_ffn_bwd as fb
    return tuple(f.launches for f in (fb.fused_ffn_bwd_dx, fb.fused_ffn_bwd_dx_simple,
                                      fb.fused_ffn_bwd_dw, fb.fused_ffn_bwd_dw_simple))


def bwd_routing_times(label, x, ws, wo, dy, gs, flush):
    """The backward's ring kernels (dX, dW) and their first versions at one
    routing (bf16, gelu): ms by events, and the ring kernels' device time.
    dW's blocks each own (expert, hidden chunk) and walk the expert's rows
    in DW_ROWS-row batches, so its time follows the largest expert."""
    from repro_torch.kernels import fused_ffn_bwd as fb
    args = (x, ws, wo, dy, gs, "gelu")
    runs = {"dx": lambda: fb.fused_ffn_bwd_dx(*args),
            "dw": lambda: fb.fused_ffn_bwd_dw(*args),
            "dx_first": lambda: fb.fused_ffn_bwd_dx_simple(*args),
            "dw_first": lambda: fb.fused_ffn_bwd_dw_simple(*args)}
    t = {k: time_ms(fn, flush) for k, fn in runs.items()}
    t.update(dx_device=device_ms(runs["dx"]), dw_device=device_ms(runs["dw"]))
    sizes = gs.tolist()
    # each dW batch after an expert's first reads back and rewrites the f32
    # (DW_CHUNK x K) dwi and (DW_CHUNK x N) dwo slices of its hidden chunks
    later = sum(max(math.ceil(v / fb.DW_ROWS) - 1, 0) for v in sizes)
    readback = later * math.ceil(ws[0].shape[2] / fb.DW_CHUNK) * fb.DW_CHUNK \
        * (x.shape[1] + dy.shape[1]) * 4 * 2
    t["dw_readback_bytes"] = readback
    print(f"routing {label}: {sum(v > 0 for v in sizes)} experts with rows, "
          f"largest {max(sizes)} rows, {sum(v > fb.DW_ROWS for v in sizes)} over "
          f"one {fb.DW_ROWS}-row dW batch, {later} later batches (f32 read back "
          f"and rewritten: {readback / 1e9:.3f} GB, "
          f"{readback / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate): "
          f"dX {t['dx']:.4f} ms (device "
          f"{t['dx_device']:.4f}), dW {t['dw']:.4f} ms (device "
          f"{t['dw_device']:.4f}); first versions dX {t['dx_first']:.4f} ms, "
          f"dW {t['dw_first']:.4f} ms", flush=True)
    return t


def bwd_kernel_phase(dev, flush):
    """fused_ffn_bwd_dx / _dw against their plain versions in bf16 (the
    ring kernels, as the launch counters show) and f32 (the first versions)
    at the training shapes; bf16 timed beside its bound by events and by
    device time, with the first versions (the simple route) and an unfused
    reference by PyTorch calls on the same inputs, and with the fused FFN
    forward and the grouped GEMM's forward and dX (w^T) on the same rows
    (checked against their plain versions, timed beside their bounds and
    torch._grouped_mm).  Ragged: 2044 tokens' top-2 over experts 6..95
    (4088 of 4096 rows, 6 empty experts); capacity: 96 x C = 56 rows, each
    expert's slots past its load zero; tail: the ragged rows with H = 2000
    (a 80-wide last hidden tile); skewed: the ragged rows with expert 7
    over five of the dW kernel's 64-row batches (bf16, gelu)."""
    import torch
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_ffn_bwd as fb
    from repro_torch.kernels import grouped_gemm as gg

    g = torch.Generator(device=dev).manual_seed(5)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    cap = 56  # expert_capacity(2048, 96, 2, 1.25)
    ids_r = routed(2044, 2, 6, dev)
    gs_r = torch.bincount(ids_r.flatten(), minlength=E).to(torch.int32)
    load_c = torch.bincount(routed(2048, 2, 0, dev).flatten(), minlength=E)
    gs_c = torch.full((E,), cap, dtype=torch.int32, device=dev)
    shapes = {"ragged": (4096, gs_r, None), "capacity": (E * cap, gs_c,
                                                          load_c.clamp(max=cap)),
              "skewed": (4096, skewed_sizes(gs_r), None)}
    errs, timed = {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        tol = KERNEL_TOL[dn]
        for hid in (H, 2000):
            wi = randn(E, D, hid, scale=D ** -0.5, dtype=dtype)
            wu = randn(E, D, hid, scale=D ** -0.5, dtype=dtype)
            wo = randn(E, hid, D, scale=hid ** -0.5, dtype=dtype)
            for shape, (M, gs, fill) in shapes.items():
                if (hid != H and shape != "ragged") or (
                        shape == "skewed" and (hid != H or dtype != torch.bfloat16)):
                    continue
                name = shape if hid == H else "tail"
                n, used = int(gs.sum()), int((gs > 0).sum())
                x = randn(M, D, dtype=dtype)
                if fill is None:
                    x[n:] = 0  # the ops contract: rows past the groups are zero
                else:  # capacity buffers: slots past an expert's load are zero
                    slot = torch.arange(cap, device=dev)
                    x.view(E, cap, D)[slot[None] >= fill[:, None]] = 0
                dy = randn(M, D, dtype=dtype)
                acts = (("gelu", (wi,)), ("swiglu", (wi, wu))) \
                    if shape == "ragged" else (("gelu", (wi,)),)
                for act, ws in acts:
                    tag = f"{name} {act} {dn}"
                    rdx = fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, act)
                    rws, rwo = fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, act)
                    # the wrappers (bf16: the ring kernels; f32: the first
                    # versions), then in bf16 the first versions called
                    # directly, each held against the same plain version
                    ring = dtype == torch.bfloat16
                    runs = [("", fb.fused_ffn_bwd_dx, fb.fused_ffn_bwd_dw, ring)]
                    if ring:
                        runs.append(("_simple", fb.fused_ffn_bwd_dx_simple,
                                     fb.fused_ffn_bwd_dw_simple, False))
                    for suffix, fdx, fdw, on_ring in runs:
                        kdx, kdw = f"fused_ffn_bwd_dx{suffix}", f"fused_ffn_bwd_dw{suffix}"
                        before = bwd_counts()
                        dx = fdx(x, ws, wo, dy, gs, act)
                        dws, dwo = fdw(x, ws, wo, dy, gs, act)
                        torch.cuda.synchronize()
                        check(bwd_counts() == (before[0] + 1, before[1] + (not on_ring),
                                               before[2] + 1, before[3] + (not on_ring)),
                              f"{kdx} / {kdw} {tag}: expected the "
                              f"{'ring' if on_ring else 'simple'} kernels "
                              f"(launches {before} -> {bwd_counts()})")
                        e1 = close(f"{kdx} {tag}", dx, rdx, tol)
                        check(not dx[n:].any(), f"{kdx} {tag}: rows past "
                                                f"sum(group_sizes) are not zero")
                        e2 = 0.0
                        for a, b in zip((*dws, dwo), (*rws, rwo)):
                            e2 = max(e2, close(f"{kdw} {tag}", a, b, DW_TOL[dn]))
                            fro = ((a - b).norm() / b.norm()).item()
                            check(fro <= DW_FRO, f"{kdw} {tag}: relative "
                                                 f"Frobenius error {fro:.2e}")
                        empty = gs == 0
                        check(not dwo[empty].any() and not dws[0][empty].any(),
                              f"{kdw} {tag}: empty experts not zero")
                        errs[(kdx, dn, name, act)] = e1
                        errs[(kdw, dn, name, act)] = e2
                        del dx, dws, dwo
                    del rdx, rws, rwo
                if name == "skewed":  # the ring kernels where dW adds batches
                    timed[("fused_ffn_bwd", name)] = bwd_routing_times(
                        name, x, (wi,), wo, dy, gs, flush)
                if dtype != torch.bfloat16 or name in ("tail", "skewed"):
                    continue
                # bf16, gelu (the model's act), timed beside its bound: each
                # input read once (the weights of the experts with rows), each
                # output written once (dW: all experts' f32 dwi and dwo); the
                # first versions (the simple route) and the fused FFN forward
                # on the same rows beside them
                ws, b = (wi,), 2
                wbytes = used * 2 * D * hid * b
                p = fb.plan_bwd(M, E, hid)
                print(f"plan_bwd {name}: dX row tile {p.bm}, {fb.DX_CHUNK} hidden "
                      f"columns a block, {p.splits} splits (f32 partials "
                      f"{2 * p.splits * M * D * 4 / 1e6:.1f} MB written and read "
                      f"back), shared memory {fb.dx_smem(p.bm, False)} B; "
                      f"dW {fb.DW_CHUNK} hidden columns a block, {fb.DW_ROWS} "
                      f"rows a batch, shared memory {fb.dw_smem(False)} B",
                      flush=True)
                cases = {
                    "fused_ffn_bwd_dx": (
                        lambda: fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, "gelu"),
                        lambda: fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, "gelu"),
                        b * 3 * M * D + wbytes + 4 * E, 6 * n * D * hid,
                        lambda: fb.fused_ffn_bwd_dx_simple(x, ws, wo, dy, gs, "gelu")),
                    "fused_ffn_bwd_dw": (
                        lambda: fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, "gelu"),
                        lambda: fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "gelu"),
                        b * 2 * M * D + wbytes + 4 * 2 * E * D * hid + 4 * E,
                        8 * n * D * hid,
                        lambda: fb.fused_ffn_bwd_dw_simple(x, ws, wo, dy, gs, "gelu")),
                    "fused_ffn": (
                        lambda: ff.fused_ffn(x, ws, wo, gs, "gelu"),
                        lambda: ff.fused_ffn_plain(x, ws, wo, gs, "gelu"),
                        b * 2 * M * D + wbytes + 4 * E, 4 * n * D * hid, None),
                }
                got = ff.fused_ffn(x, ws, wo, gs, "gelu")
                torch.cuda.synchronize()
                errs[("fused_ffn", dn, name)] = close(
                    f"fused_ffn {name} gelu {dn}", got,
                    ff.fused_ffn_plain(x, ws, wo, gs, "gelu"), tol)
                del got
                for kname, (kern, plain, nbytes, flops, simple) in cases.items():
                    ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush, 5)
                    dev_ms = device_ms(kern)
                    b_ms, b_by = bound(nbytes, flops, "bfloat16")
                    timed[(kname, name)] = dict(ms=ms, plain_ms=plain_ms,
                                                bound_ms=b_ms, bound_by=b_by,
                                                library_ms=None, device_ms=dev_ms)
                    first = ""
                    if simple is not None:  # the first version, same inputs
                        timed[(kname, name)].update(
                            first_version_ms=time_ms(simple, flush),
                            first_version_device_ms=device_ms(simple))
                        first = (f"; first version {timed[(kname, name)]['first_version_ms']:.4f}"
                                 f" ms, device {timed[(kname, name)]['first_version_device_ms']:.4f} ms")
                    print(f"kernel {kname} {name:8s} bf16: {ms:.4f} ms  bound "
                          f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.0f} MB, "
                          f"{flops / 1e9:.1f} GFLOP)  plain {plain_ms:.4f} ms  "
                          f"library n/a; device (profiler, L2 warm) {dev_ms:.4f} ms"
                          f"{first}", flush=True)
                offs = torch.cumsum(gs, 0).to(torch.int32)
                unfused_ffn(f"fused_ffn {name}", x, wi, wo, offs, flush)
                unfused_ffn_bwd(f"fused_ffn_bwd {name}", x, wi, wo, dy, offs, flush)
                # the pallas path on the same rows: forward x @ wi and dX =
                # dy @ wi^T on the grouped GEMM (w read transposed in place),
                # beside torch._grouped_mm (given wi.transpose(1, 2) for dX);
                # dW the plain per-group product (no kernel yet)
                gx = randn(M, hid, dtype=dtype)
                gx[n:] = 0
                offs = torch.cumsum(gs, 0).to(torch.int32)
                gemm_cases = {
                    "grouped_gemm": (x, wi, False, grouped_mm_call(x, wi, offs)),
                    "grouped_gemm_dx": (gx, wi, True, grouped_mm_call(
                        gx, wi.transpose(1, 2), offs)),
                }
                for kname, (a, w_, tw, lib) in gemm_cases.items():
                    got = gg.grouped_gemm(a, w_, gs, tw)
                    torch.cuda.synchronize()
                    errs[(kname, dn, name)] = close(
                        f"{kname} {name} {dn}", got,
                        gg.grouped_gemm_plain(a, w_, gs, tw), tol)
                    check(not got[n:].any(), f"{kname} {name}: rows past "
                                             f"sum(group_sizes) are not zero")
                    nbytes = b * (a.numel() + used * D * hid + got.numel()) + 4 * E
                    del got
                    ms = time_ms(lambda: gg.grouped_gemm(a, w_, gs, tw), flush)
                    plain_ms = time_ms(lambda: gg.grouped_gemm_plain(a, w_, gs, tw),
                                       flush, 5)
                    lib_ms = time_ms(lib, flush) if lib is not None else None
                    b_ms, b_by = bound(nbytes, 2 * n * D * hid, "bfloat16")
                    timed[(kname, name)] = dict(ms=ms, plain_ms=plain_ms,
                                                bound_ms=b_ms, bound_by=b_by,
                                                library_ms=lib_ms)
                    print(f"kernel {kname:16s} {name:8s} bf16 ({M} rows, "
                          f"{'w^T' if tw else 'w'}): {ms:.4f} ms  bound "
                          f"{b_ms:.4f} ms ({b_by})  plain {plain_ms:.4f} ms  "
                          f"library {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}",
                          flush=True)
                gemm_dw = time_ms(lambda: gg.grouped_dw_plain(x, gx, gs, E), flush, 5)
                print(f"pallas backward {name}: grouped dW, plain per-group "
                      f"product {gemm_dw:.4f} ms (one (E, 1024, 2048) weight)",
                      flush=True)
                del gx
            del wi, wu, wo
    print(f"backward kernel checks passed: {len(errs)} cases (bf16 first "
          f"versions: max |err| dX "
          f"{max(v for k, v in errs.items() if k[0] == 'fused_ffn_bwd_dx_simple'):.3e}, "
          f"dW {max(v for k, v in errs.items() if k[0] == 'fused_ffn_bwd_dw_simple'):.3e}; "
          f"dX: bf16 tol "
          f"{KERNEL_TOL['bfloat16']}, f32 tol {KERNEL_TOL['float32']}; dW: "
          f"bf16 tol {DW_TOL['bfloat16']} and relative Frobenius <= {DW_FRO}, "
          f"f32 tol {DW_TOL['float32']})", flush=True)
    return errs, timed


def _grad_dists(grads, oracle):
    """Per leaf, the relative L2 distance of grads to the oracle's (trees
    or lists of leaves)."""
    from repro_torch.optim.adamw import tree_leaves
    out = []
    for a, o in zip(tree_leaves(grads), tree_leaves(oracle)):
        den = o.float().norm().item()
        out.append((a.float() - o.float()).norm().item() / max(den, 1e-30))
    return out


def small_reference_train(dev):
    """Reduced f32 model (2 layers, remat on) trained 3 steps through the
    kernels on the card against the plain path on the CPU: per-step loss
    and per-leaf gradients."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    base = dataclasses.replace(reduced(get_config("fastmoe-gpt"), num_layers=2,
                                       d_model=256), remat="full")
    worst_loss = worst_grad = worst_l2 = 0.0
    for impl, dispatch in TRAIN_COMBOS:
        cfg = with_dispatch(base, dispatch)
        p_cpu = lm.init_params(cfg, seed=0, device="cpu",
                               param_dtype=cfg.param_dtype)
        sides = {}
        for where in ("cpu", dev):
            p = p_cpu if where == "cpu" else _to(p_cpu, dev)
            opt = AdamW(lr=1e-3)
            sides[where] = [p, opt.init(p), train.make_train_step(
                cfg, opt, warmup=2, total_steps=10, impl=impl, device=where)]
        data = SyntheticLM(cfg.vocab_size, 32, seed=0).batches(4)
        for step in range(3):
            tokens = torch.from_numpy(next(data)["tokens"])
            out = {}
            for where, (p, st, step_fn) in sides.items():
                batch = {"tokens": tokens.to(where)}
                loss, _, grads = train.loss_and_grads(p, cfg, batch, impl=impl,
                                                      device=where)
                p, st, m = step_fn(p, st, batch, step)
                sides[where][:2] = [p, st]
                out[where] = (loss.cpu(), m["loss"].cpu(),
                              [t.cpu() for t in tree_leaves(grads)])
            (lc, mc, gc), (ld, md, gd) = out["cpu"], out[dev]
            worst_loss = max(worst_loss, close(f"train {impl}/{dispatch} loss",
                                               torch.stack([ld, md]),
                                               torch.stack([lc, mc]), SMALL_TOL))
            l2 = max(_grad_dists(gd, gc))
            check(l2 <= SMALL_GRAD_L2, f"train {impl}/{dispatch} step {step}: "
                                       f"gradient L2 distance {l2:.2e}")
            worst_l2 = max(worst_l2, l2)
            if step:
                continue
            for i, (a, b) in enumerate(zip(gd, gc)):
                scale = b.abs().max().item()
                tol = dict(rtol=SMALL_TOL["rtol"], atol=SMALL_TOL["atol"] * scale)
                err = close(f"train {impl}/{dispatch} step 0 grad leaf {i}",
                            a, b, tol)
                worst_grad = max(worst_grad, err / max(scale, 1e-30))
    print(f"reduced fastmoe-gpt f32 training, card vs CPU plain path, 3 steps "
          f"x {len(TRAIN_COMBOS)} paths: max |loss err| {worst_loss:.3e} (tol "
          f"{SMALL_TOL}); step-0 grads max err {worst_grad:.3e} of the leaf's "
          f"max (tol {SMALL_TOL} x leaf max); every step's grads max per-leaf "
          f"relative L2 {worst_l2:.3e} (tol {SMALL_GRAD_L2})", flush=True)


def train_phase(dev):
    """Full-width fastmoe-gpt at TRAIN_LAYERS layers trained from seed 0,
    for each of TRAIN_COMBOS: TRAIN_WARM + TRAIN_STEPS steps.  The launch
    counters are set to 0 just before and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    base = dataclasses.replace(get_config("fastmoe-gpt"), num_layers=TRAIN_LAYERS)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    results = {}
    routing: list = []  # fused/ragged's profiled step: each layer's group sizes
    for fn in counters().values():
        fn.launches = 0
    for impl, dispatch in TRAIN_COMBOS:
        cfg = with_dispatch(base, dispatch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = {k: fn.launches for k, fn in counters().items()}
        t0 = time.perf_counter()
        params = lm.init_params(cfg, seed=0, device=dev,
                                param_dtype=cfg.param_dtype)
        opt = AdamW()
        state = opt.init(params)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tree_leaves(params))
        init_s = time.perf_counter() - t0
        step_fn = train.make_train_step(cfg, opt, impl=impl, device=dev)
        data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
        steps, losses = [], []
        for step in range(TRAIN_WARM + TRAIN_STEPS):
            batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
            timings: dict = {}
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch, step,
                                       timings=timings)
            loss = float(m["loss"])
            wall = time.perf_counter() - t0
            losses.append(loss)
            check(math.isfinite(loss) and 3.0 < loss < 20.0,
                  f"train {impl}/{dispatch} step {step}: loss {loss}")
            check(math.isfinite(float(m["grad_norm"])),
                  f"train {impl}/{dispatch} step {step}: grad norm not finite")
            if step >= TRAIN_WARM:
                steps.append((wall, timings))
        peak = torch.cuda.max_memory_allocated(dev)
        launches = {k: fn.launches - before[k] for k, fn in counters().items()}
        med = statistics.median(w for w, _ in steps)
        split = {k: statistics.median(t[k] for _, t in steps)
                 for k in ("fwd_s", "bwd_s", "opt_s")}
        results[(impl, dispatch)] = dict(step_ms=med * 1e3, launches=launches,
                                         peak=peak, losses=losses)
        print(f"train {impl}/{dispatch}: {TRAIN_LAYERS}-layer fastmoe-gpt "
              f"({n_params / 1e9:.3f} B f32 params, made in {init_s:.1f} s), "
              f"batch {TRAIN_BATCH}x{TRAIN_SEQ}: step {med * 1e3:.1f} ms median "
              f"over {len(steps)} ({tokens_per_step / med:.0f} tokens/s); "
              f"forward {split['fwd_s'] * 1e3:.1f} ms, backward "
              f"{split['bwd_s'] * 1e3:.1f} ms, optimizer "
              f"{split['opt_s'] * 1e3:.1f} ms; peak memory "
              f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB); losses "
              + " ".join(f"{v:.4f}" for v in losses), flush=True)
        print(f"  launches {impl}/{dispatch} ({TRAIN_WARM + TRAIN_STEPS} steps): "
              f"{json.dumps(launches)}", flush=True)
        needed = ["fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw"] \
            if impl == "fused" else ["grouped_gemm"]
        needed += ["flash_attention_fwd", "flash_attention_bwd"]
        if dispatch == "ragged":
            needed += ["gather_rows", "combine_topk"]
        for name in needed:
            check(launches[name] > 0, f"train {impl}/{dispatch}: kernel {name} "
                                      f"was never launched")
        for simple in SIMPLE_KERNELS:
            check(launches[simple] == 0, f"train {impl}/{dispatch}: {simple} "
                                         f"ran at a model shape")
        profile_train_step(f"{impl}/{dispatch}", step_fn, params, state,
                           data, dev, routing if (impl, dispatch) ==
                           ("fused", "ragged") else None)
        del params, state, step_fn
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (training): {json.dumps(launches)}", flush=True)
    torch.cuda.empty_cache()
    return launches, results, routing[:TRAIN_LAYERS]


def profile_train_step(label, step_fn, params, state, data, dev, routing=None):
    """One train step under torch.profiler: wall time, summed kernel time
    (the device's busy share), kernel launches and the top kernels; with a
    ``routing`` list, each fused FFN call's group sizes are put in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
    torch.cuda.synchronize()
    tap = contextlib.nullcontext() if routing is None else group_sizes_tap(routing)
    with tap, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(params, state, batch, TRAIN_WARM + TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ffn_bwd = {k: sum(t for n, t in by_name.items() if f"fused_ffn_bwd_{k}" in n)
               for k in ("dx", "dw")}
    print(f"profile train step {label} (profiler on): wall {wall * 1e3:.1f} ms, kernels "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy), "
          f"{len(kernels)} kernel launches; fused FFN backward dX "
          f"{ffn_bwd['dx']:.2f} ms, dW {ffn_bwd['dw']:.2f} ms; top: "
          + "; ".join(f"{n[:48]} {t:.2f} ms" for n, t in top), flush=True)


@contextlib.contextmanager
def group_sizes_tap(out: list):
    """While open, records the group sizes of every fused FFN call
    (ops.fused_grouped_ffn, which the MoE layer calls through its module)
    and passes the call on unchanged: it keeps the tensor the layer made,
    so it adds no work on the device."""
    from repro_torch.kernels import ops
    orig = ops.fused_grouped_ffn

    def tap(x, ws, wo, group_sizes, act="swiglu"):
        out.append(group_sizes.detach())
        return orig(x, ws, wo, group_sizes, act)
    ops.fused_grouped_ffn = tap
    try:
        yield
    finally:
        ops.fused_grouped_ffn = orig


def model_routing_phase(dev, sizes):
    """The backward kernels at the model's own routing: the group sizes of
    each layer of fused/ragged's profiled train step (random bf16 inputs at
    full width, gelu; the kernels' time depends on the sizes, not the
    values).  Holds both ring kernels against their plain versions at the
    layer with the largest expert (where dW adds the most batches), then
    times ring and first version at every layer; returns the medians over
    the layers (the sums over them read against the profile's)."""
    import torch
    from repro_torch.kernels import fused_ffn_bwd as fb
    g = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)
    M = int(sizes[0].sum())
    check(all(int(gs.sum()) == M for gs in sizes), "model routing: rows differ")
    ws, wo = (randn(E, D, H, scale=D ** -0.5),), randn(E, H, D, scale=H ** -0.5)
    x, dy = randn(M, D), randn(M, D)
    worst = max(range(len(sizes)), key=lambda i: int(sizes[i].max()))
    gs = sizes[worst]
    dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, "gelu")
    close(f"fused_ffn_bwd_dx model routing layer {worst}", dx,
          fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, "gelu"), KERNEL_TOL["bfloat16"])
    del dx
    dws, dwo = fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, "gelu")
    rws, rwo = fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "gelu")
    for a, b in zip((*dws, dwo), (*rws, rwo)):
        close(f"fused_ffn_bwd_dw model routing layer {worst}", a, b, DW_TOL["bfloat16"])
        fro = ((a - b).norm() / b.norm()).item()
        check(fro <= DW_FRO, f"fused_ffn_bwd_dw model routing layer {worst}: "
                             f"relative Frobenius error {fro:.2e}")
    del dws, dwo, rws, rwo
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    per_layer = [bwd_routing_times(f"model layer {i}", x, ws, wo, dy, gs_, flush)
                 for i, gs_ in enumerate(sizes)]
    med = {k: statistics.median(t[k] for t in per_layer) for k in per_layer[0]}
    total = sum(t["dw_device"] for t in per_layer)
    print(f"model routing (fused/ragged profiled step, {len(sizes)} layers, {M} rows; "
          f"held to the plain versions at layer {worst}), median a layer: dX "
          f"{med['dx']:.4f} ms (device {med['dx_device']:.4f}), dW {med['dw']:.4f} "
          f"ms (device {med['dw_device']:.4f}; its f32 read-back "
          f"{med['dw_readback_bytes'] / 1e9:.3f} GB); first versions dX "
          f"{med['dx_first']:.4f}, dW {med['dw_first']:.4f} ms; dW device summed over "
          f"the layers {total:.2f} ms (the step profile's line above reads the "
          f"same launches in the step)", flush=True)
    del flush, x, dy, ws, wo
    torch.cuda.empty_cache()
    return med


def grad_oracle_phase(dev):
    """One step's gradients at full width (2 layers, bf16 compute) of each
    kernel path against the f32 einsum oracle on the same dispatch, held
    to the bf16 einsum path's own distance (see GRAD_* above).  The oracle
    and the bf16 einsum path run the plain attention."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm

    base = dataclasses.replace(get_config("fastmoe-gpt"), num_layers=2)
    params = lm.init_params(base, seed=0, device=dev, param_dtype="float32")
    tokens = torch.from_numpy(next(SyntheticLM(base.vocab_size, TRAIN_SEQ,
                                               seed=1).batches(TRAIN_BATCH))
                              ["tokens"]).to(dev)
    batch = {"tokens": tokens}
    for dispatch in ("capacity", "ragged"):
        cfg = with_dispatch(base, dispatch)
        with plain_attention():
            _, _, oracle = train.loss_and_grads(
                params, dataclasses.replace(cfg, dtype="float32"), batch,
                impl="einsum", device=dev)
        floor = None
        for impl in ("einsum", "fused", "pallas"):
            if (impl, dispatch) not in TRAIN_COMBOS and impl != "einsum":
                continue
            with plain_attention() if impl == "einsum" else contextlib.nullcontext():
                loss, _, grads = train.loss_and_grads(params, cfg, batch,
                                                      impl=impl, device=dev)
            d = _grad_dists(grads, oracle)
            del grads
            med, worst = statistics.median(d), max(d)
            print(f"grads {impl}/{dispatch} bf16 vs f32 einsum oracle "
                  f"(2 layers, full width): per-leaf relative L2 distance "
                  f"median {med:.4f} max {worst:.4f} over {len(d)} leaves; "
                  f"loss {float(loss):.4f}", flush=True)
            if floor is None:
                floor = (med, worst)
                continue
            check(med <= GRAD_REL_SLACK * floor[0] + GRAD_MED_SLACK
                  and worst <= GRAD_REL_SLACK * floor[1] + GRAD_MAX_SLACK,
                  f"{impl}/{dispatch} gradients further from the f32 oracle "
                  f"than the bf16 einsum path (floor {floor})")
        del oracle
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# starcoder2-15b: long-prompt sliding-window serving at full width
# ---------------------------------------------------------------------------

SC2_BATCH, SC2_PROMPT, SC2_GEN = 2, 8192, 32


def starcoder2_logits_phase(dev):
    """starcoder2-15b at full width cut to 2 layers, batch 1, an 8192-token
    prompt (twice the window): the bf16 kernel path's logits against the
    f32 plain path, within the bf16 plain path's own distance (SC2_*)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_config("starcoder2-15b"), num_layers=2)
    params = lm.init_params(cfg, seed=0, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (1, SC2_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    with torch.no_grad():
        params32 = dict(params, layers=[lm.cast_params(l, torch.float32)
                                        for l in params["layers"]])
        with plain_attention():
            oracle = lm.forward(params32, dataclasses.replace(cfg, dtype="float32"),
                                tokens, device=dev)[0]
            del params32
            plain = lm.forward(params, cfg, tokens, device=dev)[0]
        before = fa.flash_attention_fwd.launches
        kern = lm.forward(params, cfg, tokens, device=dev)[0]
        torch.cuda.synchronize()
    check(fa.flash_attention_fwd.launches - before == cfg.num_layers,
          "starcoder2 forward did not run the flash kernel in every layer")
    floor = None
    for name, lg in (("plain bf16", plain), ("kernel bf16", kern)):
        check(bool(torch.isfinite(lg).all()), f"starcoder2 {name} logits not finite")
        rel = rel_err(lg, oracle)
        med = rel.median().item()
        agree = (lg.argmax(-1) == oracle.argmax(-1)).float().mean().item()
        print(f"starcoder2-15b 2 layers, 1x{SC2_PROMPT}: {name} logits vs f32 "
              f"plain path: per-position relative error p50 {med:.5f} p90 "
              f"{rel.quantile(0.9).item():.5f} max {rel.max().item():.5f}, "
              f"argmax agree {agree:.4f}", flush=True)
        if floor is None:
            floor = (med, agree)
            continue
        check(med <= SC2_REL_SLACK * floor[0]
              and agree >= floor[1] - SC2_AGREE_SLACK,
              f"starcoder2 kernel logits further from the f32 plain path than "
              f"the bf16 plain path (floor {floor}; slack x{SC2_REL_SLACK}, "
              f"agreement -{SC2_AGREE_SLACK})")
    del oracle, plain, kern
    profile_prefill(params, cfg, dev)
    del params
    torch.cuda.empty_cache()


def profile_prefill(params, cfg, dev):
    """One prefill of the 2-layer full-width starcoder2-15b (SC2_BATCH x
    SC2_PROMPT into the serving ring) under torch.profiler, after one
    warm-up: wall time, summed kernel time (the device's busy share), the
    flash forward's part of it, and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import serve
    from repro_torch.models import lm
    tokens = torch.randint(0, cfg.vocab_size, (SC2_BATCH, SC2_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    cache_len = serve.cache_len_for(cfg, SC2_PROMPT + SC2_GEN)
    with torch.no_grad():
        for warm in (True, False):
            cache = lm.init_cache(cfg, SC2_BATCH, cache_len, device=dev)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         ) if not warm else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                lm.prefill(params, cfg, tokens, cache, impl="fused", device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            del cache
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    flash = sum(t for n, t in by_name.items() if "flash_fwd" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile starcoder2-15b prefill, {cfg.num_layers} layers, "
          f"{SC2_BATCH}x{SC2_PROMPT} (profiler on): wall {wall * 1e3:.1f} ms, "
          f"kernels {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy), "
          f"{len(kernels)} kernel launches; flash forward {flash:.2f} ms "
          f"({100 * flash / busy:.1f}% of kernel time); top: "
          + "; ".join(f"{n[:48]} {t:.2f} ms" for n, t in top), flush=True)


def starcoder2_serve_phase(dev):
    """Full-width 40-layer starcoder2-15b (bf16 layers, f32 embed and head,
    weights from seed 0) served greedily: SC2_BATCH prompts of SC2_PROMPT
    tokens into a 4096-slot ring, then SC2_GEN decode steps, with the
    launch counters set to 0 just before and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config("starcoder2-15b")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    wbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"starcoder2-15b: {n / 1e9:.3f} B params ({wbytes / 1e9:.2f} GB: "
          f"layers bf16, embed/head f32) made from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompt = torch.randint(0, cfg.vocab_size, (SC2_BATCH, SC2_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    cache_len = serve.cache_len_for(cfg, SC2_PROMPT + SC2_GEN)
    check(cache_len == cfg.attention.sliding_window, f"ring of {cache_len}")
    serve.generate(params, cfg, prompt[:, :256], 2, cache_len=256, device=dev)
    torch.cuda.synchronize()

    # ---- the main path: counters at 0 just before, read just after
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timings: dict = {}
    seq = serve.generate(params, cfg, prompt, SC2_GEN, cache_len=cache_len,
                         device=dev, timings=timings)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (starcoder2 serving): {json.dumps(launches)}",
          flush=True)
    check(seq.shape == (SC2_BATCH, SC2_PROMPT + SC2_GEN), f"shape {seq.shape}")
    check(bool(((seq >= 0) & (seq < cfg.vocab_size)).all()), "bad tokens")
    check(torch.equal(seq[:, :SC2_PROMPT], prompt), "prompt not kept")
    check(launches["flash_attention_fwd"] == cfg.num_layers,
          f"flash_attention_fwd launched {launches['flash_attention_fwd']} "
          f"times in a {cfg.num_layers}-layer prefill")
    # one layer's materialised f32 scores would be B * S * H * S * 4 bytes
    scores = SC2_BATCH * SC2_PROMPT * cfg.attention.num_heads * SC2_PROMPT * 4
    check(peak - wbytes < scores, f"prefill peak {peak / 1e9:.2f} GB holds a "
                                  f"score matrix ({scores / 1e9:.1f} GB)")
    dec = statistics.median(timings["decode_s"])
    print(f"serve starcoder2-15b: prefill {SC2_BATCH}x{SC2_PROMPT} "
          f"{timings['prefill_s'] * 1e3:.2f} ms "
          f"({SC2_BATCH * SC2_PROMPT / timings['prefill_s']:.0f} tok/s); decode "
          f"{dec * 1e3:.3f} ms/step median over {len(timings['decode_s'])} "
          f"({SC2_BATCH / dec:.1f} tok/s), ring {cache_len}; peak memory "
          f"{peak / 2 ** 30:.2f} GiB ({peak / 1e9:.2f} GB: weights "
          f"{wbytes / 1e9:.2f} GB + {(peak - wbytes) / 1e9:.2f} GB, where one "
          f"layer's f32 scores would be {scores / 1e9:.1f} GB); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del params, seq
    torch.cuda.empty_cache()
    return launches


def rel_err(a, b):
    """Relative L2 error of each position's logit vector, flattened."""
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten()


# the kernels redesigned for registers: ptxas must report no spills
NO_SPILL = ("grouped_gemm_mma_kernel", "flash_bwd_mma_kernel",
            "fused_ffn_ring_kernel", "flash_fwd_wgmma_kernel",
            "fused_ffn_bwd_dx_ring_kernel", "fused_ffn_bwd_dw_ring_kernel")


def dynamic_smem_report() -> None:
    """The dynamic shared memory the fused FFN's ring kernel, its
    backward's ring kernels and the bf16 flash forward ask for at each tile
    choice (set at launch, so not in the ptxas lines), each within a
    block's 232,448 bytes; the backward's and the flash forward's equal to
    the host's mirrors (dx_smem, dw_smem, fwd_config)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_ffn_bwd as fb
    lib = _build.load("fused_ffn_bwd", fb._SIGS)
    bwd = {}
    for g in (0, 1):
        for bm in ff.ROW_TILES:
            bwd[("dx", bm, g)] = (lib.fused_ffn_bwd_smem(0, bm, g),
                                  fb.dx_smem(bm, bool(g)))
        bwd[("dw", g)] = (lib.fused_ffn_bwd_smem(1, 0, g), fb.dw_smem(bool(g)))
    check(all(k == h and 0 < k <= fa.SMEM_LIMIT for k, h in bwd.values()),
          f"fused FFN backward shared memory (kernel, host mirror): {bwd}")
    print("  dynamic shared memory (bytes): fused_ffn_bwd_dx_ring_kernel (bm, "
          "gated) " + ", ".join(f"{k[1:]}: {v[0]}" for k, v in bwd.items()
                                    if k[0] == "dx")
          + "; fused_ffn_bwd_dw_ring_kernel (gated) "
          + ", ".join(f"{k[1:]}: {v[0]}" for k, v in bwd.items() if k[0] == "dw"),
          flush=True)
    lib = _build.load("fused_ffn", ff._SIGS)
    sizes = {(bm, hc, g): lib.fused_ffn_smem(bm, hc, g) for bm in ff.ROW_TILES
             for hc in ff.HIDDEN_CHUNKS for g in (0, 1)
             if not (g and hc > 128)}
    lib = _build.load("flash_attention", fa._SIGS)
    for d in fa.HEAD_DIMS:
        for bq, sq in ((64, 1), (128, 1 << 20)):
            got = lib.flash_attention_fwd_smem(d, bq)
            cfg = fa.fwd_config(1, sq, 64, d)
            check(cfg.bq == bq and got == cfg.smem,
                  f"flash forward d {d} bq {bq}: kernel asks {got} B, host "
                  f"mirror {cfg.smem} B")
            sizes[("flash", d, bq)] = got
    check(all(0 < v <= fa.SMEM_LIMIT for v in sizes.values()),
          f"dynamic shared memory out of range: {sizes}")
    print("  dynamic shared memory (bytes): fused_ffn_ring_kernel (bm, hc, "
          "gated) " + ", ".join(f"{k}: {v}" for k, v in sizes.items()
                                if k[0] != "flash")
          + "; flash_fwd_wgmma_kernel (d, bq) "
          + ", ".join(f"({k[1]}, {k[2]}): {v}" for k, v in sizes.items()
                      if k[0] == "flash"), flush=True)


def ptxas_report(libs) -> None:
    """Each kernel's registers, static shared memory and spill bytes from
    the build's -Xptxas -v lines (dynamic shared memory is set at launch);
    fails if a NO_SPILL kernel spills."""
    import re
    import shutil
    filt = shutil.which("c++filt")
    for path in libs.values():
        log = path.with_suffix(".log")
        entry, props = None, {}
        for line in (log.read_text().splitlines() if log.exists() else []):
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
            if m:
                entry = m.group(1)
            elif entry and "spill" in line:
                props[entry] = [line.strip()]
            elif entry and "registers" in line:
                props.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
        for entry, info in props.items():
            name = entry
            if filt:
                name = subprocess.run([filt, entry], capture_output=True, text=True,
                                      timeout=60).stdout.strip() or entry
            name = name.replace("(anonymous namespace)::", "").split("(")[0]
            print(f"  ptxas {path.stem.split('-')[0]}: {name}: "
                  + "; ".join(info), flush=True)
            if any(k in entry for k in NO_SPILL):
                spills = re.findall(r"(\d+) bytes spill", " ".join(info))
                check(spills and not any(int(v) for v in spills),
                      f"{name}: spills registers ({'; '.join(info)})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU machine",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing; run from the "
              f"repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptxas_report(libs)
    dynamic_smem_report()

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    errs, timed = kernel_phase(dev, flush)
    bwd_errs, bwd_timed = bwd_kernel_phase(dev, flush)
    fa_errs, fa_timed = flash_phase(dev, flush)
    del flush
    small_reference(dev)
    small_reference_train(dev)
    launches = serve_phase(dev)
    torch.cuda.empty_cache()  # the serving params are gone with serve_phase
    train_launches, _, routing = train_phase(dev)
    routing_ms = model_routing_phase(dev, routing)
    grad_oracle_phase(dev)
    starcoder2_logits_phase(dev)
    sc2_launches = starcoder2_serve_phase(dev)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    replaces = {
        "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                         "src/repro/kernels/grouped_gemm.py:49"),
        "gather_rows": ("src/repro_torch/csrc/token_shuffle.cu",
                        "src/repro/kernels/token_shuffle.py:29"),
        "combine_topk": ("src/repro_torch/csrc/token_shuffle.cu",
                         "src/repro/kernels/token_shuffle.py:56"),
        "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                      "src/repro/kernels/fused_ffn.py:111"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        t = timed[(name, "decode")]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": launches[name],
            "max_abs_err": errs[(name, "bfloat16", "decode")],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "decode, batch 8, bf16"})
    for name, rep in (("fused_ffn_bwd_dx", "src/repro/kernels/fused_ffn_bwd.py:190"),
                      ("fused_ffn_bwd_dw", "src/repro/kernels/fused_ffn_bwd.py:228")):
        kind = name[-2:]
        t = bwd_timed[(name, "ragged")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/fused_ffn_bwd.cu", "replaces": rep,
            "launches": train_launches[name],
            "max_abs_err": bwd_errs[(name, "bfloat16", "ragged", "gelu")],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "first_version_ms": t["first_version_ms"],
            "first_version_max_abs_err": bwd_errs[(name + "_simple", "bfloat16",
                                                   "ragged", "gelu")],
            "skewed_ms": bwd_timed[("fused_ffn_bwd", "skewed")][kind],
            "model_routing_ms": routing_ms[kind],
            "model_routing_first_version_ms": routing_ms[kind + "_first"],
            "shape": "train, 2048 tokens top-2 = 4096 ragged rows, bf16"})
    for name, rep in (("flash_attention_fwd", "src/repro/kernels/flash_attention.py:73"),
                      ("flash_attention_bwd", "src/repro/models/attention.py:67")):
        t = fa_timed[(name, "starcoder2")]
        by_path = {"fastmoe-gpt serving": launches[name],
                   "fastmoe-gpt training": train_launches[name],
                   "starcoder2-15b serving": sc2_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu", "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": fa_errs[(name, "bfloat16", "starcoder2")],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "one starcoder2-15b kv group: 2 x 8192, 12 heads over 1 "
                     "kv head x 128, window 4096, bf16"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
