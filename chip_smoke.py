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
   (events, and the device time alone: device_ms), and, as a
   labelled reference line, the unfused FFN by PyTorch calls
   (torch._grouped_mm, GELU, torch._grouped_mm); also at the shapes of
   continuous serving (batch-1 prefills, ragged and capacity, and a
   tick's rows; KERNEL_MODELS); the token shuffle at each ragged routing
   and at the training rows (4096): both gather kernels (by destination;
   source-major through the ragged plan's slot_rows, the main path's)
   bitwise, the combine with the weights in the rows' dtype bit-identical
   to f32 weights, and the gather's gradient in slot order against row
   order, timed beside index_select and embedding_bag;
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
   first versions in bf16 too, called directly — and at the hidden shards
   of tp (1024 and 512 at the capacity rows) — and times them beside
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
9. runs expert parallelism (the §3.2 exchange, repro_torch.launch.mesh and
   core.sync) over a 1x1 mesh, a world-size-1 NCCL group in this process:
   the same 10-layer model and batch through the EP paths — a2a and the
   psum mode for fused/ragged, fused/capacity and pallas/ragged,
   expert-internal tensor parallelism (tp) for fused/capacity and
   pallas/capacity —, whose step-0 loss and every gradient leaf, then the
   loss, grad norm and params after one AdamW step from a fresh init, must
   equal the local path's bit for bit (the exchange, the all-reduce, the
   all-gather and the reduce-scatter are copies at world size 1), with
   the launch counters set to 0 just before each EP run and read just
   after; then times the EP AdamW steps against the local one in turns
   (fused/ragged, fused/capacity: median of 5 steps, the differences,
   peak memory, launches per step); then makes full 12-layer fastmoe-gpt
   in f32 whole and per rank (the 4 ranks of a 1x4 mesh, rank (1, 2) of
   a 2x4 mesh with tp), each shard bit-equal to the whole's slice, with
   each init's seconds and peak memory;
9b. (ep_overlap) runs the §5.2 smart schedule over the same 1x1 NCCL mesh
   and model: fused/capacity and pallas/capacity at 2 and 4 chunks (C =
   56: chunks of 28 and 14 rows a source) and fused/ragged at 4, each with
   the exchange decomposed (at one rank no collective) and undecomposed
   (one async NCCL all-to-all a chunk), whose step-0 loss must equal the
   serial exchange's bit for bit and whose gradients stay within the bf16
   rule's slack of the serial path's, with the launch counters set to 0
   just before each run and read just after; the bf16 wire at full width
   (the identity on a bf16 payload) bit-equal to serial; the AdamW steps
   of fused/capacity at 2 and 4 chunks timed against serial in turns and
   profiled; the reduced f32 model's bf16 wire (the cast real) equal
   across schedules and within WIRE_ATOL of the f32 wire; and the fused
   FFN forward, dX, dW and the grouped GEMM at the chunk rows (96 x 28, 96
   x 14, beside 96 x 56), each chunk's rows bit-equal to the whole
   launch's, timed beside their bounds.  The two-level exchange needs at
   least 4 ranks and is not run (one line says so);
10. holds one step's gradients of each kernel path (full width, 2 layers)
   no further from an f32 einsum oracle than the bf16 einsum path is (both
   on plain attention), and fused/ragged's step-0 loss and every gradient
   leaf equal bit for bit through either gather kernel (k = 2);
11. holds the flash-attention kernels (forward; backward dq, dk, dv — the
   bf16 backward twice, bit-equal over the runs: with a dQ slot per kv
   tile at the fastmoe-gpt shapes, over ranges of kv tiles whose slots
   fit the budget at the starcoder2 kv group; and ranges forced on the
   training shape and a tail bit-equal to the all-slots run)
   against their plain versions in bf16 and f32 at the fastmoe-gpt prefill
   (8 x 128) and training (8 x 256) shapes, one starcoder2-15b kv group
   (2 x 8192, 12 heads over 1, window 4096), window 1, sequences that
   are no tile multiple and MLA's (dk 192, dv 128) at a tail and a window,
   the forward at continuous serving's batch-1 prefills (FLASH_PREFILL),
   and times them beside their bounds, the plain
   version and SDPA (run before the model phases, while the plain
   version's f32 scores fit the card), and takes the forward's device time
   at the fastmoe-gpt training shape apart (SMALL_SHAPE_PARTS); then holds
   and times the kernels at MLA's pair at full width (forward 2 x 4096, 128
   heads; backward 16 heads, twice), by events and device time, beside
   their bounds, the plain version and SDPA;
12. holds 2-layer full-width starcoder2-15b logits (1 x 8192) of the
   kernel path no further from an f32 plain-attention path than the bf16
   plain path is, and profiles one 2-layer prefill of 2 x 8192 (busy
   share, the flash forward's share, top kernels);
13. serves full-width 40-layer starcoder2-15b (15.96 B params, bf16 layers)
   greedily: 2 prompts x 8192 tokens into a 4096-slot ring, then 32
   decode steps, with the launch counters set to 0 just before and read
   just after, printing prefill ms, decode ms/step and peak memory;
14. holds 2-layer full-width deepseek-v2-236b logits (2 x 256, MLA prefill
   on the flash kernels at dk 192, dv 128; fused/ragged) no further from
   an f32 plain path on the same weights than the bf16 plain path is;
15. serves deepseek-v2-236b at full width, 4 of its 60 layers (16.9 B
   params, bf16 layers), greedily: 2 prompts x 4096 tokens, then 32
   absorbed-form decode steps against a 4160-slot latent cache, for
   fused/ragged and pallas/capacity, with the launch counters set to 0
   just before and read just after (the flash forward once a layer a
   prefill), printing prefill ms, decode ms/step and peak memory; then
   profiles one prefill (busy share, top kernels) and one decode step;
   then serves 8 requests of 513-1024 prompt tokens and 64 new by
   continuous batching through 4 slots, paged (blocks of 64) and ring,
   each a main path of its own, whose tokens must be equal bit for bit,
   times steady ticks of both in turns and profiles one;
16. (after step 9) serves full-width fastmoe-gpt by continuous batching
   (launch/scheduler.ContinuousBatcher: 8 slots, blocks of 16, max_len
   160) to 24 requests of 65-128 prompt tokens and 32 new, for
   fused/ragged paged (the headline), pallas/capacity paged, fused/ragged
   ring, and both admission policies on output lengths of 8-32, each a
   main path of its own (counters at 0 just before, read just after),
   printing tok/s, ticks, TTFT and per-token p50/p99 and peak memory;
   fails unless paged and ring tokens are equal bit for bit and the
   continuous tokens agree with an f32 static pass over the same
   sequences no less than the bf16 einsum path does (less
   SERVE_AGREE_SLACK); times steady ticks of paged and ring in turns,
   holds one steady tick's logits against the f32 einsum oracle on the
   same pool (SERVE_* slack over the bf16 einsum floor) and profiles one
   tick (busy share, hand-written launches with the counters at 0 just
   before and read just after); then runs the psum mode over a 1x1 mesh
   (a world-size-1 NCCL group in this process) for fused/ragged and
   pallas/capacity, failing unless its tokens equal the local path's bit
   for bit, with steady ticks of both in turns, the pallas/capacity
   tick's logits held as above and a profiled tick of each batcher;
17. (after step 15; slice 13) the routing zoo on full-width fastmoe-gpt
   (``router_phase``: noisy_topk, gumbel and frozen on ragged,
   expert_choice on capacity and ragged, each fused and pallas): 2-layer
   gradients within the bf16 einsum floor of the f32 oracle; at 10
   layers the step-0 loss and every gradient leaf (the main path, counters
   at 0 just before and read just after) bit-equal to a second run and to
   a2a and psum over a 1x1 NCCL mesh; AdamW steps timed, frozen after the
   distilling ones; switch-base-128 (``switch_phase``: top-1, 128
   experts) served whole for {fused, pallas} x {ragged, capacity}, logits
   against the f32 oracle, and trained at 4 of 12 layers (the k = 1
   backward); arctic-480b at 2 of 35 layers (``arctic_phase``: each
   expert cast to bf16 as it is drawn) served 2 x 2048 + 16 steps, layer
   0's MoE block with its dense residual against an f32 oracle computed
   expert by expert; smollm-360m, granite-3-2b and qwen2-72b (24 of 80
   layers) served 2 x 2048 + 16 steps with prefill logits against the f32
   plain path (``dense_phase``); deepseek-v2-236b trained at every width,
   2 of 60 layers and 32 of 160 routed experts (``deepseek_train_phase``:
   gradients against the f32 oracle, the flash backward at (192, 128) and
   the fused dX / dW at K 5120, H 1536 counted on the main path, AdamW
   steps timed); and, in the kernel phases, the fused FFN, dX and dW at
   deepseek's training rows (``ds_bwd_kernel_phase``) and the unfused
   SwiGLU references at deepseek's rows;
18. (slice 14) expert placement on full-width fastmoe-gpt at 10 layers
   over a 1x1 NCCL mesh (``placement_phase``): forced plans, (a) a seeded
   permutation per layer and (b) (a) with 8 shadowed experts, for
   {fused, pallas} x {capacity, ragged} in a2a (and (a) locally on
   fused/ragged): the
   step-0 loss and every gradient leaf in logical order against the
   unplaced step's (bit for bit under (a); under (b) the loss and
   non-expert leaves bit for bit, the expert leaves within
   PLACE_EXPERT_L2), the shadowed experts' launch counted (every expert
   kernel twice as often under (b)); (c), (b) with the exchange's
   capacity at 0.75, its drop fraction against the host's count; the
   AdamW steps of each plan timed in turns on fused/ragged and
   pallas/capacity; the migration of the whole
   params and AdamW state (ms, peak memory, the round trip bit-equal); a
   ReplanHook's forced switch to (a) mid-run bit-equal to the unplaced
   run (losses, grad norm, params); ``train --mesh 1x1 --replan_every 4
   --ragged_bound auto`` (no replan at one rank, the bound 0) timed
   against the CLI without the hook; and the fused FFN, its dX and the
   grouped GEMM at the placed launches' shapes against their plain
   versions;
19. (slice 15, after step 16 on its params, stream and 1x1 NCCL mesh:
   ``serve_placement_phase``) serving under placement in the psum mode on
   fused/ragged and pallas/capacity: each request's tokens under plans
   (a) and (b) (8 shadowed experts outside the all-reduce) and with
   ``apply_placement`` switching identity -> (b) after tick 8 and (b) ->
   (a) after tick 16, each run a main path of its own, bit-equal to the
   identity plan's (the slot-wise reduction); the first tick's logits
   under (b) against the f32 oracle (the SERVE_* slack), the placed
   tokens' agreement with the plain psum run's; a steady tick of the
   plain psum, identity-placed and (b) batchers in turns and profiled;
   ``serve --continuous --mesh 1x1 --replan_every 8`` (no replan at one
   rank) against the CLI without the hook; the fused FFN on a tick's
   owned segment and shadowed tail, the grouped GEMM on the capacity
   tick's owned and shadowed buffers and combine_topk at k = 1 against
   their plain versions beside their bounds; and (in step 18, on its
   10-layer params) the placed psum train step under (a) and (b) against
   the identity-placed step;
20. (slice 16, last: ``resilience_phase``) checkpoints, the step guard,
   the fault drills and telemetry on full-width fastmoe-gpt cut to 2
   layers (~11 GB of params and moments), 8 x 256, seed 0: a NaN at step
   2 skipped and retried from the guard's host snapshot, and a crash
   (exit 137) before a save's publish followed by ``--resume``, each
   bit-equal to an uninterrupted run in every loss and every array's
   sha256 (fused/ragged, and the resume again on pallas/capacity); a
   rotted checkpoint skipped by ``restore_latest``; the dropless fallback
   over a 1x1 NCCL mesh with ``--metrics_out`` / ``--trace`` (the seven
   counters, the tallied collective bytes, the spans); the collectives
   the same with the counters on and off; a step with the guard and
   telemetry on and off in turns; the save, restore, snapshot and guard
   times; and (in step 9's train phase) the guard's snapshot of the
   10-layer state timed against its step.

Prints the kernel times beside their bounds, the serving and training
rates, the card's name and power limit, a ``{"kernels": [...]}`` line and,
last, the ``{"ok": true, "device": ...}`` line.  Any failure exits non-zero
before the last line.  It needs a CUDA card and the repository's src/
beside it.
"""
from __future__ import annotations

import collections
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
L2_BYTES = 50 * 2 ** 20  # H100 SXM L2
# device_ms's first spin (~50 ms at 1.98 GHz): the host issues the timed
# reps behind it
SPIN_CYCLES = 100_000_000
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
# expert parallelism at world size 1 (NCCL): each path's step-0 loss and
# gradients against the local path's, bit for bit; the fused ones timed as
# AdamW steps against the local step, EP_STEPS each after a warm step
EP_COMBOS = (("fused", "ragged"), ("fused", "capacity"), ("pallas", "ragged"))
EP_TIMED = (("fused", "ragged"), ("fused", "capacity"))
EP_STEPS = 5
# the EP paths held bit for bit against the local path at 1x1 besides a2a:
# the psum mode (token_axes ("data",)) for each of EP_COMBOS, and
# expert-internal tensor parallelism (tp_axis "data", capacity only)
TP_COMBOS = (("fused", "capacity"), ("pallas", "capacity"))
# hidden shards H / D of fastmoe-gpt's experts under tp on 2 and 4 data ranks
TP_HIDDEN = (1024, 512)
# the §5.2 smart schedule at 1x1 (ep_overlap): (impl, dispatch, chunks)
# against the serial exchange, each also with the undecomposed exchange
# (one async NCCL all-to-all a chunk).  C = 56 capacity rows an expert, so
# chunks of 28 and 14 rows a source; the flat ragged exchange chunks its
# bound (the expert compute waits for every chunk).  fused/capacity is
# timed in turns at each depth against serial.
OVERLAP_CASES = (("fused", "capacity", 2), ("fused", "capacity", 4),
                 ("pallas", "capacity", 2), ("pallas", "capacity", 4),
                 ("fused", "ragged", 4))
OVERLAP_TIMED = ("fused", "capacity")
CAP_ROWS, CHUNK_ROWS = 56, (28, 14)
# A chunked capacity step against the serial one: the forward and dX are
# bit-equal (a chunk launches with the whole buffer's hidden split), so
# every gradient leaf but the experts' equals serial's bit for bit.  The
# expert leaves take each chunk's dW, rounded to bf16, added a chunk at a
# time: a few bf16 roundings apart (2^-8 = 3.9e-3 relative each).  On an
# H100 their worst relative L2 to serial read 2.61e-3 at 2 chunks and
# 3.24e-3 at 4; held to 1e-2.  One expert's dW wrong in a stacked leaf of
# 96 moves it by ~sqrt(1/96) = 0.1.
OVERLAP_EXPERT_L2 = 1e-2
WIRE_ATOL = 0.05  # the bf16 wire's loss against the f32 wire's, reduced f32
# kernel vs plain version on the same inputs: bf16 outputs are rounded once
# from f32 sums of identical products, so they differ by at most a bf16 ulp
# where a sum straddles a rounding boundary (plus one hidden-tile ulp in the
# fused kernel); f32 sums differ by reassociation over K <= 5120 terms.
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
# At deepseek-v2's widths (K 5120, wo scaled by H^-0.5 = 1536^-0.5) |dg|
# reaches ~24, where a bf16 ulp is 2^-3, and |x| ~6.4: one flipped
# rounding moves an output by up to ~0.8, past DW_TOL's atol (derived at
# fastmoe-gpt's |dg| ~3-11).  There dW is held elementwise to that one-ulp
# bound, ulp(max |dg|) x max |x| (``dw_ulp_atol``; on an NVIDIA H100 80GB
# HBM3 at 700 W the ring kernel and the first version part from the plain
# version alike: max |err| 0.60, relative Frobenius 2.5e-4), and as a
# whole to DW_FRO.
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


def device_ms(fn, reps: int = 10, floor: float = 0.0, what: str = "") -> float:
    """Device time of one call of fn, mean over reps, L2 warm.  The reps
    are issued while the stream waits behind a spin kernel, so the CUDA
    events around them time the device alone, the reps back to back;
    where the host takes longer to issue a call than the device to run it
    (small shapes, and autograd around a library call), time_ms above holds
    host time too.  Fails unless the spin outlasted the issuing (a host
    sync in fn would defeat it), and unless the time is above 0 and above
    ``floor``, the least time the work can take (``device_floor``).  Not
    from torch.profiler: on the card's machine it drops kernel records
    from a window — at its start, at its end or all of them — early in a
    run as well as late."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin = SPIN_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not start.query()  # the device still spinning
        end.synchronize()
        if hidden:
            ms = start.elapsed_time(end) / reps
            check(ms > 0 and ms >= floor, f"device time {what}: {ms:.4f} ms, "
                  f"under the least the work can take ({floor:.4f} ms)")
            return ms
        spin *= 4
    raise SmokeFailure(f"device time {what}: the host did not issue {reps} "
                       f"calls within a {spin // 4} cycle spin")


# each counter of counters() counts launches of one kernel of these names
KERNEL_EVENTS = {
    "grouped_gemm": ("grouped_gemm_mma_kernel", "grouped_gemm_simple_kernel"),
    "gather_rows": ("gather_rows_kernel",),
    "gather_rows_by_source": ("gather_rows_by_source_kernel",),
    "combine_topk": ("combine_topk_kernel",),
    "fused_ffn": ("fused_ffn_ring_kernel", "fused_ffn_simple_kernel"),
    "fused_ffn_bwd_dx": ("fused_ffn_bwd_dx_ring_kernel",
                         "fused_ffn_bwd_dx_simple_kernel"),
    "fused_ffn_bwd_dw": ("fused_ffn_bwd_dw_ring_kernel",
                         "fused_ffn_bwd_dw_simple_kernel"),
    "flash_attention_fwd": ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
    "flash_attention_bwd": ("flash_bwd_mma_kernel", "flash_bwd_dkdv_kernel"),
}
PROFILE_PAD_S = 0.05  # idle host time before and after a profiled block


@contextlib.contextmanager
def profiled():
    """torch.profiler (host and device) around a block timed on the host
    clock.  Yields a dict that holds on exit: ``wall`` (s), ``kernels``
    (the CUDA events), ``busy`` (their device ms), ``by_name``, ``prof``,
    ``runs`` (the launch counters' increments over the block) and
    ``capture``, a note.  The profiler drops kernel records on the card's
    machine (device_ms), most at a window's start, so the block runs
    between idle host spans, and the hand-written kernels' events are
    counted against the launches their counters saw: where fewer came
    back, the note says so, and the times are lower bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    before = {k: f.launches for k, f in counters().items()}
    out: dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        yield out
        torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
    runs = {k: f.launches - before[k] for k, f in counters().items()}
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    want = sum(runs[k] for k in KERNEL_EVENTS)
    seen = sum(n for name, n in collections.Counter(e.name for e in kernels).items()
               if any(p in name for v in KERNEL_EVENTS.values() for p in v))
    out.update(prof=prof, kernels=kernels, by_name=by_name, runs=runs,
               busy=sum(by_name.values()),
               capture=f"hand-written kernels: {seen} of {want} launched came "
                       f"back" + ("" if seen == want else
                                  " (the profiler dropped kernels: the "
                                  "kernel times are lower bounds)"))


def device_floor(nbytes: float, flops: float, dtype_name: str) -> float:
    """The least device time of work that moves nbytes and does flops, L2
    warm: all but the L2's share of the bytes at the memory rate, or the
    operations at the peak rate, whichever is longer."""
    return max((nbytes - L2_BYTES) / HBM_BYTES_PER_S * 1e3,
               flops / PEAK_FLOPS[dtype_name] * 1e3, 0.0)


def bound(nbytes: float, flops: float, dtype_name: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def routed(tokens: int, k: int, lo: int, dev, experts: int = E):
    """Random top-k ids over experts lo..experts-1 (experts < lo stay empty)."""
    import torch
    g = torch.Generator().manual_seed(tokens)
    scores = torch.rand(tokens, experts - lo, generator=g)
    ids = scores.topk(k, dim=-1).indices + lo
    return ids.to(dev)


# The expert kernels at the widths of each model a serving path runs:
# label prefix -> ((experts, d_model, expert hidden, top-k), the kernels
# timed, {routing: (tokens, experts left empty or None for capacity
# buffers, rows M or None, the kernels checked, timed in bf16)}).
# fastmoe-gpt: decode is 8 tokens' top-2 (16 rows) one token short,
# prefill 1024 tokens (2048 rows) 4 tokens short with experts 0..9 empty,
# so both hold the edges (rows past the groups, empty experts); every
# kernel on the ragged rows; the token shuffle also at the training rows
# (8 x 256 tokens top-2: 4096 rows).  deepseek-v2-236b (SwiGLU, top-6 of 160): the
# rows of its two serving paths at batch 2 and a 4096-token prompt,
# fused/ragged (the fused FFN and the token shuffle on 12 and 49152 rows)
# and pallas/capacity (the grouped GEMM on 160 equal groups of C rows, C
# from dispatch.expert_capacity: 1280 and 61440 rows).  Continuous
# serving's shapes: a request's batch-1 prefill (fastmoe-gpt prompts of
# 65-128 tokens, ragged and capacity; deepseek's of 513-1024), the
# capacity buffer of an 8-slot fastmoe-gpt tick, and the 24 rows of a
# 4-slot deepseek tick.  Expert-internal tensor parallelism (capacity
# only) hands a data rank the hidden slice H / D of fastmoe-gpt's experts:
# 1024 over 2 ranks, 512 over 4, at the training rows' capacity buffer
# (checked here in both dtypes; timed, with the backward, in
# bwd_kernel_phase).
GPT_KERNELS = ("grouped_gemm", "grouped_gemm_wo", "fused_ffn",
               "fused_ffn_swiglu", "shuffle")
CAP_KERNELS = ("grouped_gemm", "grouped_gemm_wo", "fused_ffn")
DS_RAGGED = ("fused_ffn_swiglu", "shuffle")
DS_CAP = ("grouped_gemm", "grouped_gemm_wo")
KERNEL_MODELS = {
    "": ((E, D, H, 2), ("grouped_gemm", "fused_ffn", "shuffle"), {
        "decode": (7, 0, 16, GPT_KERNELS, True),
        "prefill": (1020, 10, 2048, GPT_KERNELS, True),
        "train": (2048, 0, 4096, ("shuffle",), True),
        "batch-1 prefill 65": (65, 0, 130, GPT_KERNELS, False),
        "batch-1 prefill 128": (128, 0, 256, GPT_KERNELS, True),
        "capacity batch-1 prefill 65": (65, None, None, CAP_KERNELS, False),
        "capacity batch-1 prefill 128": (128, None, None, CAP_KERNELS, False),
        "capacity tick 8 slots": (8, None, None, CAP_KERNELS, False)}),
    "deepseek ": ((160, 5120, 1536, 6), ("grouped_gemm", "fused_ffn_swiglu",
                                        "shuffle"), {
        "decode": (2, 0, 12, DS_RAGGED, True),
        "prefill": (8192, 0, 49152, DS_RAGGED, True),
        "capacity decode": (2, None, None, DS_CAP, True),
        "capacity prefill": (8192, None, None, DS_CAP, True),
        "batch-1 prefill 513": (513, 0, 3078, DS_RAGGED, False),
        "batch-1 prefill 1024": (1024, 0, 6144, DS_RAGGED, True),
        "tick 4 slots": (4, 0, 24, DS_RAGGED, False)}),
    **{f"tp h{h} ": ((E, D, h, 2), (), {
        "capacity train": (2048, None, None, CAP_KERNELS, False)})
       for h in TP_HIDDEN},
}


def kernel_phase(dev, flush):
    """Every kernel against its plain version in bf16 and f32 at each
    KERNEL_MODELS routing; bf16 (the serving dtype) timed beside its bound.
    Keys: (kernel, dtype, label) and (kernel, label), the label the
    model's prefix and the routing ("decode" for fastmoe-gpt's)."""
    import torch
    from repro_torch.core import dispatch as Dsp
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import token_shuffle as ts

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    errs, timed = {}, {}

    def measure(name, shape, kern, plain, nbytes, flops, peak, lib=None):
        ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, peak)
        fl = device_floor(nbytes, flops, peak)
        dev_ms = device_ms(kern, floor=fl, what=f"{name} {shape}")
        lib_dev = (device_ms(lib, floor=fl, what=f"library {name} {shape}")
                   if lib is not None else None)
        timed[(name, shape)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms,
                                    device_ms=dev_ms, library_device_ms=lib_dev)
        print(f"kernel {name:16s} {shape:26s} bf16: {ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by})  plain {plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; device "
              f"(L2 warm) {dev_ms:.4f} ms, library "
              f"{'n/a' if lib_dev is None else f'{lib_dev:.4f} ms'}",
              flush=True)

    for model, ((nE, nD, nH, k), timed_names, routings) in KERNEL_MODELS.items():
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            tol = KERNEL_TOL[dn]
            wi = randn(nE, nD, nH, scale=nD ** -0.5, dtype=dtype)
            wu = randn(nE, nD, nH, scale=nD ** -0.5, dtype=dtype)
            wo = randn(nE, nH, nD, scale=nH ** -0.5, dtype=dtype)
            for routing, (T, lo, M, names, timed_here) in routings.items():
                shape = model + routing
                timing = (set(names) & set(timed_names)
                          if dtype == torch.bfloat16 and timed_here else set())
                if lo is None:  # both models' capacity_factor
                    C = Dsp.expert_capacity(T, nE, k, 1.25)
                    M, gs = nE * C, torch.full((nE,), C, dtype=torch.int32,
                                                device=dev)
                else:
                    ids = routed(T, k, lo, dev, nE)
                    gs = torch.bincount(ids.flatten(), minlength=nE).to(torch.int32)
                n, used = int(gs.sum()), int((gs > 0).sum())
                edges = not model and routing in ("decode", "prefill")
                check(n <= M and (not edges or (n < M and used < nE)),
                      f"test groups malformed at {shape}")
                x = randn(M, nD, dtype=dtype)
                x[n:] = 0  # the ops contract: rows past the groups arrive zero
                h = randn(M, nH, dtype=dtype)
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
                for name in (c for c in cases if c in names):
                    kern, plain = cases[name]
                    got = kern()
                    torch.cuda.synchronize()
                    errs[(name, dn, shape)] = close(f"{name} {dn} {shape}", got,
                                                    plain(), tol)
                    check(not got[n:].any(), f"{name} {dn} {shape}: rows past "
                                             f"sum(group_sizes) are not zero")

                e, offs = 2, torch.cumsum(gs, 0).to(torch.int32)
                if "shuffle" in names:
                    shuffle_case(shape, dn, tol, ids, nE, k, T, nD, dtype,
                                 randn, "shuffle" in timing, errs, measure)

                if "grouped_gemm" in timing:
                    measure("grouped_gemm", shape, *cases["grouped_gemm"],
                            e * (M * nD + used * nD * nH + M * nH) + 4 * nE,
                            2 * n * nD * nH, "bfloat16",
                            lib=grouped_mm_call(x, wi, offs))
                for name, ws in (("fused_ffn", 1), ("fused_ffn_swiglu", 2)):
                    if name in timing:  # x, y; the used experts' wi (, wu), wo
                        measure(name, shape, *cases[name],
                                e * (2 * M * nD + used * (ws + 1) * nD * nH)
                                + 4 * nE, 2 * (ws + 1) * n * nD * nH, "bfloat16")
                if "fused_ffn" in timing:
                    unfused_ffn(f"fused_ffn {shape}", x, wi, wo, offs, flush)
                if "fused_ffn_swiglu" in timing:
                    unfused_ffn(f"fused_ffn_swiglu {shape}", x, wi, wo, offs,
                                flush, wu=wu)
            del wi, wu, wo, x, h
            torch.cuda.empty_cache()
    print(f"kernel checks passed: {len(errs)} cases (bf16 tol "
          f"{KERNEL_TOL['bfloat16']}, f32 tol {KERNEL_TOL['float32']}, gather "
          f"bitwise)", flush=True)
    return errs, timed


def shuffle_case(shape, dn, tol, ids, nE, k, T, nD, dtype, randn, timing,
                 errs, measure):
    """The token shuffle on one routing: tokens -> expert order -> back.
    Both gather kernels (by destination through token_rows; source-major
    through the plan's slot_rows, the main path) bitwise against the plain
    gather; the combine with the weights as the main path passes them
    (rounded to the rows' dtype) bit-identical to the same weights in f32,
    and within tol of its plain version; the gather's gradient through
    slot_rows (slot order) against the sort of token_rows (row order), bit
    for bit at k = 2.  Timed beside index_select and embedding_bag."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import dispatch as Dsp
    from repro_torch.kernels import token_shuffle as ts
    plan = Dsp.make_ragged_plan(ids, nE)
    rows, slots = plan.token_rows, plan.slot_rows
    xt = randn(T, nD, dtype=dtype)
    check(ts.by_source_fits(xt, slots), f"{shape}: rows the source-major "
                                        f"gather does not take")
    gathers = {"gather_rows": (lambda: ts.gather_rows(xt, rows),
                               lambda: ts.gather_rows_plain(xt, rows)),
               "gather_rows_by_source": (
                   lambda: ts.gather_rows(xt, rows, slots),
                   lambda: ts.gather_rows_by_source_plain(xt, slots))}
    ref = ts.gather_rows_plain(xt, rows)
    for name, (kern, plain) in gathers.items():
        before = (ts.gather_rows.launches, ts.gather_rows_by_source.launches)
        got = kern()
        torch.cuda.synchronize()
        ran = (ts.gather_rows.launches - before[0],
               ts.gather_rows_by_source.launches - before[1])
        check(ran == ((1, 0) if name == "gather_rows" else (0, 1)),
              f"{name} {dn} {shape}: launched {ran} (by destination, source)")
        check(torch.equal(got, ref) and torch.equal(plain(), ref),
              f"{name} {dn} {shape}: not bitwise equal")
        errs[(name, dn, shape)] = 0.0
    w = torch.softmax(randn(T, k), -1).to(dtype)  # as combine_ragged passes them
    src = randn(k * T, nD, dtype=dtype)
    got = ts.combine_topk(src, slots, w)
    torch.cuda.synchronize()
    check(torch.equal(got, ts.combine_topk(src, slots, w.float())),
          f"combine_topk {dn} {shape}: {dn} weights differ from f32 weights")
    errs[("combine_topk", dn, shape)] = close(
        f"combine_topk {dn} {shape}", got,
        ts.combine_topk_plain(src, slots, w), tol)
    dy = randn(k * T, nD, dtype=dtype)
    by_slot = ts.combine_topk(dy, slots)
    by_row = ts.combine_topk(dy, torch.argsort(rows, stable=True)
                             .reshape(T, k).to(torch.int32))
    torch.cuda.synchronize()
    if k <= 2:
        check(torch.equal(by_slot, by_row), f"gather gradient {dn} {shape}: "
                                            f"slot order differs from row order")
    else:
        close(f"gather gradient {dn} {shape}", by_slot, by_row, tol)
    if not timing:
        return
    e = 2
    gbytes = e * nD * (int(rows.unique().numel()) + rows.numel()) + 4 * rows.numel()
    for name, (kern, plain) in gathers.items():
        measure(name, shape, kern, plain, gbytes, 0, "bfloat16",
                lib=lambda: torch.index_select(xt, 0, rows))
    measure("combine_topk", shape, lambda: ts.combine_topk(src, slots, w),
            lambda: ts.combine_topk_plain(src, slots, w),
            e * nD * (int(slots.unique().numel()) + T)
            + (4 + w.element_size()) * slots.numel(), 2 * slots.numel() * nD,
            "float32", lib=lambda: F.embedding_bag(
                slots, src, per_sample_weights=w, mode="sum"))


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


def unfused_ffn(label, x, wi, wo, offs, flush, wu=None):
    """A reference line, not the library column: the expert FFN as PyTorch
    calls (torch._grouped_mm, tanh GELU, torch._grouped_mm; with ``wu``
    SwiGLU, two grouped products into silu(g) * u), which write the (M, H)
    hidden to device memory; it shows whether fusion pays.  Events and
    device time, or a note where this PyTorch lacks the grouped product."""
    import torch
    import torch.nn.functional as F
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print(f"reference {label}: torch._grouped_mm is not in this PyTorch")
        return

    def run():
        if wu is None:
            h = F.gelu(fn(x, wi, offs=offs), approximate="tanh")
        else:
            h = F.silu(fn(x, wi, offs=offs)) * fn(x, wu, offs=offs)
        return fn(h, wo, offs=offs)
    try:
        run()
    except RuntimeError as exc:
        print(f"reference {label}: unfused FFN not timed: {exc}"[:300], flush=True)
        return
    act = "GELU" if wu is None else "SwiGLU"
    ms, dev_ms = time_ms(run, flush), device_ms(run, what=label)
    print(f"reference {label}: unfused FFN (torch._grouped_mm + {act} + "
          f"torch._grouped_mm) {ms:.4f} ms, device (L2 warm) {dev_ms:.4f} "
          f"ms", flush=True)
    return ms, dev_ms


def unfused_ffn_bwd(label, x, wi, wo, dy, offs, flush, wu=None):
    """A reference line, not the library column: the expert FFN's backward
    by PyTorch calls, each half recomputing what it needs as the fused
    kernels do, the (M, H) hidden in device memory.  dX: g = x wi and dh =
    dy wo^T (torch._grouped_mm), dg = gelu'(g) dh, dX = dg wi^T.  dW: g,
    dh, dg and h = gelu(g) likewise, then dwi = x^T dg and dwo = h^T dy by
    torch._grouped_mm with the offsets on the contracted rows, where this
    PyTorch takes them (else the line says so).  With ``wu`` (SwiGLU) also
    u = x wu, du, dX += du wu^T and dwu = x^T du.  Events and device
    time."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import fused_ffn_bwd as fb
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        print(f"reference {label}: torch._grouped_mm is not in this PyTorch")
        return
    wo_t, wi_t = wo.transpose(1, 2), wi.transpose(1, 2)
    act = "gelu" if wu is None else "swiglu"

    def grads():
        g = fn(x, wi, offs=offs)
        u = None if wu is None else fn(x, wu, offs=offs)
        dh = fn(dy, wo_t, offs=offs)
        dg, du = fb.act_vjp(g.float(), None if u is None else u.float(),
                            dh.float(), act)
        return g, u, dg.to(x.dtype), None if du is None else du.to(x.dtype)

    def dx_run():
        _, _, dg, du = grads()
        dx = fn(dg, wi_t, offs=offs)
        return dx if du is None else dx + fn(du, wu.transpose(1, 2), offs=offs)

    def dw_run():
        g, u, dg, du = grads()
        if u is None:
            h = F.gelu(g.float(), approximate="tanh").to(x.dtype)
        else:
            h = (F.silu(g.float()) * u.float()).to(x.dtype)
        out = (fn(x.t(), dg, offs=offs), fn(h.t(), dy, offs=offs))
        return out if du is None else out + (fn(x.t(), du, offs=offs),)
    parts, out = [], {}
    for what, run in (("dX", dx_run), ("dW", dw_run)):
        try:
            run()
        except RuntimeError as exc:
            parts.append(f"{what} not timed: {exc}"[:200])
            continue
        out[what] = (time_ms(run, flush), device_ms(run, what=label))
        parts.append(f"{what} {out[what][0]:.4f} ms, device (L2 warm) "
                     f"{out[what][1]:.4f} ms")
    print(f"reference {label}: unfused backward (torch._grouped_mm, "
          f"{'GELU' if wu is None else 'SwiGLU'}', torch._grouped_mm): "
          + "; ".join(parts), flush=True)
    return out


# ---------------------------------------------------------------------------
# flash attention against its plain version
# ---------------------------------------------------------------------------

FULL_WINDOW = 1 << 30
# (B, S, H, KV, dk, dv, window): fastmoe-gpt prefill and training (16
# heads of 64, causal, no window); one starcoder2-15b layer (48 heads of
# 128 over 4 kv heads, window 4096) on one kv group, where the plain
# version's f32 scores fit the card (all 48 heads would need 4 x 6.4 GB per
# copy); the edges: window 1 and sequences that are no tile multiple; and
# MLA's pair (deepseek-v2: dk 192 = 128 nope + 64 rope, dv 128, H = KV) at
# a tail and a window, small enough that the bf16 backward's dQ has a slot
# per kv tile (its full shape is in FLASH_FULL below).
FLASH_SHAPES = {
    "prefill": (BATCH, PROMPT, 16, 16, 64, 64, FULL_WINDOW),
    "train": (TRAIN_BATCH, TRAIN_SEQ, 16, 16, 64, 64, FULL_WINDOW),
    "starcoder2": (2, 8192, 12, 1, 128, 128, 4096),
    "window1": (2, 1000, 12, 4, 128, 128, 1),
    "tail": (3, 333, 16, 16, 64, 64, 100),
    "mla_tail": (2, 333, 8, 8, 192, 128, FULL_WINDOW),
    "mla_window": (2, 1000, 4, 4, 192, 128, 100),
}
# MLA's pair at deepseek-v2's full width (128 heads, H = KV, dk 192, dv
# 128), causal, bf16, one direction each: the forward at a 2 x 4096
# prefill, its plain version over heads in chunks of 16 (with H = KV each
# head is its own problem; all 128 heads' f32 scores would be 17 GB a
# copy); the backward at 16 of the heads (its plain version's autograd and
# its dQ scratch stay small).  name -> (shape, kernel, heads a plain call)
FLASH_FULL = {
    "mla_fwd": ((2, 4096, 128, 128, 192, 128, FULL_WINDOW), "flash_attention_fwd", 16),
    "mla_bwd": ((2, 4096, 16, 16, 192, 128, FULL_WINDOW), "flash_attention_bwd", 0),
}
# continuous serving's batch-1 prefills, the forward alone (no path runs
# their backward), bf16 and f32: fastmoe-gpt prompts of 65 (a one-row
# tail tile) and 128 tokens, deepseek-v2's (MLA) of 513 and 1024
FLASH_PREFILL = {
    "cb_prefill_65": (1, 65, 16, 16, 64, 64, FULL_WINDOW),
    "cb_prefill_128": (1, 128, 16, 16, 64, 64, FULL_WINDOW),
    "cb_mla_prefill_513": (1, 513, 128, 128, 192, 128, FULL_WINDOW),
    "cb_mla_prefill_1024": (1, 1024, 128, 128, 192, 128, FULL_WINDOW),
}
# timed in bf16 beside their bounds: name -> (kernel reps, plain and SDPA
# reps, device-time reps or 0: at starcoder2 the events are device time)
FLASH_TIMED = {"prefill": (15, 15, 10), "train": (15, 15, 10),
               "starcoder2": (15, 5, 0), "mla_fwd": (5, 3, 3), "mla_bwd": (5, 3, 3)}
STARCODER2_FULL = (2, 8192, 48, 4, 128, 128, 4096)  # the kernels alone, all heads


def visible_pairs(S: int, window: int) -> int:
    """Causal (i, j) pairs with 0 <= i - j < window over S positions: what
    this input needs (tiles outside the band are never computed)."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def flash_bound(B, S, H, KV, dk, dv, window, *, backward: bool):
    """(bytes, operations) of the forward (q, k, v, o once; 2 (dk + dv) per
    visible pair and head: q k^T and p v) or the backward (q, k, v, o, dO,
    dq, dk, dv and the f32 lse once; 2 (3 dk + 2 dv) per pair and head:
    s, dp, dv, dk, dq) in bf16.  With dk = dv = d: 4 d and 10 d."""
    e = 2
    q_side, kv_side = B * S * H * (dk + dv) * e, B * S * KV * (dk + dv) * e
    pairs = B * H * visible_pairs(S, window)
    if backward:
        return 2 * q_side + 2 * kv_side + 4 * B * H * S, 2 * (3 * dk + 2 * dv) * pairs
    return q_side + kv_side, 2 * (dk + dv) * pairs


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
    print("flash forward small shapes, device (L2 warm): "
          + "; ".join(parts), flush=True)


def flash_plain_fwd(q, k, v, kw, heads: int = 0):
    """(o, lse) of the plain forward, over heads in chunks of ``heads``
    where given (H = KV: each head is its own problem)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    if not heads:
        return fa.flash_attention_fwd_plain(q, k, v, **kw)
    parts = [fa.flash_attention_fwd_plain(q[:, :, h:h + heads], k[:, :, h:h + heads],
                                          v[:, :, h:h + heads], **kw)
             for h in range(0, q.shape[2], heads)]
    return torch.cat([p[0] for p in parts], 2), torch.cat([p[1] for p in parts], 1)


def flash_check(tag, dn, q, k, v, do, kw, *, fwd=True, bwd=True, heads=0):
    """The flash kernels against their plain versions on one input.
    Forward: o elementwise and by relative Frobenius, lse, and in bf16 >=
    FLASH_EQUAL of the outputs bit-equal.  Backward, bf16 twice: the two
    runs must be equal bit for bit, where its dQ has a slot per kv tile
    (the fastmoe-gpt shapes) and where the kv tiles run in ranges whose
    slots fit the budget (a starcoder2 kv group), and each run must pass
    on its own; each gradient's atol x max(1, its largest entry).  Returns
    (o, lse, forward max |err|, backward max |err|)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    tol = KERNEL_TOL[dn]
    B, S, H = q.shape[:3]
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    check(o.shape == (B, S, H, v.shape[3]), f"flash {tag}: output {tuple(o.shape)}")
    e1 = e2 = 0.0
    fro, notes = {}, []
    if fwd:
        ro, rlse = flash_plain_fwd(q, k, v, kw, heads)
        e1 = close(f"flash_attention_fwd {tag}", o, ro, tol)
        fro["o"] = frobenius(f"flash_attention_fwd {tag}", o, ro, FLASH_FRO[dn])
        same = (o == ro).float().mean().item()
        check(dn != "bfloat16" or same >= FLASH_EQUAL,
              f"flash_attention_fwd {tag}: {100 * same:.2f}% of outputs equal "
              f"to the plain version's (< {FLASH_EQUAL})")
        close(f"flash_attention_fwd lse {tag}", lse, rlse, KERNEL_TOL["float32"])
        notes.append(f"{100 * same:.2f}% of outputs equal to the plain version's")
        del ro, rlse
    if bwd:
        runs = [fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
                for _ in range(2 if dn == "bfloat16" else 1)]
        torch.cuda.synchronize()
        if dn == "bfloat16":
            for gname, a, b in zip(("dq", "dk", "dv"), *runs):
                check(torch.equal(a, b), f"flash_attention_bwd {tag}: {gname} "
                                         f"differs between two runs")
            slots, tiles = fa.dq_slots(q, S), math.ceil(S / fa.BWD_KV_TILE)
            notes.append(f"dq, dk, dv bit-equal over two runs ({slots} of "
                         f"{tiles} per-kv-tile slots a range, "
                         f"{math.ceil(tiles / slots)} range(s))")
        ref = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
        for run, grads in enumerate(runs):
            for gname, a, b in zip(("dq", "dk", "dv"), grads, ref):
                check(a.shape == b.shape, f"flash {tag}: {gname} {tuple(a.shape)}")
                scale = max(b.float().abs().max().item(), 1.0)
                gtag = f"flash_attention_bwd {gname} {tag} run {run}"
                e2 = max(e2, close(gtag, a, b, dict(rtol=tol["rtol"],
                                                    atol=tol["atol"] * scale)))
                fro[f"{gname}{run}"] = frobenius(gtag, a, b, FLASH_FRO[dn])
        del ref, runs
    print(f"flash {tag}: max |err|"
          + (f" forward {e1:.3e}" if fwd else "") + (f" backward {e2:.3e}" if bwd else "")
          + "; " + "".join(f"{n}; " for n in notes) + "relative Frobenius "
          + " ".join(f"{k} {v:.2e}" for k, v in fro.items()), flush=True)
    torch.cuda.empty_cache()
    return o, lse, e1, e2


def flash_time(name, q, k, v, o, lse, do, kw, flush, kernels, heads=0):
    """The bf16 kernels of ``kernels`` on one input timed by events beside
    their bound, the plain version and SDPA (and by device time), with
    FLASH_TIMED[name]'s reps; {kernel: record}."""
    from repro_torch.kernels import flash_attention as fa
    reps, plain_reps, dev_reps = FLASH_TIMED[name]
    B, S, H, dk = q.shape
    KV, dv, window = k.shape[2], v.shape[3], kw["window"]
    lib_f, lib_b = sdpa_calls(q, k, v, do, window)
    cases = {
        "flash_attention_fwd": (
            lambda: fa.flash_attention_fwd(q, k, v, **kw),
            (lambda: flash_plain_fwd(q, k, v, kw, heads)) if heads
            else (lambda: fa.attention_plain(q, k, v, **kw)), lib_f, False),
        "flash_attention_bwd": (
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, **kw),
            lambda: fa.flash_attention_bwd_plain(q, k, v, do, **kw), lib_b, True)}
    timed = {}
    for kname in kernels:
        kern, plain, lib, back = cases[kname]
        nbytes, flops = flash_bound(B, S, H, KV, dk, dv, window, backward=back)
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        ms = time_ms(kern, flush, reps)
        plain_ms = time_ms(plain, flush, plain_reps)
        lib_ms = time_ms(lib, flush, plain_reps) if lib is not None else None
        fl = device_floor(nbytes, flops, "bfloat16")
        dev_ms = (device_ms(kern, dev_reps, fl, f"{kname} {name}") if dev_reps
                  else None)
        lib_dev = (device_ms(lib, dev_reps, fl, f"SDPA {kname} {name}")
                   if dev_reps and lib is not None else None)
        timed[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms, device_ms=dev_ms,
                            library_device_ms=lib_dev)
        on_device = "" if dev_ms is None else (
            f"; device (L2 warm) {dev_ms:.4f} ms, SDPA "
            + ("n/a" if lib_dev is None else f"{lib_dev:.4f} ms"))
        print(f"kernel {kname} {name:10s} bf16 {B}x{S} {H}/{KV} heads x dk {dk} "
              f"dv {dv}, window {window}: {ms:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by}, {nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP: "
              f"{flops / ms / 1e9:.1f} TFLOP/s)  plain {plain_ms:.4f} ms  SDPA "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}{on_device}",
              flush=True)
    return timed


def dq_ranges_check(dev):
    """The bf16 backward's dQ over ranges of kv tiles (its slot budget
    forced down to 2 slots: 2 kv tiles a range, each range summed in order
    into one f32 accumulator) against its all-slots run at the fastmoe-gpt
    training shape and a tail: dq, dk and dv bit for bit."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(11)
    for name in ("train", "tail"):
        B, S, H, KV, dk, dv, window = FLASH_SHAPES[name]
        q, do = (torch.randn(B, S, H, n, generator=g, device=dev)
                 .to(torch.bfloat16) for n in (dk, dv))
        k, v = (torch.randn(B, S, KV, n, generator=g, device=dev)
                .to(torch.bfloat16) for n in (dk, dv))
        o, lse = fa.flash_attention_fwd(q, k, v, window=window)
        whole = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
        slots = fa.dq_slots(q, S)
        budget = fa.DQ_SLOT_BUDGET
        fa.DQ_SLOT_BUDGET = 2 * q.numel() * 4
        try:
            check(fa.dq_slots(q, S) == 2 and fa.dq_accumulator(q, S) is not None,
                  f"dq ranges {name}: the forced budget did not range")
            ranged = fa.flash_attention_bwd(q, k, v, o, lse, do, window=window)
        finally:
            fa.DQ_SLOT_BUDGET = budget
        torch.cuda.synchronize()
        for gname, a, b in zip(("dq", "dk", "dv"), whole, ranged):
            check(torch.equal(a, b), f"dq ranges {name}: {gname} of ranges of "
                                     f"2 kv tiles != the all-slots run")
        print(f"flash_attention_bwd dq ranges {name} {B}x{S}: ranges of 2 kv "
              f"tiles bit-equal to the all-slots run ({slots} slots) in dq, "
              f"dk and dv", flush=True)


def flash_phase(dev, flush):
    """flash_attention_fwd / _bwd against their plain versions in bf16 and
    f32 at FLASH_SHAPES, the forward at FLASH_PREFILL, and in bf16 at
    FLASH_FULL; bf16 timed at
    FLASH_TIMED; the kernels alone at all 48 heads of a starcoder2 layer.
    Keys: (kernel, dtype, shape) and (kernel, shape)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(7)
    errs, timed = {}, {}

    def inputs(B, S, H, KV, dk, dv, dtype):
        return [torch.randn(*shape, generator=g, device=dev).to(dtype)
                for shape in ((B, S, H, dk), (B, S, KV, dk), (B, S, KV, dv),
                              (B, S, H, dv))]

    cases = [(name, shape, dtype, ("flash_attention_fwd", "flash_attention_bwd"), 0)
             for dtype in (torch.bfloat16, torch.float32)
             for name, shape in FLASH_SHAPES.items()]
    cases += [(name, shape, dtype, ("flash_attention_fwd",), 0)
              for dtype in (torch.bfloat16, torch.float32)
              for name, shape in FLASH_PREFILL.items()]
    cases += [(name, shape, torch.bfloat16, (kname,), heads)
              for name, (shape, kname, heads) in FLASH_FULL.items()]
    for name, (B, S, H, KV, dk, dv, window), dtype, kernels, heads in cases:
        dn = str(dtype).split(".")[-1]
        q, k, v, do = inputs(B, S, H, KV, dk, dv, dtype)
        kw = dict(window=window)
        o, lse, e1, e2 = flash_check(
            f"{name} {dn}", dn, q, k, v, do, kw, heads=heads,
            fwd="flash_attention_fwd" in kernels, bwd="flash_attention_bwd" in kernels)
        for kname, err in zip(("flash_attention_fwd", "flash_attention_bwd"), (e1, e2)):
            if kname in kernels:
                errs[(kname, dn, name)] = err
        if dtype == torch.bfloat16 and name in FLASH_TIMED:
            for kname, rec in flash_time(name, q, k, v, o, lse, do, kw, flush,
                                         kernels, heads).items():
                timed[(kname, name)] = rec
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    flash_small_shapes(dev)
    dq_ranges_check(dev)
    # one starcoder2 layer at all its heads: the kernels alone
    B, S, H, KV, d, _, window = STARCODER2_FULL
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
        nbytes, flops = flash_bound(B, S, H, KV, d, d, window, backward=back)
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


SERVE_KERNELS = ("grouped_gemm", "gather_rows_by_source", "combine_topk",
                 "fused_ffn", "flash_attention_fwd")
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
            "gather_rows_by_source": ts.gather_rows_by_source,
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
    from repro_torch.models import lm
    cache = lm.init_cache(cfg, prompt.shape[0], cache_len, device=dev)
    lp, cache, _ = lm.prefill(params, cfg, prompt, cache, impl=impl, device=dev)
    tok = torch.argmax(lp[:, -1], -1)[:, None]
    for pos in range(prompt.shape[1], prompt.shape[1] + 2):  # warm
        lm.decode_step(params, cfg, tok, pos, cache, impl=impl, device=dev)
    with profiled() as p:
        lm.decode_step(params, cfg, tok, prompt.shape[1] + 2, cache, impl=impl,
                       device=dev)
    wall, busy = p["wall"], p["busy"]
    top = sorted(p["by_name"].items(), key=lambda kv: -kv[1])[:6]
    print(f"profile decode step {cfg.name} {impl}/{cfg.moe.dispatch} (profiler "
          f"on): wall "
          f"{wall * 1e3:.2f} ms, kernels {busy:.3f} ms ({100 * busy / (wall * 1e3):.1f}% "
          f"busy), {len(p['kernels'])} kernel launches; {p['capture']}; top: "
          + "; ".join(f"{n[:48]} {t:.3f} ms" for n, t in top), flush=True)


# ---------------------------------------------------------------------------
# continuous batching: the paged KV cache, the admission policies and the
# psum mode at world size 1
# ---------------------------------------------------------------------------

# fastmoe-gpt traffic: ServeConfig(slots=8, block_size=16, max_len=160), a
# pool of 8 x 10 + 2 = 82 blocks; CB_REQUESTS requests drawn as
# serve_continuous draws them from prompt_len CB_PROMPT (65-128 tokens,
# RandomState(1)), CB_GEN new tokens each, all submitted at the start
CB_SLOTS, CB_BLOCK, CB_MAX_LEN = 8, 16, 160
CB_REQUESTS, CB_PROMPT, CB_GEN = 24, 128, 32
# (label, impl, dispatch, ServeConfig overrides, mixed output lengths): the
# headline first, the ring on the headline's path; then the two admission
# policies on a stream whose output lengths differ (CB_MIXED_GEN, drawn
# from RandomState(2)) — with every request asking for CB_GEN tokens the
# slots of a batch all finish on one tick, and the policies tick alike
CB_RUNS = (("fused/ragged paged", "fused", "ragged", {}, False),
           ("pallas/capacity paged", "pallas", "capacity", {}, False),
           ("fused/ragged ring", "fused", "ragged", {"paged": False}, False),
           ("fused/ragged mixed continuous", "fused", "ragged", {}, True),
           ("fused/ragged mixed static", "fused", "ragged",
            {"policy": "static"}, True))
CB_MIXED_GEN = (8, CB_GEN)
CB_PSUM = (("fused", "ragged"), ("pallas", "capacity"))
# deepseek-v2-236b (DS_LAYERS layers): 4 slots, blocks of 64, max_len 1088
# (17 blocks), 8 requests from prompt_len 1024 (513-1024 tokens), 64 new
DSC_SLOTS, DSC_BLOCK, DSC_MAX_LEN, DSC_REQUESTS, DSC_PROMPT, DSC_GEN = \
    4, 64, 1088, 8, 1024, 64
CB_ROUNDS = 12  # steady ticks a batcher in the in-turn comparisons
SHUFFLE_KERNELS = ("gather_rows", "gather_rows_by_source", "combine_topk")
CB_KERNELS = {"fused": ("fused_ffn", "gather_rows_by_source", "combine_topk",
                        "flash_attention_fwd"),
              "pallas": ("grouped_gemm", "flash_attention_fwd")}


def run_continuous(label, params, cfg, scfg, impl, dev, *, prompt_len, gen,
                   requests, mesh=None, mixed=False, placement=None,
                   switches=()):
    """The continuous batcher over serve.request_stream's requests (their
    output lengths redrawn from CB_MIXED_GEN when ``mixed``), all submitted
    at the start, with the launch counters set to 0 just before and read
    just after: every request served with its tokens, in the vocabulary,
    the path's kernels launched and no first version.  ``placement``: the
    plan ``params`` are in; ``switches``: (tick, plan) pairs, each applied
    (``apply_placement``) after that tick.  Returns ({request id: tokens},
    serve.serving_stats, launches, peak bytes, the migrations' ms)."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import ContinuousBatcher
    reqs = serve.request_stream(cfg, prompt_len=prompt_len, gen=gen,
                                num_requests=requests)
    if mixed:
        lens = np.random.RandomState(2).randint(CB_MIXED_GEN[0],
                                                CB_MIXED_GEN[1] + 1, requests)
        for r, n in zip(reqs, lens):
            r.max_new_tokens = int(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters().values():
        fn.launches = 0
    batcher = ContinuousBatcher(params, cfg, scfg, mesh=mesh, impl=impl,
                                device=dev, placement=placement)
    t0 = time.time()
    for r in reqs:
        batcher.submit(r)
    switch, migrate_ms = dict(switches), []
    while batcher.queue or any(s is not None for s in batcher.slots):
        check(batcher.step() > 0 or not batcher.queue,
              f"{label}: admission stalled")
        if batcher.ticks in switch:
            torch.cuda.synchronize()
            t_mig = time.perf_counter()
            batcher.apply_placement(switch[batcher.ticks])
            torch.cuda.synchronize()
            migrate_ms.append((time.perf_counter() - t_mig) * 1e3)
    check(batcher.replans == len(switch),
          f"{label}: {batcher.replans} replans, not {len(switch)}")
    stats = serve.serving_stats(batcher.completions, time.time() - t0,
                                batcher.ticks)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters().items()}
    peak = torch.cuda.max_memory_allocated(dev)
    toks = {c.request_id: c.tokens for c in batcher.completions}
    check(sorted(toks) == list(range(requests)), f"{label}: served {sorted(toks)}")
    check(all(len(toks[r.id]) == r.max_new_tokens
              and all(0 <= v < cfg.vocab_size for v in toks[r.id])
              for r in reqs), f"{label}: malformed tokens")
    for name in CB_KERNELS[impl]:
        check(launches[name] > 0, f"{label}: kernel {name} was never launched")
    for simple in SIMPLE_KERNELS:
        check(launches[simple] == 0, f"{label}: ran {simple} at a model shape")
    print(f"continuous {cfg.name} {label} ({scfg.slots} slots, "
          f"{'paged, ' + str(scfg.pool_blocks) + ' blocks of ' + str(scfg.block_size) if batcher.paged else 'ring ' + str(scfg.max_len)}, "
          f"{scfg.policy}): {serve.format_stats(stats)}; decode tick "
          f"{stats['seconds'] / max(stats['ticks'], 1) * 1e3:.2f} ms a tick on "
          f"average (prefills included); peak memory {peak / 1e9:.2f} GB; "
          f"kernel launches {json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    return toks, stats, launches, peak, migrate_ms


def filled(params, cfg, scfg, impl, dev, *, prompt_len, gen, mesh=None,
           placement=None):
    """A batcher whose every slot holds a request of the stream (admitted
    by one tick), with ``gen`` - 2 ticks left before any retires."""
    from repro_torch.launch import serve
    from repro_torch.launch.scheduler import ContinuousBatcher
    b = ContinuousBatcher(params, cfg, scfg, impl=impl, device=dev, mesh=mesh,
                          placement=placement)
    for r in serve.request_stream(cfg, prompt_len=prompt_len, gen=gen,
                                  num_requests=scfg.slots):
        b.submit(r)
    b.step()
    return b


def tick_race(label, batchers: dict) -> dict:
    """Steady decode ticks of filled batchers in turns (every slot busy,
    nothing to admit), CB_ROUNDS each: the median wall of a tick, host
    clock, each tick ending in its argmax's copy to the host."""
    times = {k: [] for k in batchers}
    for _ in range(CB_ROUNDS):
        for k, b in batchers.items():
            t0 = time.perf_counter()
            active = b.step()
            times[k].append((time.perf_counter() - t0) * 1e3)
            check(active == b.B and not b.queue, f"{label} {k}: tick not steady")
    med = {k: statistics.median(v) for k, v in times.items()}
    print(f"steady ticks in turns, {label}, median of {CB_ROUNDS}: "
          + "; ".join(f"{k} {med[k]:.2f} ms ({min(v):.2f}-{max(v):.2f})"
                      for k, v in times.items()), flush=True)
    return med


def profile_tick(label, b) -> dict:
    """One steady decode tick of a filled batcher under torch.profiler:
    wall, kernel time and busy share, CUDA launches, and the hand-written
    kernels' launches that tick (counters at 0 just before the tick, read
    just after; returned, those launched)."""
    for fn in counters().values():
        fn.launches = 0
    with profiled() as p:
        active = b.step()
    runs = {k: fn.launches for k, fn in counters().items()}
    check(active == b.B and not b.queue, f"{label}: the tick was not steady")
    wall, busy = p["wall"], p["busy"]
    print(f"profile continuous tick {b.cfg.name} {label} (profiler on): wall "
          f"{wall * 1e3:.2f} ms, kernels {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% busy), {len(p['kernels'])} kernel "
          f"launches; {p['capture']}; hand-written a tick: "
          f"{json.dumps({k: v for k, v in runs.items() if v})}", flush=True)
    return {k: v for k, v in runs.items() if v}


def tick_logits(label, b, params32) -> None:
    """One tick's logits of a paged batcher, from copies of its pool at its
    tokens, positions and block tables, three ways: its kernel path in
    bf16 and the plain einsum path in bf16 (the floor), both under the
    batcher's decode dist (its mesh and placement, where it has them), and
    the f32 einsum oracle with no dist (``params32``: logical order, the
    pool cast to f32).
    Held as serve_phase holds the first decode step: the median per-slot
    relative error within SERVE_REL_SLACK x floor + SERVE_ABS_SLACK, argmax
    agreement no less than the floor's less SERVE_AGREE_SLACK."""
    import torch
    from repro_torch.models import lm
    toks = torch.as_tensor(b.next_tok, device=b.dev)[:, None]
    pos = torch.as_tensor(b.pos, device=b.dev)
    tables = torch.as_tensor(b.tables, device=b.dev)

    def logits(params, cfg, impl, dist=None):
        dtype = getattr(torch, cfg.dtype)
        pool = [type(c)(*(t.to(dtype, copy=True) if t.is_floating_point()
                          else t.clone() for t in c)) for c in b.pool]
        with torch.no_grad():
            out, _, _ = lm.decode_step(params, cfg, toks, pos, pool, impl=impl,
                                       device=b.dev, block_tables=tables,
                                       dist=dist)
        check(out.shape == (b.B, 1, cfg.vocab_size)
              and bool(torch.isfinite(out).all()), f"{label}: {impl} logits malformed")
        return out[:, 0].float()

    oracle = logits(params32, dataclasses.replace(b.cfg, dtype="float32"), "einsum")
    rows = {}
    for impl in ("einsum", b._impl):
        got = logits(b.params, b.cfg, impl, b._ddist)
        rows[impl] = (rel_err(got, oracle).median().item(),
                      (got.argmax(-1) == oracle.argmax(-1)).float().mean().item())
    (f_rel, f_agree), (k_rel, k_agree) = rows["einsum"], rows[b._impl]
    print(f"steady tick logits {b.cfg.name} {label} ({b.B} slots, positions "
          f"{int(b.pos.min())}-{int(b.pos.max())}) vs the f32 einsum oracle on "
          f"the same pool: per-slot relative error p50 {k_rel:.4f}, argmax agree "
          f"{k_agree:.4f} (bf16 einsum floor {f_rel:.4f}, {f_agree:.4f})", flush=True)
    check(k_rel <= SERVE_REL_SLACK * f_rel + SERVE_ABS_SLACK
          and k_agree >= f_agree - SERVE_AGREE_SLACK,
          f"{label}: a steady tick's logits further from the f32 oracle than "
          f"the bf16 einsum path (floor {f_rel:.4f}, {f_agree:.4f}; slack "
          f"x{SERVE_REL_SLACK} +{SERVE_ABS_SLACK}, agreement -{SERVE_AGREE_SLACK})")


def static_agreement(params, params32, cfg, toks, dev, *, prompt_len, gen,
                     requests):
    """Each request's continuous tokens against a static batch-1 pass over
    its prompt and its tokens (the last excepted): the argmax at every
    generated position, of the f32 einsum oracle (plain attention, layers
    cast to f32), of the bf16 einsum path (plain attention) — the bf16
    floor — and of the bf16 kernel path (fused/ragged).  The continuous
    tokens must agree with the oracle no less than the floor does, less
    SERVE_AGREE_SLACK."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    hits = {"floor": 0, "continuous": 0, "kernel static": 0}
    n = 0
    reqs = serve.request_stream(cfg, prompt_len=prompt_len, gen=gen,
                                num_requests=requests)
    with torch.no_grad():
        for r in reqs:
            got = torch.tensor(toks[r.id], device=dev)
            seq = torch.cat([torch.as_tensor(r.prompt, device=dev), got[:-1]])[None]
            S = len(r.prompt)

            def argmax(p, c, impl):
                return lm.forward(p, c, seq, impl=impl, device=dev)[0][0, S - 1:].argmax(-1)

            with plain_attention():
                oracle = argmax(params32, cfg32, "einsum")
                floor = argmax(params, cfg, "einsum")
            kernel = argmax(params, cfg, "fused")
            hits["floor"] += int((floor == oracle).sum())
            hits["continuous"] += int((got == oracle).sum())
            hits["kernel static"] += int((got == kernel).sum())
            n += got.numel()
    agree = {k: v / n for k, v in hits.items()}
    print(f"continuous fastmoe-gpt fused/ragged tokens vs a static batch-1 pass "
          f"over the same sequences ({n} tokens): argmax agreement with the f32 "
          f"oracle {agree['continuous']:.4f} (bf16 einsum floor "
          f"{agree['floor']:.4f}, slack -{SERVE_AGREE_SLACK}); with the bf16 "
          f"kernel path {agree['kernel static']:.4f}", flush=True)
    check(agree["continuous"] >= agree["floor"] - SERVE_AGREE_SLACK,
          f"continuous tokens agree with the f32 oracle {agree['continuous']:.4f}, "
          f"below the bf16 floor {agree['floor']:.4f} - {SERVE_AGREE_SLACK}")


def continuous_phase(dev):
    """Continuous batching of full-width fastmoe-gpt (CB_*): CB_RUNS, each
    a main path of its own (counters at 0 just before, read just after);
    paged == ring tokens bit for bit; the continuous tokens against a
    static pass; steady ticks of paged and ring in turns; then the psum
    mode over a 1x1 mesh (a world-size-1 NCCL group in this process) for
    CB_PSUM, tokens bit-equal to the local path's, with steady ticks of
    both in turns; one steady tick's logits of fused/ragged and
    pallas/capacity against the f32 einsum oracle on the same pool; one
    profiled steady tick of each path, local and psum; then, on the same
    params, stream and mesh, serving under placement
    (``serve_placement_phase``, and its CLI run after the group is gone).
    Returns (the launches summed over the runs, the hand-written launches
    of each profiled tick, by the label of the batcher it ran on, and the
    placed serving's launches, ticks and kernel rows)."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.launch.serve_api import ServeConfig
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    base = get_config("fastmoe-gpt")
    params = lm.init_params(base, seed=0, device=dev)
    kw = dict(prompt_len=CB_PROMPT, gen=CB_GEN)
    for impl, dispatch in CB_PSUM:  # warm-up: first-call costs out of the timing
        serve.serve_continuous(params, with_dispatch(base, dispatch),
                               ServeConfig(slots=2, block_size=CB_BLOCK,
                                           max_len=CB_MAX_LEN),
                               prompt_len=CB_PROMPT, gen=2, num_requests=2,
                               impl=impl, device=dev)
    total = {k: 0 for k in counters()}
    results = {}
    for label, impl, dispatch, over, mixed in CB_RUNS:
        scfg = ServeConfig(slots=CB_SLOTS, block_size=CB_BLOCK,
                           max_len=CB_MAX_LEN, **over)
        results[label] = run_continuous(label, params, with_dispatch(base, dispatch),
                                        scfg, impl, dev, requests=CB_REQUESTS,
                                        mixed=mixed, **kw)
        for k, v in results[label][2].items():
            total[k] += v
    head, ring = results["fused/ragged paged"], results["fused/ragged ring"]
    check(head[0] == ring[0], "fused/ragged: paged tokens differ from the ring's")
    cont, stat = (results[f"fused/ragged mixed {p}"] for p in ("continuous", "static"))
    same = sum(a == b for i in cont[0] for a, b in zip(cont[0][i], stat[0][i]))
    print(f"paged vs ring, fused/ragged: tokens bit-equal; {head[1]['tok_s']:.1f} "
          f"vs {ring[1]['tok_s']:.1f} tok/s, per-token p50 "
          f"{head[1]['token_p50'] * 1e3:.2f} vs {ring[1]['token_p50'] * 1e3:.2f} "
          f"ms; continuous vs static policy on mixed output lengths "
          f"{CB_MIXED_GEN}: {cont[1]['tok_s']:.1f} vs {stat[1]['tok_s']:.1f} "
          f"tok/s ({cont[1]['ticks']} vs {stat[1]['ticks']} ticks), tokens "
          f"equal {same / max(cont[1]['tokens'], 1):.4f}", flush=True)
    params32 = dict(params, layers=[lm.cast_params(l, torch.float32)
                                    for l in params["layers"]])
    static_agreement(params, params32, with_dispatch(base, "ragged"), head[0],
                     dev, requests=CB_REQUESTS, **kw)
    cfg = with_dispatch(base, "ragged")
    race = {name: filled(params, cfg, ServeConfig(
        slots=CB_SLOTS, block_size=CB_BLOCK, max_len=CB_MAX_LEN, paged=paged),
        "fused", dev, **kw) for name, paged in (("paged", True), ("ring", False))}
    tick_race("fastmoe-gpt fused/ragged", race)
    tick_logits("fused/ragged paged", race["paged"], params32)
    per_tick = {"fused/ragged paged": profile_tick("fused/ragged paged",
                                                   race["paged"])}
    del race

    # ---- the psum mode at world size 1: bit-equal to the local path
    plain = {}
    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        mesh = make_local_mesh(1, 1)
        for impl, dispatch in CB_PSUM:
            cfg = with_dispatch(base, dispatch)
            dist = serve.decode_dist(cfg, mesh, CB_SLOTS)
            check(dist is not None and dist.mode == "psum", f"psum: {dist}")
            label = f"{impl}/{dispatch} paged psum 1x1"
            scfg = ServeConfig(slots=CB_SLOTS, block_size=CB_BLOCK,
                               max_len=CB_MAX_LEN)
            got = run_continuous(label, params, cfg, scfg, impl, dev, mesh=mesh,
                                 requests=CB_REQUESTS, **kw)
            for k, v in got[2].items():
                total[k] += v
            local = results[f"{impl}/{dispatch} paged"]
            check(got[0] == local[0], f"{label}: tokens differ from the local path")
            race = {name: filled(params, cfg, scfg, impl, dev, mesh=m, **kw)
                    for name, m in (("local", None), ("psum", mesh))}
            med = tick_race(f"fastmoe-gpt {impl}/{dispatch}", race)
            print(f"psum 1x1 vs local {impl}/{dispatch}: tokens bit-equal; "
                  f"{got[1]['tok_s']:.1f} vs {local[1]['tok_s']:.1f} tok/s; a "
                  f"steady tick {med['psum']:.2f} vs {med['local']:.2f} ms "
                  f"({med['psum'] - med['local']:+.2f} ms)", flush=True)
            if impl == "pallas":
                tick_logits(f"{impl}/{dispatch} paged", race["local"], params32)
                per_tick[f"{impl}/{dispatch} paged"] = profile_tick(
                    f"{impl}/{dispatch} paged", race["local"])
            per_tick[label] = profile_tick(label, race["psum"])
            plain[(impl, dispatch)] = got[0]
            del race
        print(f"continuous phase wall {time.perf_counter() - t_phase:.1f} s; "
              f"hand-written launches a steady tick: {json.dumps(per_tick)}",
              flush=True)
        placed = serve_placement_phase(dev, base, params, params32, mesh, plain)
    finally:
        tdist.destroy_process_group()
    del params32, params
    torch.cuda.empty_cache()
    placed["cli"] = serve_placement_cli()
    print(f"serve placement phase wall "
          f"{time.perf_counter() - placed['t0']:.1f} s", flush=True)
    return total, per_tick, placed


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
    (M, K), E_, H_ = x.shape, wo.shape[0], wo.shape[1]
    n, used = int(gs.sum()), int((gs > 0).sum())
    wbytes = used * 2 * K * H_ * 2
    t.update(dx_device=device_ms(runs["dx"], floor=device_floor(
                 2 * 3 * M * K + wbytes + 4 * E_, 6 * n * K * H_, "bfloat16"),
                 what=f"fused_ffn_bwd_dx {label}"),
             dw_device=device_ms(runs["dw"], floor=device_floor(
                 2 * 2 * M * K + wbytes + 4 * 2 * E_ * K * H_ + 4 * E_,
                 8 * n * K * H_, "bfloat16"), what=f"fused_ffn_bwd_dw {label}"))
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
    over five of the dW kernel's 64-row batches (bf16, gelu); capacity tp
    h1024 / h512: the capacity rows at the hidden shards TP_HIDDEN
    (checked and timed as capacity, without the unfused reference)."""
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
        for hid in (H, 2000, *TP_HIDDEN):
            wi = randn(E, D, hid, scale=D ** -0.5, dtype=dtype)
            wu = randn(E, D, hid, scale=D ** -0.5, dtype=dtype)
            wo = randn(E, hid, D, scale=hid ** -0.5, dtype=dtype)
            tp = hid in TP_HIDDEN
            for shape, (M, gs, fill) in shapes.items():
                if (hid == 2000 and shape != "ragged") or (
                        tp and shape != "capacity") or (
                        shape == "skewed" and (hid != H or dtype != torch.bfloat16)):
                    continue
                name = (shape if hid == H else f"{shape} tp h{hid}" if tp
                        else "tail")
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
                    fl = device_floor(nbytes, flops, "bfloat16")
                    dev_ms = device_ms(kern, floor=fl, what=f"{kname} {name}")
                    b_ms, b_by = bound(nbytes, flops, "bfloat16")
                    timed[(kname, name)] = dict(ms=ms, plain_ms=plain_ms,
                                                bound_ms=b_ms, bound_by=b_by,
                                                library_ms=None, device_ms=dev_ms)
                    first = ""
                    if simple is not None:  # the first version, same inputs
                        timed[(kname, name)].update(
                            first_version_ms=time_ms(simple, flush),
                            first_version_device_ms=device_ms(
                                simple, floor=fl, what=f"{kname} {name} first"))
                        first = (f"; first version {timed[(kname, name)]['first_version_ms']:.4f}"
                                 f" ms, device {timed[(kname, name)]['first_version_device_ms']:.4f} ms")
                    print(f"kernel {kname} {name:8s} bf16: {ms:.4f} ms  bound "
                          f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.0f} MB, "
                          f"{flops / 1e9:.1f} GFLOP)  plain {plain_ms:.4f} ms  "
                          f"library n/a; device (L2 warm) {dev_ms:.4f} ms"
                          f"{first}", flush=True)
                offs = torch.cumsum(gs, 0).to(torch.int32)
                if not tp:
                    unfused_ffn(f"fused_ffn {name}", x, wi, wo, offs, flush)
                    unfused_ffn_bwd(f"fused_ffn_bwd {name}", x, wi, wo, dy,
                                    offs, flush)
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
                      f"product {gemm_dw:.4f} ms (one (E, {D}, {hid}) weight)",
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


def leaf_paths(tree, path: str = "") -> list:
    """(path, leaf) pairs of a params tree, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in tree for p in leaf_paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in leaf_paths(v, f"{path}/{i}")]
    return [(path, tree)]


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
        for name in needed_kernels(impl, dispatch):
            check(launches[name] > 0, f"train {impl}/{dispatch}: kernel {name} "
                                      f"was never launched")
        for simple in SIMPLE_KERNELS:
            check(launches[simple] == 0, f"train {impl}/{dispatch}: {simple} "
                                         f"ran at a model shape")
        profile_train_step(f"{impl}/{dispatch}", step_fn, params, state,
                           data, dev, routing if (impl, dispatch) ==
                           ("fused", "ragged") else None)
        if (impl, dispatch) == ("fused", "ragged"):
            snapshot_times(params, state, dev, med * 1e3)
        del params, state, step_fn
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (training): {json.dumps(launches)}", flush=True)
    torch.cuda.empty_cache()
    return launches, results, routing[:TRAIN_LAYERS]


def host_room(where: Path) -> tuple:
    """(MemAvailable bytes of /proc/meminfo, free bytes of the disk that
    holds ``where``)."""
    import shutil
    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    where.mkdir(parents=True, exist_ok=True)
    return avail, shutil.disk_usage(where).free


def state_bytes(params, state) -> int:
    from repro_torch.optim.adamw import tree_leaves
    return sum(t.numel() * t.element_size()
               for t in tree_leaves((params, state.mu, state.nu)))


def snapshot_times(params, state, dev, step_ms):
    """The step guard's host snapshot of the live 10-layer training state
    (params and both AdamW moments) into pinned host buffers: the first
    commit (allocating the buffers, then copying), a second (the buffers
    reused: what ``--snapshot_every 1`` pays each step), and the restore
    into the live tensors, each ended by a synchronize.  Fails if the host
    cannot hold the snapshot."""
    import gc
    import torch
    from repro_torch.resilience import StepGuard

    nbytes = state_bytes(params, state)
    avail, _ = host_room(ROOT / "build")
    print(f"snapshot: host MemAvailable {avail / 1e9:.2f} GB for the "
          f"{nbytes / 1e9:.2f} GB 10-layer state", flush=True)
    check(avail > 1.1 * nbytes, f"snapshot: the host has {avail / 1e9:.2f} GB "
                                f"available, the snapshot needs {nbytes / 1e9:.2f}")
    guard = StepGuard()
    ms = []
    for what in ("first", "again", "restore"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if what == "restore":
            guard.load_snapshot()
        else:
            guard.commit(len(ms), params, state)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    del guard
    gc.collect()
    print(f"snapshot 10-layer fastmoe-gpt state ({nbytes / 1e9:.2f} GB: params "
          f"and AdamW moments) to pinned host memory: first {ms[0]:.1f} ms "
          f"(allocation + copy), then {ms[1]:.1f} ms a snapshot "
          f"({nbytes / ms[1] / 1e6:.1f} GB/s device to host), guard restore "
          f"{ms[2]:.1f} ms ({nbytes / ms[2] / 1e6:.1f} GB/s host to device); "
          f"a snapshot is {ms[1] / step_ms:.2f} x the {step_ms:.1f} ms step",
          flush=True)


def profile_train_step(label, step_fn, params, state, data, dev, routing=None):
    """One train step under torch.profiler: wall time, summed kernel time
    (the device's busy share), kernel launches and the top kernels; with a
    ``routing`` list, each fused FFN call's group sizes are put in it."""
    import torch
    batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
    tap = contextlib.nullcontext() if routing is None else group_sizes_tap(routing)
    with tap, profiled() as p:
        step_fn(params, state, batch, TRAIN_WARM + TRAIN_STEPS)
    wall, busy, by_name, kernels = p["wall"], p["busy"], p["by_name"], p["kernels"]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    ffn_bwd = {k: sum(t for n, t in by_name.items() if f"fused_ffn_bwd_{k}" in n)
               for k in ("dx", "dw")}
    print(f"profile train step {label} (profiler on): wall {wall * 1e3:.1f} ms, kernels "
          f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy), "
          f"{len(kernels)} kernel launches; {p['capture']}; fused FFN backward dX "
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

    def tap(x, ws, wo, group_sizes, act="swiglu", **plan):
        out.append(group_sizes.detach())
        return orig(x, ws, wo, group_sizes, act, **plan)
    ops.fused_grouped_ffn = tap
    try:
        yield
    finally:
        ops.fused_grouped_ffn = orig


def ep_dists(cfg, mesh, impl, dispatch):
    """The EP paths of one (impl, dispatch) at 1x1: a2a (``moe_dist``, for
    EP_COMBOS), the psum mode over ("data",) (EP_COMBOS) and
    expert-internal tensor parallelism (TP_COMBOS)."""
    from repro_torch.core import fmoe
    from repro_torch.launch import train
    tokens = TRAIN_BATCH * TRAIN_SEQ
    dists = {}
    if (impl, dispatch) in EP_COMBOS:
        dists["a2a"] = train.moe_dist(cfg, mesh, tokens)
        dists["psum"] = fmoe.DistConfig(mesh, ("data",))
    if (impl, dispatch) in TP_COMBOS:
        dists["tp"] = train.moe_dist(cfg, mesh, tokens, expert_tp=True)
    want = {"a2a": ("a2a", None), "psum": ("psum", None), "tp": ("a2a", "data")}
    for name, d in dists.items():
        check(d is not None and (d.mode, d.tp_axis) == want[name],
              f"EP {impl}/{dispatch}: no {name} dist ({d})")
    return dists


def needed_kernels(impl, dispatch, router="topk"):
    """The hand-written kernels a training path must launch: expert-choice
    gathers its picks on the by-destination kernel and sums their gradient
    with combine_topk, on either dispatch."""
    needed = ["fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw"] \
        if impl == "fused" else ["grouped_gemm"]
    needed += ["flash_attention_fwd", "flash_attention_bwd"]
    if router == "expert_choice":
        needed += ["gather_rows", "combine_topk"]
    elif dispatch == "ragged":
        needed += ["gather_rows_by_source", "combine_topk"]
    return needed


def ep_phase(dev):
    """Expert parallelism over a 1x1 mesh: a world-size-1 NCCL process group
    in this process (a HashStore), full-width fastmoe-gpt at TRAIN_LAYERS
    layers, 8 x 256 tokens.  At world size 1 the exchange is an identity
    (the send buffer is the sorted rows, the compaction and the capacity
    buffer unchanged), the psum mode's all-reduce too and tp's all-gather
    and reduce-scatter are copies, so for each path (``ep_dists``: a2a and
    psum for EP_COMBOS, tp for TP_COMBOS) the step-0 loss and every
    gradient leaf must equal the local path's (``dist=None``) bit for bit,
    with at most two gradient trees live; then (``ep_step_equal``) the grad
    norm and the params after one AdamW step.  Then the EP AdamW steps are
    timed against the local one in turns (EP_TIMED).  The launch counters
    are set to 0 just before each EP run and read just after; returns
    their sums per path."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    totals = {name: {k: 0 for k in counters()} for name in ("a2a", "psum", "tp")}
    try:
        mesh = make_local_mesh(1, 1)
        base = dataclasses.replace(get_config("fastmoe-gpt"),
                                   num_layers=TRAIN_LAYERS)
        data = SyntheticLM(base.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = lm.init_params(base, seed=0, device=dev,
                                param_dtype=base.param_dtype)
        n_params = sum(t.numel() for t in tree_leaves(params))

        def counted(fn, path=None):
            for f in counters().values():
                f.launches = 0
            out = fn()
            torch.cuda.synchronize()
            runs = {k: f.launches for k, f in counters().items()}
            if path is not None:
                for k, v in runs.items():
                    totals[path][k] += v
            return out, runs

        combos = list(EP_COMBOS) + [c for c in TP_COMBOS if c not in EP_COMBOS]
        for impl, dispatch in combos:
            cfg = with_dispatch(base, dispatch)
            loss_l, _, g_local = train.loss_and_grads(params, cfg, batch,
                                                      impl=impl, device=dev)
            for name, dist in ep_dists(cfg, mesh, impl, dispatch).items():
                (loss_e, _, g_ep), runs = counted(lambda: train.loss_and_grads(
                    params, cfg, batch, impl=impl, device=dev, dist=dist), name)
                pairs = list(zip(tree_leaves(g_local), tree_leaves(g_ep)))
                unequal = [i for i, (a, b) in enumerate(pairs)
                           if not torch.equal(a, b)]
                worst = max((float((a.float() - b.float()).abs().max())
                             for i, (a, b) in enumerate(pairs) if i in unequal),
                            default=0.0)
                peak = torch.cuda.max_memory_allocated(dev)
                print(f"EP {name} {impl}/{dispatch} 1x1 (NCCL, world size 1, "
                      f"token_axes {dist.token_axes}, tp_axis {dist.tp_axis}): "
                      f"step-0 loss {float(loss_e):.6f}, local "
                      f"{float(loss_l):.6f}, "
                      f"{'equal' if torch.equal(loss_l, loss_e) else 'UNEQUAL'}; "
                      f"{len(pairs) - len(unequal)} of {len(pairs)} gradient "
                      f"leaves bit-equal (max |diff| {worst:.3e}); peak memory "
                      f"with two sets of f32 grads {peak / 1e9:.2f} GB "
                      f"({n_params / 1e9:.3f} B params: "
                      f"{4 * n_params / 1e9:.1f} GB each for params and each "
                      f"set)", flush=True)
                check(torch.equal(loss_l, loss_e), f"EP {name} {impl}/{dispatch}: "
                      f"step-0 loss differs from the local path")
                check(not unequal, f"EP {name} {impl}/{dispatch}: gradient "
                                   f"leaves {unequal} differ from the local path")
                for k in needed_kernels(impl, dispatch):
                    check(runs[k] > 0, f"EP {name} {impl}/{dispatch}: kernel "
                                       f"{k} was never launched")
                for simple in SIMPLE_KERNELS:
                    check(runs[simple] == 0, f"EP {name} {impl}/{dispatch}: "
                                             f"{simple} ran at a model shape")
                del g_ep, pairs
                torch.cuda.empty_cache()
            del g_local
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        for impl, dispatch in combos:
            ep_step_equal(dev, base, mesh, batch, impl, dispatch, counted)

        opt = AdamW()
        for impl, dispatch in EP_TIMED:
            # fresh params and moments: the paths take turns on one batch
            params = lm.init_params(base, seed=0, device=dev,
                                    param_dtype=base.param_dtype)
            state = opt.init(params)
            cfg = with_dispatch(base, dispatch)
            dists = {"local": None, **ep_dists(cfg, mesh, impl, dispatch)}
            steps = {name: train.make_train_step(cfg, opt, dist=d, impl=impl,
                                                 device=dev)
                     for name, d in dists.items()}
            times = {name: [] for name in steps}
            peaks = {name: 0 for name in steps}
            per_step: dict = {}
            for step in range(1 + EP_STEPS):  # the paths in turn
                for name, step_fn in steps.items():
                    torch.cuda.reset_peak_memory_stats(dev)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    (params, state, m), runs = counted(
                        lambda: step_fn(params, state, batch, step),
                        None if name == "local" else name)
                    wall = time.perf_counter() - t0
                    loss = float(m["loss"])
                    check(math.isfinite(loss) and 3.0 < loss < 20.0,
                          f"EP timing {name} {impl}/{dispatch}: loss {loss}")
                    peaks[name] = max(peaks[name],
                                      torch.cuda.max_memory_allocated(dev))
                    if step:
                        times[name].append(wall * 1e3)
                        per_step[name] = runs
            med = {name: statistics.median(v) for name, v in times.items()}
            for name in steps:
                if name == "local":
                    continue
                launches = sum(per_step[name].values())
                print(f"EP train step {name} {impl}/{dispatch} 1x1 vs local, "
                      f"{TRAIN_LAYERS}-layer fastmoe-gpt, batch {TRAIN_BATCH}x"
                      f"{TRAIN_SEQ}, AdamW included, in turns with "
                      f"{', '.join(steps)}: {name} {med[name]:.1f} ms, local "
                      f"{med['local']:.1f} ms median of {EP_STEPS} ({name} - "
                      f"local {med[name] - med['local']:+.1f} ms; {name} "
                      + " ".join(f"{v:.1f}" for v in times[name]) + "; local "
                      + " ".join(f"{v:.1f}" for v in times["local"])
                      + f"); peak memory {name} {peaks[name] / 1e9:.2f} GB, "
                      f"local {peaks['local'] / 1e9:.2f} GB; kernel launches "
                      f"per {name} step {launches} "
                      f"({json.dumps({k: v for k, v in per_step[name].items() if v})}), "
                      f"per local step {sum(per_step['local'].values())}",
                      flush=True)
            for name, step_fn in steps.items():
                params, state = profile_ep_step(
                    f"{name} {impl}/{dispatch}", step_fn, params, state,
                    batch, 1 + EP_STEPS)
            del params, state
            torch.cuda.empty_cache()
        del opt
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    for name, total in totals.items():
        print(f"main path launches (EP training {name}, 1x1): "
              f"{json.dumps(total)}", flush=True)
    return totals


def ep_step_equal(dev, base, mesh, batch, impl, dispatch, counted):
    """One AdamW step of the local path and of each EP path of (impl,
    dispatch) at 1x1, each from a fresh init (seed 0; the EP paths' params
    made by ``lm.init_params(mesh=...)``) and fresh moments: the loss, the
    grad norm and every param after the step must equal the local step's
    bit for bit.  The local step's params wait in host memory, so the card
    holds one set of params, moments and grads at a time."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    cfg = with_dispatch(base, dispatch)
    ref = None
    for name, dist in {"local": None, **ep_dists(cfg, mesh, impl, dispatch)}.items():
        params = lm.init_params(base, seed=0, device=dev,
                                param_dtype=base.param_dtype,
                                mesh=None if dist is None else mesh,
                                expert_tp=dist is not None and dist.expert_tp)
        opt = AdamW()
        state = opt.init(params)
        step_fn = train.make_train_step(cfg, opt, dist=dist, impl=impl,
                                        device=dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        (params, state, m), runs = counted(
            lambda: step_fn(params, state, batch, 0),
            None if dist is None else name)
        print(f"EP {name} {impl}/{dispatch} 1x1 AdamW step from a fresh init: "
              f"params and moments {held / 2 ** 30:.2f} GiB, step peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 30:.2f} GiB",
              flush=True)
        leaves = tree_leaves(params)
        if ref is None:
            # detached: a copy that keeps a grad_fn keeps the param alive
            ref = (m["loss"], m["grad_norm"], [t.detach().cpu() for t in leaves])
        else:
            unequal = [i for i, (a, b) in enumerate(zip(ref[2], leaves))
                       if not torch.equal(a.to(dev, non_blocking=True), b)]
            same = (torch.equal(ref[0], m["loss"]),
                    torch.equal(ref[1], m["grad_norm"]))
            print(f"EP {name} {impl}/{dispatch} 1x1 AdamW step: loss "
                  f"{float(m['loss']):.6f} {'equal' if same[0] else 'UNEQUAL'}, "
                  f"grad norm {float(m['grad_norm']):.6f} "
                  f"{'equal' if same[1] else 'UNEQUAL'}, "
                  f"{len(leaves) - len(unequal)} of {len(leaves)} params after "
                  f"the step bit-equal to the local step's", flush=True)
            check(all(same) and not unequal,
                  f"EP {name} {impl}/{dispatch}: after one AdamW step "
                  f"(loss, norm equal: {same}) params {unequal} differ from "
                  f"the local step's")
            for k in needed_kernels(impl, dispatch):
                check(runs[k] > 0, f"EP step {name} {impl}/{dispatch}: kernel "
                                   f"{k} was never launched")
        del params, state, opt, leaves, step_fn
        torch.cuda.empty_cache()


def overlap_phase(dev):
    """The §5.2 smart schedule over a 1x1 mesh (a world-size-1 NCCL group in
    this process), full-width fastmoe-gpt at TRAIN_LAYERS layers, 8 x 256
    tokens.  For each OVERLAP_CASES (impl, dispatch, chunks), with the
    exchange decomposed (at one rank no collective: the shifts are a copy)
    and undecomposed (one async NCCL all-to-all a chunk, waited on right
    before its output is read, where a missing wait shows as a wrong
    result): the step-0 loss must equal the serial exchange's bit for bit,
    and so must every gradient leaf, but for the expert leaves of a chunked
    capacity step, which are held to OVERLAP_EXPERT_L2 (relative L2 to
    serial).  The bf16 wire at full width is the identity (the payload is
    bf16): bit-equal to serial.  The launch counters are set to 0 just
    before each chunked run and read just after.  Then the AdamW steps of
    OVERLAP_TIMED at 2 and 4 chunks (and 4 undecomposed) are timed against
    serial in turns, one chunked step profiled; the reduced f32 model's
    bf16 wire (where the cast is real) held across schedules; and the
    expert kernels timed at the chunk rows.  Returns (launches summed over
    the chunked runs, the chunk-row kernel times)."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    totals = {k: 0 for k in counters()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    try:
        mesh = make_local_mesh(1, 1)
        base = dataclasses.replace(get_config("fastmoe-gpt"),
                                   num_layers=TRAIN_LAYERS)
        data = SyntheticLM(base.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        torch.cuda.empty_cache()
        params = lm.init_params(base, seed=0, device=dev,
                                param_dtype=base.param_dtype)

        def counted(fn):
            for f in counters().values():
                f.launches = 0
            out = fn()
            torch.cuda.synchronize()
            runs = {k: f.launches for k, f in counters().items()}
            for k, v in runs.items():
                totals[k] += v
            return out, runs

        combos = list(dict.fromkeys((i, d) for i, d, _ in OVERLAP_CASES))
        for impl, dispatch in combos:
            cfg = with_dispatch(base, dispatch)
            serial = train.moe_dist(cfg, mesh, tokens)
            check(serial.mode == "a2a" and not serial.overlap_chunks,
                  f"overlap {impl}/{dispatch}: no serial a2a dist ({serial})")
            loss_s, _, g_s = train.loss_and_grads(params, cfg, batch,
                                                  impl=impl, device=dev,
                                                  dist=serial)
            variants = [(n, dec) for i, d, n in OVERLAP_CASES
                        if (i, d) == (impl, dispatch) for dec in (None, False)]
            if (impl, dispatch) == OVERLAP_TIMED:
                variants.append((0, "wire"))
            for n, dec in variants:
                dist = (serial._replace(wire_dtype="bf16") if dec == "wire"
                        else serial._replace(overlap_chunks=n, decompose=dec))
                label = ("bf16 wire (serial)" if dec == "wire" else
                         f"{n} chunks {'undecomposed' if dec is False else 'decomposed'}")
                (loss_c, _, g_c), runs = counted(lambda: train.loss_and_grads(
                    params, cfg, batch, impl=impl, device=dev, dist=dist))
                paths = [p for p, _ in leaf_paths(g_c)]
                pairs = list(zip(tree_leaves(g_c), tree_leaves(g_s)))
                expert = {i for i, p in enumerate(paths) if "/experts/" in p}
                check(len(expert) == 2 * TRAIN_LAYERS,
                      f"overlap: {len(expert)} expert gradient leaves")
                unequal = {i for i, (a, b) in enumerate(pairs)
                           if not torch.equal(a, b)}
                dists = _grad_dists(*zip(*pairs))
                worst = max(dists[i] for i in expert)
                may_differ = (expert if dispatch == "capacity" and dec != "wire"
                              else set())
                print(f"overlap {impl}/{dispatch} 1x1 {label}: step-0 loss "
                      f"{float(loss_c):.6f}, serial {float(loss_s):.6f}, "
                      f"{'equal' if torch.equal(loss_c, loss_s) else 'UNEQUAL'}; "
                      f"{len(pairs) - len(unequal)} of {len(pairs)} gradient "
                      f"leaves bit-equal (rule: all but the "
                      f"{len(may_differ)} expert leaves of chunked capacity); "
                      f"expert leaves' relative L2 to serial max {worst:.2e} "
                      f"(rule: <= {OVERLAP_EXPERT_L2}); launches "
                      f"{json.dumps({k: v for k, v in runs.items() if v})}",
                      flush=True)
                check(torch.equal(loss_c, loss_s), f"overlap {impl}/{dispatch} "
                      f"{label}: step-0 loss differs from the serial exchange")
                check(unequal <= may_differ, f"overlap {impl}/{dispatch} "
                      f"{label}: gradient leaves differ from serial's: "
                      f"{[paths[i] for i in sorted(unequal - may_differ)]}")
                check(worst <= OVERLAP_EXPERT_L2, f"overlap {impl}/{dispatch} "
                      f"{label}: expert gradients {worst:.2e} from serial's")
                for k in needed_kernels(impl, dispatch):
                    check(runs[k] > 0, f"overlap {impl}/{dispatch} {label}: "
                                       f"kernel {k} was never launched")
                for simple in SIMPLE_KERNELS:
                    check(runs[simple] == 0, f"overlap {impl}/{dispatch}: "
                                             f"{simple} ran at a model shape")
                del g_c, pairs
                torch.cuda.empty_cache()
            del g_s
            torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        overlap_times(dev, base, mesh, batch)
        small_wire_check(dev, mesh)
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    print(f"main path launches (EP training overlap, 1x1): {json.dumps(totals)}",
          flush=True)
    return totals, chunk_kernel_times(dev)


def overlap_times(dev, base, mesh, batch):
    """OVERLAP_TIMED's AdamW steps, serial and at 2 and 4 chunks (4 also
    undecomposed), in turns on one set of params and moments: medians of
    EP_STEPS after a warm step, and one profiled step each of serial and 4
    chunks."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW

    impl, dispatch = OVERLAP_TIMED
    cfg = with_dispatch(base, dispatch)
    serial = train.moe_dist(cfg, mesh, TRAIN_BATCH * TRAIN_SEQ)
    dists = {"serial": serial,
             "2 chunks": serial._replace(overlap_chunks=2),
             "4 chunks": serial._replace(overlap_chunks=4),
             "4 chunks undecomposed": serial._replace(overlap_chunks=4,
                                                      decompose=False)}
    params = lm.init_params(base, seed=0, device=dev,
                            param_dtype=base.param_dtype)
    opt = AdamW()
    state = opt.init(params)
    steps = {name: train.make_train_step(cfg, opt, dist=d, impl=impl,
                                         device=dev)
             for name, d in dists.items()}
    times = {name: [] for name in steps}
    for step in range(1 + EP_STEPS):  # the paths in turn
        for name, step_fn in steps.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step_fn(params, state, batch, step)
            loss = float(m["loss"])
            wall = time.perf_counter() - t0
            check(math.isfinite(loss) and 3.0 < loss < 20.0,
                  f"overlap timing {name}: loss {loss}")
            if step:
                times[name].append(wall * 1e3)
    med = {name: statistics.median(v) for name, v in times.items()}
    for name in steps:
        if name == "serial":
            continue
        print(f"overlap train step {impl}/{dispatch} 1x1 {name} vs serial, "
              f"{TRAIN_LAYERS}-layer fastmoe-gpt, batch {TRAIN_BATCH}x"
              f"{TRAIN_SEQ}, AdamW included, in turns with {', '.join(steps)}: "
              f"{name} {med[name]:.1f} ms, serial {med['serial']:.1f} ms "
              f"median of {EP_STEPS} ({name} - serial "
              f"{med[name] - med['serial']:+.1f} ms; {name} "
              + " ".join(f"{v:.1f}" for v in times[name]) + "; serial "
              + " ".join(f"{v:.1f}" for v in times["serial"]) + ")",
              flush=True)
    for name in ("serial", "4 chunks", "4 chunks undecomposed"):
        params, state = profile_ep_step(f"overlap {name} {impl}/{dispatch}",
                                        steps[name], params, state, batch,
                                        1 + EP_STEPS)
    del params, state
    torch.cuda.empty_cache()


def small_wire_check(dev, mesh):
    """The bf16 wire where the cast is real: the reduced f32 model (2
    layers, remat on), fused, both dispatches, over the 1x1 NCCL mesh.  The
    wire's step-0 loss is the same, bit for bit, serial, at 2 chunks
    decomposed (no collective: the casts alone) and undecomposed (an NCCL
    all-to-all of bf16 a chunk); it differs from the f32 wire's loss by
    more than 0 and at most WIRE_ATOL; its gradients are finite."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    base = dataclasses.replace(reduced(get_config("fastmoe-gpt"), num_layers=2,
                                       d_model=256), remat="full")
    tokens = torch.from_numpy(next(SyntheticLM(base.vocab_size, 32, seed=0)
                                   .batches(4))["tokens"]).to(dev)
    for dispatch in ("capacity", "ragged"):
        cfg = with_dispatch(base, dispatch)
        params = lm.init_params(cfg, seed=0, device=dev,
                                param_dtype=cfg.param_dtype)
        serial = train.moe_dist(cfg, mesh, 4)
        loss32, _, _ = train.loss_and_grads(params, cfg, {"tokens": tokens},
                                            impl="fused", device=dev,
                                            dist=serial)
        wire = serial._replace(wire_dtype="bf16")
        losses = []
        for d in (wire, wire._replace(overlap_chunks=2),
                  wire._replace(overlap_chunks=2, decompose=False)):
            loss, _, grads = train.loss_and_grads(
                params, cfg, {"tokens": tokens}, impl="fused", device=dev,
                dist=d)
            check(all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads)),
                  f"bf16 wire {dispatch}: gradients not finite")
            losses.append(loss)
        diff = abs(float(losses[0]) - float(loss32))
        same = all(torch.equal(v, losses[0]) for v in losses)
        print(f"bf16 wire, reduced f32 fastmoe-gpt fused/{dispatch} 1x1: loss "
              f"{float(losses[0]):.7f} (serial, 2 chunks, 2 chunks "
              f"undecomposed {'bit-equal' if same else 'UNEQUAL'}), f32 wire "
              f"{float(loss32):.7f}, |diff| {diff:.3e} (0 < diff <= "
              f"{WIRE_ATOL})", flush=True)
        check(same, f"bf16 wire {dispatch}: schedules give different losses")
        check(0 < diff <= WIRE_ATOL, f"bf16 wire {dispatch}: |loss - f32 "
                                     f"wire's| {diff:.3e}")


def chunk_kernel_times(dev):
    """The expert kernels at the §5.2 schedule's chunk rows: fastmoe-gpt's
    96 x 56 capacity buffer (bf16, gelu, H 2048) whole and cut into chunks
    of 28 and 14 rows an expert, launched with the whole buffer's hidden
    split (``plan_rows``): the fused FFN forward, its dX and dW, and the
    grouped GEMM (x @ wi), each timed by events (L2 flushed) beside its
    bound, its plain version and, for the grouped GEMM,
    torch._grouped_mm.  A chunk's forward, dX and grouped GEMM rows must
    equal the whole launch's bit for bit (the row tile changes, a row's
    arithmetic does not)."""
    import torch
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_ffn_bwd as fb
    from repro_torch.kernels import grouped_gemm as gg

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)
    M0 = E * CAP_ROWS
    x, dy = randn(M0, D), randn(M0, D)
    wi, wo = randn(E, D, H, scale=D ** -0.5), randn(E, H, D, scale=H ** -0.5)
    ws, b = (wi,), 2
    whole = {"fused_ffn": ff.fused_ffn(x, ws, wo, torch.full(
                 (E,), CAP_ROWS, dtype=torch.int32, device=dev), "gelu"),
             "fused_ffn_bwd_dx": fb.fused_ffn_bwd_dx(x, ws, wo, dy, torch.full(
                 (E,), CAP_ROWS, dtype=torch.int32, device=dev), "gelu"),
             "grouped_gemm": gg.grouped_gemm(x, wi, torch.full(
                 (E,), CAP_ROWS, dtype=torch.int32, device=dev))}
    timed = {}
    for rows in (CAP_ROWS, *CHUNK_ROWS):
        M = E * rows
        gs = torch.full((E,), rows, dtype=torch.int32, device=dev)

        def cut(t):
            return t.view(E, CAP_ROWS, -1)[:, :rows].reshape(M, -1)
        xc, dyc = cut(x), cut(dy)
        p = ff.plan(M, E, H, split_rows=M0)
        wbytes = E * 2 * D * H * b
        cases = {
            "fused_ffn": (lambda: ff.fused_ffn(xc, ws, wo, gs, "gelu", M0),
                          lambda: ff.fused_ffn_plain(xc, ws, wo, gs, "gelu"),
                          b * 2 * M * D + wbytes + 4 * E, 4 * M * D * H, None),
            "fused_ffn_bwd_dx": (
                lambda: fb.fused_ffn_bwd_dx(xc, ws, wo, dyc, gs, "gelu", M0),
                lambda: fb.fused_ffn_bwd_dx_plain(xc, ws, wo, dyc, gs, "gelu"),
                b * 3 * M * D + wbytes + 4 * E, 6 * M * D * H, None),
            "fused_ffn_bwd_dw": (
                lambda: fb.fused_ffn_bwd_dw(xc, ws, wo, dyc, gs, "gelu"),
                lambda: fb.fused_ffn_bwd_dw_plain(xc, ws, wo, dyc, gs, "gelu"),
                b * 2 * M * D + wbytes + 4 * 2 * E * D * H + 4 * E,
                8 * M * D * H, None),
            "grouped_gemm": (
                lambda: gg.grouped_gemm(xc, wi, gs),
                lambda: gg.grouped_gemm_plain(xc, wi, gs),
                b * (M * D + E * D * H + M * H) + 4 * E, 2 * M * D * H,
                grouped_mm_call(xc, wi, torch.cumsum(gs, 0).to(torch.int32))),
        }
        for name, want in whole.items():
            got = cases[name][0]()
            torch.cuda.synchronize()
            check(torch.equal(got, cut(want)), f"{name} at {E} x {rows} chunk "
                  f"rows differs from the whole {E} x {CAP_ROWS} launch's rows")
            del got
        # dW sums over a chunk's rows: held to its plain version instead
        dws, dwo = cases["fused_ffn_bwd_dw"][0]()
        rws, rwo = cases["fused_ffn_bwd_dw"][1]()
        tag, dw_err = f"fused_ffn_bwd_dw at {E} x {rows} chunk rows", 0.0
        for a, r in zip((*dws, dwo), (*rws, rwo)):
            dw_err = max(dw_err, close(tag, a, r, DW_TOL["bfloat16"]))
            frobenius(tag, a, r, DW_FRO)
        del dws, dwo, rws, rwo
        for name, (kern, plain, nbytes, flops, lib) in cases.items():
            ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush, 3)
            dev_ms = device_ms(kern, floor=device_floor(nbytes, flops, "bfloat16"),
                               what=f"{name} chunk {E}x{rows}")
            lib_ms = time_ms(lib, flush) if lib is not None else None
            b_ms, b_by = bound(nbytes, flops, "bfloat16")
            timed[(name, rows)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                       bound_ms=b_ms, bound_by=b_by,
                                       library_ms=lib_ms)
            err = (f"  max |err| vs plain {dw_err:.3e} (DW_TOL, DW_FRO)"
                   if name == "fused_ffn_bwd_dw" else "")
            print(f"kernel {name} chunk {E}x{rows} bf16 (of {E}x{CAP_ROWS}; "
                  f"fused plan bm {p.bm} hc {p.hc} splits {p.splits}): "
                  f"{ms:.4f} ms  device {dev_ms:.4f} ms  bound {b_ms:.4f} ms "
                  f"({b_by}, {nbytes / 1e6:.0f} MB, {flops / 1e9:.1f} GFLOP, "
                  f"{ms / b_ms:.2f}x bound)  plain {plain_ms:.4f} ms  library "
                  f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}{err}",
                  flush=True)
    del flush
    torch.cuda.empty_cache()
    return timed


# per-rank init: (data, model, expert_tp, rank) shards of full 12-layer
# fastmoe-gpt held against the whole init's slices
INIT_SHARDS = tuple((1, 4, False, r) for r in range(4)) + ((2, 4, True, 6),)


def init_phase(dev):
    """Per-rank init of full 12-layer fastmoe-gpt in f32 (4.986 B params,
    ~19.9 GB): the whole from seed 0, then each INIT_SHARDS rank's own
    shard (``lm.init_params(mesh=Mesh(data, model, rank))``, a mesh without
    process groups), which must equal ``interop.shard_params`` of the
    whole bit for bit: the 4 model ranks of a 1x4 mesh, and rank (1, 2) of
    a 2x4 mesh under expert-internal tensor parallelism.  Prints each
    init's time and the peak memory it added."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.core.sync import tagged_leaves
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import lm

    cfg = get_config("fastmoe-gpt")
    torch.cuda.empty_cache()

    def timed_init(**kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        p = lm.init_params(cfg, seed=0, device=dev,
                           param_dtype=cfg.param_dtype, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = sum(t.numel() for _, t in tagged_leaves(p))
        return p, n, secs, torch.cuda.max_memory_allocated(dev) - base

    whole, n_whole, secs, peak = timed_init()
    draws = cfg.num_layers * cfg.moe.num_experts * 2
    print(f"init fastmoe-gpt {cfg.num_layers} layers f32, whole: "
          f"{n_whole / 1e9:.3f} B params, {secs:.3f} s ({draws} expert draws), "
          f"peak memory {peak / 1e9:.2f} GB", flush=True)
    for data, model, tp, rank in INIT_SHARDS:
        mesh = Mesh(data, model, rank)
        shard, n, secs, peak = timed_init(mesh=mesh, expert_tp=tp)
        shard = dict(tagged_leaves(shard))
        want = dict(tagged_leaves(interop.shard_params(whole, mesh,
                                                       expert_tp=tp)))
        check(shard.keys() == want.keys(), f"init shard {mesh}: leaves differ")
        unequal = [k for k in shard if not torch.equal(shard[k], want[k])]
        print(f"init fastmoe-gpt shard {data}x{model} rank {mesh.coords()} "
              f"{'(expert tp) ' if tp else ''}: {n / 1e9:.3f} B params, "
              f"{secs:.3f} s, peak memory {peak / 1e9:.2f} GB; "
              f"{len(shard) - len(unequal)} of {len(shard)} leaves bit-equal "
              f"to the whole init's slices", flush=True)
        check(not unequal, f"init shard {mesh} tp={tp}: leaves {unequal} "
                           f"differ from the whole's slices")
        del shard, want
        torch.cuda.empty_cache()
    del whole
    torch.cuda.empty_cache()


def profile_ep_step(label, step_fn, params, state, batch, step):
    """One train step under torch.profiler: wall, kernel time and busy
    share, CUDA launches (all, and NCCL's with their device time), host
    syncs, and the host ops with the most self time."""
    with profiled() as p:
        params, state, _ = step_fn(params, state, batch, step)
    wall, busy, kernels, prof = p["wall"], p["busy"], p["kernels"], p["prof"]
    events = prof.events()
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    syncs = sum(1 for e in events if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy"))
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    print(f"profile EP-phase step {label} (profiler on): wall "
          f"{wall * 1e3:.1f} ms, kernels {busy:.1f} ms "
          f"({100 * busy / (wall * 1e3):.1f}% busy), {len(kernels)} kernel "
          f"launches, of them {len(nccl)} NCCL "
          f"({sum(e.device_time for e in nccl) / 1e3:.2f} ms device), {syncs} "
          f"host syncs; {p['capture']}; host self time: "
          + "; ".join(f"{a.key[:40]} {a.self_cpu_time_total / 1e3:.1f} ms "
                      f"x{a.count}" for a in host[:8]), flush=True)
    return params, state


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
            if (impl, dispatch) == ("fused", "ragged"):
                gather_routes_agree(params, cfg, batch, dev, loss, grads)
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


@contextlib.contextmanager
def gather_by_destination():
    """The ragged dispatch's gather on the per-destination kernel, its
    gradient summing each token's rows in row order: the route before the
    plan carried slot_rows."""
    from repro_torch.core import dispatch as Dsp
    from repro_torch.kernels import ops
    by_source = Dsp.dispatch_ragged
    Dsp.dispatch_ragged = lambda x, plan: ops.gather_tokens(x, plan.token_rows)
    try:
        yield
    finally:
        Dsp.dispatch_ragged = by_source


def gather_routes_agree(params, cfg, batch, dev, loss, grads):
    """fastmoe-gpt's step-0 loss and every gradient leaf through the
    source-major gather (slot order) equal the per-destination route's (row
    order) bit for bit: k = 2, so a token's two rows add alike in either
    order."""
    import torch
    from repro_torch.kernels import token_shuffle as ts
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves
    before = ts.gather_rows_by_source.launches
    with gather_by_destination():
        loss_d, _, grads_d = train.loss_and_grads(params, cfg, batch,
                                                  impl="fused", device=dev)
    check(ts.gather_rows_by_source.launches == before,
          "the per-destination reference ran the source-major gather")
    pairs = list(zip(tree_leaves(grads), tree_leaves(grads_d)))
    equal = sum(torch.equal(a, b) for a, b in pairs)
    print(f"grads fused/ragged, source-major gather vs per destination: "
          f"loss {'equal' if torch.equal(loss, loss_d) else 'UNEQUAL'}, "
          f"{equal} of {len(pairs)} gradient leaves bit-equal", flush=True)
    check(torch.equal(loss, loss_d) and equal == len(pairs),
          "fused/ragged step-0 gradients differ between the gather routes")


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
    from repro_torch.launch import serve
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
    logits_within_floor(f"starcoder2-15b 2 layers, 1x{SC2_PROMPT}", oracle,
                        {"plain bf16": plain, "kernel bf16": kern},
                        SC2_REL_SLACK, 0.0, SC2_AGREE_SLACK)
    del oracle, plain, kern
    cache_len = serve.cache_len_for(cfg, SC2_PROMPT + SC2_GEN)
    profile_prefill(params, cfg, dev, SC2_BATCH, SC2_PROMPT, cache_len)
    del params
    torch.cuda.empty_cache()


def profile_prefill(params, cfg, dev, batch, prompt, cache_len,
                    impl="fused"):
    """One prefill (batch x prompt into a cache of cache_len) under
    torch.profiler, after one warm-up: wall time, summed kernel time (the
    device's busy share), the flash forward's part of it, and the top
    kernels."""
    import torch
    from repro_torch.models import lm
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    with torch.no_grad():
        cache = lm.init_cache(cfg, batch, cache_len, device=dev)
        lm.prefill(params, cfg, tokens, cache, impl=impl, device=dev)  # warm
        del cache
        cache = lm.init_cache(cfg, batch, cache_len, device=dev)
        with profiled() as p:
            lm.prefill(params, cfg, tokens, cache, impl=impl, device=dev)
        del cache
    wall, busy, by_name, kernels = p["wall"], p["busy"], p["by_name"], p["kernels"]
    flash = sum(t for n, t in by_name.items() if "flash_fwd" in n)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile {cfg.name} prefill {impl}/{getattr(cfg.moe, 'dispatch', '-')}, "
          f"{cfg.num_layers} layers, {batch}x{prompt} (profiler on): wall "
          f"{wall * 1e3:.1f} ms, "
          f"kernels {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}% busy), "
          f"{len(kernels)} kernel launches; {p['capture']}; flash forward "
          f"{flash:.2f} ms "
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


# ---------------------------------------------------------------------------
# deepseek-v2-236b: MLA serving at full width, cut in depth
# ---------------------------------------------------------------------------

# 4 of the 60 layers: a layer is 3.97 B params (7.94 GB in bf16; its
# routed experts 3.78 B), the f32 embedding and head 4.19 GB, and
# init_params builds each layer in f32 (15.9 GB) before the cast, so 4
# layers peak at ~52 GB before activations and 6 at ~68 GB.
DS_LAYERS, DS_BATCH, DS_PROMPT, DS_GEN, DS_CACHE = 4, 2, 4096, 32, 4160
DS_LOGIT_LAYERS, DS_LOGIT_BATCH, DS_LOGIT_PROMPT = 2, 2, 256
DS_COMBOS = (("fused", "ragged"), ("pallas", "capacity"))  # headline first


def deepseek_logits_phase(dev):
    """deepseek-v2-236b at full width cut to 2 layers, a 2 x 256 prompt:
    the bf16 kernel paths' logits (DS_COMBOS: fused/ragged and
    pallas/capacity, MLA prefill on the flash kernels at dk 192, dv 128)
    each against an f32 oracle on the card of its own dispatch (capacity
    drops tokens), the plain einsum experts and plain attention on the same
    weights (each layer cast to f32 at use), within the bf16 plain path's
    own distance to it (SERVE_*: near-tied expert scores switch under bf16
    rounding)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import lm

    base = dataclasses.replace(get_config("deepseek-v2-236b"),
                               num_layers=DS_LOGIT_LAYERS)
    params = lm.init_params(base, seed=0, device=dev)
    tokens = torch.randint(0, base.vocab_size, (DS_LOGIT_BATCH, DS_LOGIT_PROMPT),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(4))
    for impl, dispatch in DS_COMBOS:
        cfg = with_dispatch(base, dispatch)
        with torch.no_grad():
            with plain_attention():
                oracle = lm.forward(params, dataclasses.replace(cfg, dtype="float32"),
                                    tokens, impl="einsum", device=dev)[0]
                plain = lm.forward(params, cfg, tokens, impl="einsum", device=dev)[0]
            before = fa.flash_attention_fwd.launches
            kern = lm.forward(params, cfg, tokens, impl=impl, device=dev)[0]
            torch.cuda.synchronize()
        check(fa.flash_attention_fwd.launches - before == cfg.num_layers,
              f"deepseek {impl}/{dispatch} forward did not run the flash kernel "
              f"once a layer")
        check(oracle.shape == (DS_LOGIT_BATCH, DS_LOGIT_PROMPT, cfg.vocab_size),
              f"deepseek logits of shape {tuple(oracle.shape)}")
        logits_within_floor(
            f"deepseek-v2-236b {cfg.num_layers} layers, {DS_LOGIT_BATCH}x"
            f"{DS_LOGIT_PROMPT}, {dispatch}", oracle,
            {"plain bf16": plain, f"kernel bf16 {impl}/{dispatch}": kern},
            SERVE_REL_SLACK, SERVE_ABS_SLACK, SERVE_AGREE_SLACK)
        del oracle, plain, kern
    del params
    torch.cuda.empty_cache()


def deepseek_serve_phase(dev):
    """deepseek-v2-236b at full width, DS_LAYERS of 60 layers (bf16 layers,
    f32 embed and head, weights from seed 0), served greedily: DS_BATCH
    prompts of DS_PROMPT tokens (MLA prefill through the flash kernels at
    dk 192, dv 128), then DS_GEN absorbed-form decode steps against a
    DS_CACHE-slot latent cache, for DS_COMBOS, with the launch counters set
    to 0 just before and read just after; then one profiled prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    base = dataclasses.replace(get_config("deepseek-v2-236b"), num_layers=DS_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated(dev)
    leaves = tree_leaves(params)
    n = sum(t.numel() for t in leaves)
    wbytes = sum(t.numel() * t.element_size() for t in leaves)
    print(f"deepseek-v2-236b, {DS_LAYERS} of 60 layers: {n / 1e9:.3f} B params "
          f"({wbytes / 1e9:.2f} GB: layers bf16, embed/head f32) made from "
          f"seed 0 in {time.perf_counter() - t0:.1f} s, peak {init_peak / 1e9:.2f} "
          f"GB while made", flush=True)
    prompt = torch.randint(0, base.vocab_size, (DS_BATCH, DS_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    for impl, dispatch in DS_COMBOS:  # warm-up: first-call costs out of the timing
        serve.generate(params, with_dispatch(base, dispatch), prompt[:, :256], 2,
                       impl=impl, cache_len=272, device=dev)
    torch.cuda.synchronize()

    # ---- the main path: counters at 0 just before, read just after
    for fn in counters().values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    results = {}
    for impl, dispatch in DS_COMBOS:
        timings: dict = {}
        seq = serve.generate(params, with_dispatch(base, dispatch), prompt, DS_GEN,
                             impl=impl, cache_len=DS_CACHE, device=dev,
                             timings=timings)
        check(seq.shape == (DS_BATCH, DS_PROMPT + DS_GEN), f"shape {seq.shape}")
        check(bool(((seq >= 0) & (seq < base.vocab_size)).all()), "bad tokens")
        check(torch.equal(seq[:, :DS_PROMPT], prompt), "prompt not kept")
        results[(impl, dispatch)] = (seq, timings)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (deepseek-v2 serving): {json.dumps(launches)}",
          flush=True)
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was never launched on the deepseek serving path")
    for simple in SIMPLE_KERNELS:
        check(launches[simple] == 0,
              f"the deepseek serving path ran {simple} at a model shape")
    check(launches["flash_attention_fwd"] == DS_LAYERS * len(DS_COMBOS),
          f"flash_attention_fwd launched {launches['flash_attention_fwd']} "
          f"times in {len(DS_COMBOS)} {DS_LAYERS}-layer prefills")
    a = base.attention
    scores = DS_BATCH * DS_PROMPT * a.num_heads * DS_PROMPT * 4
    check(peak - wbytes < scores, f"prefill peak {peak / 1e9:.2f} GB holds a "
                                  f"score matrix ({scores / 1e9:.1f} GB)")
    cache_bytes = DS_LAYERS * DS_BATCH * DS_CACHE * (a.kv_lora_rank
                                                     + a.qk_rope_head_dim) * 2
    for (impl, dispatch), (seq, t) in results.items():
        dec = statistics.median(t["decode_s"])
        print(f"serve deepseek-v2-236b {impl}/{dispatch}: prefill {DS_BATCH}x"
              f"{DS_PROMPT} {t['prefill_s'] * 1e3:.2f} ms "
              f"({DS_BATCH * DS_PROMPT / t['prefill_s']:.0f} tok/s); decode "
              f"{dec * 1e3:.3f} ms/step median over {len(t['decode_s'])} "
              f"({DS_BATCH / dec:.1f} tok/s), latent cache {DS_CACHE} slots "
              f"({cache_bytes / 1e6:.1f} MB over {DS_LAYERS} layers)", flush=True)
    ref_seq = results[DS_COMBOS[0]][0]
    for key, (seq, _) in results.items():
        agree = (seq[:, DS_PROMPT:] == ref_seq[:, DS_PROMPT:]).float().mean().item()
        print(f"deepseek generated tokens equal to {'/'.join(DS_COMBOS[0])}: "
              f"{key[0]}/{key[1]} {agree:.3f}")
    print(f"deepseek serving peak memory {peak / 2 ** 30:.2f} GiB "
          f"({peak / 1e9:.2f} GB: weights {wbytes / 1e9:.2f} GB + "
          f"{(peak - wbytes) / 1e9:.2f} GB, where one layer's f32 scores would "
          f"be {scores / 1e9:.1f} GB)", flush=True)
    del results, seq, ref_seq
    profile_prefill(params, with_dispatch(base, "ragged"), dev, DS_BATCH,
                    DS_PROMPT, DS_CACHE)
    profile_step(params, with_dispatch(base, "ragged"), prompt, "fused",
                 DS_CACHE, dev)

    # ---- continuous batching, fused/ragged: the paged latent pool against
    # the ring, each a main path of its own
    from repro_torch.launch.serve_api import ServeConfig
    cfg = with_dispatch(base, "ragged")
    kw = dict(prompt_len=DSC_PROMPT, gen=DSC_GEN)
    serve.serve_continuous(params, cfg, ServeConfig(  # warm-up
        slots=2, block_size=DSC_BLOCK, max_len=DSC_MAX_LEN),
        prompt_len=DSC_PROMPT, gen=2, num_requests=2, impl="fused",
        device=dev)
    cont = {}
    for paged in (True, False):
        scfg = ServeConfig(slots=DSC_SLOTS, block_size=DSC_BLOCK,
                           max_len=DSC_MAX_LEN, paged=paged)
        cont[paged] = run_continuous(
            f"fused/ragged {'paged' if paged else 'ring'}", params, cfg, scfg,
            "fused", dev, requests=DSC_REQUESTS, **kw)
    check(cont[True][0] == cont[False][0],
          "deepseek fused/ragged: paged tokens differ from the ring's")
    print(f"continuous deepseek-v2-236b paged vs ring: tokens bit-equal; "
          f"{cont[True][1]['tok_s']:.1f} vs {cont[False][1]['tok_s']:.1f} tok/s, "
          f"per-token p50 {cont[True][1]['token_p50'] * 1e3:.2f} vs "
          f"{cont[False][1]['token_p50'] * 1e3:.2f} ms", flush=True)
    race = {name: filled(params, cfg, ServeConfig(
        slots=DSC_SLOTS, block_size=DSC_BLOCK, max_len=DSC_MAX_LEN,
        paged=paged), "fused", dev, **kw)
        for name, paged in (("paged", True), ("ring", False))}
    tick_race("deepseek-v2-236b fused/ragged", race)
    per_tick = profile_tick("fused/ragged paged", race["paged"])
    del race
    cont_launches = {k: cont[True][2][k] + cont[False][2][k] for k in launches}
    print(f"deepseek serve phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    del params, prompt
    torch.cuda.empty_cache()
    return launches, cont_launches, per_tick


# ---------------------------------------------------------------------------
# The routing zoo, the five configs of slice 13, deepseek-v2 training
# ---------------------------------------------------------------------------

# (router, dispatch) on 10-layer fastmoe-gpt, each in ROUTER_IMPLS: the
# exploration routers and frozen on the ragged headline, expert-choice on
# both dispatches; frozen last, so its timed step follows the distilling
# ones (w_frozen trained by the noisy_topk and gumbel steps)
ROUTER_CASES = (("noisy_topk", "ragged"), ("gumbel", "ragged"),
                ("expert_choice", "capacity"), ("expert_choice", "ragged"),
                ("frozen", "ragged"))
ROUTER_IMPLS = ("fused", "pallas")
ROUTER_STEPS = 2  # timed AdamW steps a case, after a warm one
ROUTER_ORACLE_LAYERS = 2  # the gradient oracle's depth, as grad_oracle_phase
# switch-base-128: served whole (12 layers, 7.3 B params in bf16), trained
# cut to 4 layers (f32 params, grads, AdamW moments: 16 B a param, ~39 GB)
SWITCH_TRAIN_LAYERS = 4
# arctic-480b: 2 of 35 layers (a layer's 128 experts are 13.4 B params,
# 26.8 GB in bf16), 2 x 2048 prompts, 16 decode steps
ARCTIC_LAYERS, ARCTIC_BATCH, ARCTIC_PROMPT, ARCTIC_GEN = 2, 2, 2048, 16
# the dense configs: (name, layers or None for all), 2 x 2048, 16 steps;
# qwen2-72b at 24 of 80 layers (1.76 GB a layer in bf16, ~10 GB of f32
# embed and head)
DENSE_RUNS = (("smollm-360m", None), ("granite-3-2b", None),
              ("qwen2-72b", 24))
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 2, 2048, 16
# deepseek-v2-236b training: every width (d 5120, MLA (192, 128), expert
# hidden 1536, top-6, 2 shared), 2 of 60 layers and 32 of 160 routed
# experts: 2.95 B params, 47 GB at 16 B a param
DS_TRAIN_LAYERS, DS_TRAIN_EXPERTS = 2, 32
DS_TRAIN_BATCH, DS_TRAIN_SEQ = 4, 512
DS_TRAIN_STEPS = 2


def with_router(cfg, router, dispatch, **kw):
    return dataclasses.replace(cfg, **kw, moe=dataclasses.replace(
        cfg.moe, router=router, dispatch=dispatch))


def grads_within_floor(label, params, cfg, batch, dev, paths, seed=None):
    """One step's gradients of each kernel path (``paths``: impls) against
    the f32 einsum oracle on the same weights, held to the bf16 einsum
    path's own distance (GRAD_*); the oracle and the bf16 einsum path run
    the plain attention.  ``seed``: the routers' exploration seed, the same
    draw on every path.  Returns the kernel paths' launch counts."""
    import torch
    from repro_torch.launch import train

    kw = dict(device=dev, router_seed=seed)
    with plain_attention():
        loss_o, _, oracle = train.loss_and_grads(
            params, dataclasses.replace(cfg, dtype="float32"), batch,
            impl="einsum", **kw)
    floor, launches = None, {}
    for impl in ("einsum", *paths):
        for fn in counters().values():
            fn.launches = 0
        with plain_attention() if impl == "einsum" else contextlib.nullcontext():
            loss, _, grads = train.loss_and_grads(params, cfg, batch,
                                                  impl=impl, **kw)
        torch.cuda.synchronize()
        if impl != "einsum":
            launches[impl] = {k: fn.launches for k, fn in counters().items()}
        d = _grad_dists(grads, oracle)
        del grads
        med, worst = statistics.median(d), max(d)
        print(f"grads {label} {impl} bf16 vs f32 einsum oracle: per-leaf "
              f"relative L2 median {med:.4f} max {worst:.4f} over {len(d)} "
              f"leaves; loss {float(loss):.4f} (oracle {float(loss_o):.4f})",
              flush=True)
        check(math.isfinite(float(loss)), f"{label} {impl}: loss {loss}")
        if floor is None:
            floor = (med, worst)
            continue
        check(med <= GRAD_REL_SLACK * floor[0] + GRAD_MED_SLACK
              and worst <= GRAD_REL_SLACK * floor[1] + GRAD_MAX_SLACK,
              f"{label} {impl} gradients further from the f32 oracle than "
              f"the bf16 einsum path (floor {floor})")
    del oracle
    torch.cuda.empty_cache()
    return launches


def router_phase(dev):
    """The routing zoo on full-width fastmoe-gpt (8 x 256 tokens), every
    ROUTER_CASES x ROUTER_IMPLS: (1) at ROUTER_ORACLE_LAYERS layers, the
    gradients against the f32 oracle (``grads_within_floor``); (2) at
    TRAIN_LAYERS layers, the step-0 loss and every gradient leaf of the
    local path (the main path: counters at 0 just before, read just
    after) equal to a second run's and to the a2a and psum paths' over a
    1x1 NCCL mesh, bit for bit; (3) AdamW steps of each, timed.  One param
    tree (noisy_topk's, which carries w_noise and w_frozen) serves every
    router; a router leaves the leaves it does not read at a zero
    gradient.  The exploration routers draw from the train step's seed."""
    import torch
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.core import fmoe
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    base = dataclasses.replace(get_config("fastmoe-gpt"), num_layers=TRAIN_LAYERS)
    data = SyntheticLM(base.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
    batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
    seed = fmoe.expert_seed(17, 0, 0)  # the train step's draw at step 0
    small = with_router(base, "noisy_topk", "ragged",
                        num_layers=ROUTER_ORACLE_LAYERS)
    params = lm.init_params(small, seed=0, device=dev, param_dtype="float32")
    for router, dispatch in ROUTER_CASES:
        grads_within_floor(f"{router} {dispatch} ({ROUTER_ORACLE_LAYERS} "
                           f"layers, full width)", params,
                           with_router(small, router, dispatch), batch, dev,
                           ROUTER_IMPLS, seed)
    del params
    torch.cuda.empty_cache()

    launches = {}
    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        mesh = make_local_mesh(1, 1)
        params = lm.init_params(with_router(base, "noisy_topk", "ragged"),
                                seed=0, device=dev, param_dtype="float32")
        for router, dispatch in ROUTER_CASES:
            cfg = with_router(base, router, dispatch)
            for impl in ROUTER_IMPLS:
                label = f"{router} {impl}/{dispatch}"
                kw = dict(impl=impl, device=dev, router_seed=seed)
                for fn in counters().values():
                    fn.launches = 0
                loss, _, ref = train.loss_and_grads(params, cfg, batch, **kw)
                torch.cuda.synchronize()
                runs = {k: fn.launches for k, fn in counters().items()}
                launches[label] = runs
                for k in needed_kernels(impl, dispatch, router):
                    check(runs[k] > 0, f"router {label}: kernel {k} was never "
                                       f"launched")
                for simple in SIMPLE_KERNELS:
                    check(runs[simple] == 0, f"router {label}: {simple} ran at "
                                             f"a model shape")
                verdicts = []
                for name, dist in (("again", None),
                                   ("a2a", train.moe_dist(
                                       cfg, mesh, TRAIN_BATCH * TRAIN_SEQ)),
                                   ("psum", fmoe.DistConfig(mesh, ("data",)))):
                    loss_e, _, g = train.loss_and_grads(params, cfg, batch,
                                                        dist=dist, **kw)
                    pairs = list(zip(tree_leaves(ref), tree_leaves(g)))
                    equal = sum(torch.equal(a, b) for a, b in pairs)
                    same = torch.equal(loss, loss_e)
                    verdicts.append(f"{name} loss {'equal' if same else 'UNEQUAL'}"
                                    f", {equal} of {len(pairs)} leaves")
                    check(same and equal == len(pairs),
                          f"router {label}: the {name} run's step-0 loss or "
                          f"gradients differ from the local run's")
                    del g, pairs
                print(f"router {label} ({TRAIN_LAYERS}-layer fastmoe-gpt, "
                      f"{TRAIN_BATCH}x{TRAIN_SEQ}): step-0 loss "
                      f"{float(loss):.6f}; bit-equal to the local run: "
                      + "; ".join(verdicts) + f"; launches "
                      f"{json.dumps({k: v for k, v in runs.items() if v})}",
                      flush=True)
                del ref
                torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()

    opt = AdamW()
    state = opt.init(params)
    step = 0
    for router, dispatch in ROUTER_CASES:
        cfg = with_router(base, router, dispatch)
        for impl in ROUTER_IMPLS:
            step_fn = train.make_train_step(cfg, opt, impl=impl, device=dev)
            torch.cuda.reset_peak_memory_stats(dev)
            times, losses = [], []
            for i in range(1 + ROUTER_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, state, m = step_fn(params, state, batch, step)
                losses.append(float(m["loss"]))
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
                step += 1
                check(math.isfinite(losses[-1]) and 3.0 < losses[-1] < 20.0,
                      f"router {router} {impl}/{dispatch} step: loss "
                      f"{losses[-1]}")
            print(f"router train step {router} {impl}/{dispatch}: "
                  f"{statistics.median(times):.1f} ms median of {ROUTER_STEPS} "
                  f"(" + " ".join(f"{v:.1f}" for v in times) + f"), AdamW "
                  f"included; peak memory "
                  f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
                  f"losses " + " ".join(f"{v:.4f}" for v in losses),
                  flush=True)
    del params, state, opt
    torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in launches.values()) for k in counters()}
    print(f"main path launches (routers, step 0 of {len(launches)} paths): "
          f"{json.dumps(total)}", flush=True)
    return total


def switch_phase(dev):
    """switch-base-128 (top-1, topk_softmax, no renormalize, GELU, 128
    experts) served whole: BATCH x PROMPT prompts, GEN steps, {fused,
    pallas} x {ragged, capacity}, the counters at 0 just before and read
    just after; the prefill and first decode logits of each kernel path
    against the f32 einsum oracle within the bf16 einsum path's distance;
    then cut to SWITCH_TRAIN_LAYERS layers, one step's gradients of
    fused/ragged (the k = 1 backward) against the f32 oracle and AdamW
    steps timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import serve, train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    base = get_config("switch-base-128")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"switch-base-128: {n / 1e9:.3f} B params (layers bf16) made from "
          f"seed 0 in {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    prompt = torch.randint(0, base.vocab_size, (BATCH, PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    cache_len = serve.cache_len_for(base, PROMPT + GEN)
    combos = [("fused", "ragged"), ("pallas", "ragged"),
              ("fused", "capacity"), ("pallas", "capacity")]
    for impl, dispatch in combos:
        serve.generate(params, with_dispatch(base, dispatch), prompt[:, :8], 2,
                       impl=impl, cache_len=16, device=dev)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    results = {}
    for impl, dispatch in combos:
        timings: dict = {}
        seq = serve.generate(params, with_dispatch(base, dispatch), prompt, GEN,
                             impl=impl, cache_len=cache_len, device=dev,
                             timings=timings)
        check(seq.shape == (BATCH, PROMPT + GEN)
              and bool(((seq >= 0) & (seq < base.vocab_size)).all()),
              f"switch {impl}/{dispatch}: bad tokens")
        results[(impl, dispatch)] = timings
    serving = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (switch-base-128 serving): "
          f"{json.dumps(serving)}", flush=True)
    for name in SERVE_KERNELS:
        check(serving[name] > 0, f"switch serving never launched {name}")
    for simple in SIMPLE_KERNELS:
        check(serving[simple] == 0, f"switch serving ran {simple}")
    for (impl, dispatch), t in results.items():
        dec = statistics.median(t["decode_s"])
        print(f"serve switch-base-128 {impl}/{dispatch}: prefill {BATCH}x"
              f"{PROMPT} {t['prefill_s'] * 1e3:.2f} ms; decode "
              f"{dec * 1e3:.3f} ms/step median over {len(t['decode_s'])} "
              f"({BATCH / dec:.1f} tok/s); peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    params32 = dict(params, layers=[lm.cast_params(p, torch.float32)
                                    for p in params["layers"]])
    for dispatch in ("ragged", "capacity"):
        cfg = with_dispatch(base, dispatch)
        with plain_attention():
            oracle = first_logits(params32, dataclasses.replace(
                cfg, dtype="float32"), prompt, "einsum", cache_len, dev)
        paths = {}
        for impl in ("einsum", "fused", "pallas"):
            with plain_attention() if impl == "einsum" else contextlib.nullcontext():
                lp, ld, _, _ = first_logits(params, cfg, prompt, impl,
                                            cache_len, dev, tok=oracle[2])
            paths[f"{'plain' if impl == 'einsum' else 'kernel'} bf16 {impl}"] = \
                torch.cat([lp, ld], dim=1)
        logits_within_floor(f"switch-base-128 12 layers, {BATCH}x{PROMPT} "
                            f"prefill + first decode, {dispatch}",
                            torch.cat([oracle[0], oracle[1]], dim=1), paths,
                            SERVE_REL_SLACK, SERVE_ABS_SLACK, SERVE_AGREE_SLACK)
        del oracle, paths
    del params, params32
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(with_dispatch(base, "ragged"),
                              num_layers=SWITCH_TRAIN_LAYERS)
    params = lm.init_params(cfg, seed=0, device=dev, param_dtype="float32")
    n = sum(t.numel() for t in tree_leaves(params))
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
    batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
    training = grads_within_floor(
        f"switch-base-128 {SWITCH_TRAIN_LAYERS} layers ragged", params, cfg,
        batch, dev, ("fused",))["fused"]
    for k in ("fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw",
              "gather_rows_by_source", "combine_topk", "flash_attention_bwd"):
        check(training[k] > 0, f"switch training never launched {k}")
    opt = AdamW()
    state = opt.init(params)
    step_fn = train.make_train_step(cfg, opt, impl="fused", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for step in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, step)
        loss = float(m["loss"])
        check(math.isfinite(loss), f"switch train step {step}: loss {loss}")
        if step:
            times.append((time.perf_counter() - t0) * 1e3)
    print(f"train switch-base-128 fused/ragged, {SWITCH_TRAIN_LAYERS} of 12 "
          f"layers ({n / 1e9:.3f} B f32 params), {TRAIN_BATCH}x{TRAIN_SEQ}: "
          f"step {statistics.median(times):.1f} ms median of {len(times)}, "
          f"AdamW included; peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; "
          f"step-0 launches {json.dumps({k: v for k, v in training.items() if v})}",
          flush=True)
    del params, state, opt, step_fn
    torch.cuda.empty_cache()
    return serving, training


@contextlib.contextmanager
def expertwise_f32():
    """An ``impl="f32"`` for ``fmoe_apply``: each expert's weights cast to
    f32 one at a time, its rows multiplied in f32 (capacity buffers and
    ragged groups) — the f32 oracle of a layer whose experts do not fit the
    card in f32."""
    import torch
    from repro_torch.core import fmoe

    def one(experts, e):
        return {k: v[e].float() for k, v in experts.items()}

    def capacity(experts, buf, act):
        return torch.stack([fmoe.dense_ffn(one(experts, e), buf[e].float(),
                                           act) for e in range(buf.shape[0])])

    def ragged(experts, xs, gs, act):
        out = torch.zeros(xs.shape[0], experts["wo"].shape[-1],
                          device=xs.device)
        lo = 0
        for e, n in enumerate(gs.tolist()):
            if n:
                out[lo:lo + n] = fmoe.dense_ffn(one(experts, e),
                                                xs[lo:lo + n].float(), act)
            lo += n
        return out
    fmoe.EXPERT_FNS["f32"], fmoe.RAGGED_FNS["f32"] = capacity, ragged
    try:
        yield
    finally:
        del fmoe.EXPERT_FNS["f32"], fmoe.RAGGED_FNS["f32"]


def arctic_phase(dev):
    """arctic-480b at full width, ARCTIC_LAYERS of 35 layers (bf16, each
    expert cast as it is drawn), served greedily: ARCTIC_BATCH prompts of
    ARCTIC_PROMPT tokens, ARCTIC_GEN steps, fused/ragged and
    pallas/capacity, the counters at 0 just before and read just after;
    then layer 0's MoE block (128 experts top-2 and the dense residual
    FFN) on the prompt's hidden states, each kernel path against an f32
    oracle computed expert by expert, within the bf16 einsum path's
    distance (one layer in f32 is ~54 GB: the whole-model f32 oracle does
    not fit the card)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import fmoe
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.models.layers import apply_norm, embed_lookup
    from repro_torch.optim.adamw import tree_leaves

    base = dataclasses.replace(get_config("arctic-480b"),
                               num_layers=ARCTIC_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = lm.init_params(base, seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"arctic-480b: {ARCTIC_LAYERS} of 35 layers, {n / 1e9:.3f} B params "
          f"(bf16 layers) made from seed 0 in {time.perf_counter() - t0:.1f} s,"
          f" init peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
          flush=True)
    prompt = torch.randint(0, base.vocab_size, (ARCTIC_BATCH, ARCTIC_PROMPT),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(7))
    combos = (("fused", "ragged"), ("pallas", "capacity"))
    cache_len = ARCTIC_PROMPT + ARCTIC_GEN
    for impl, dispatch in combos:
        serve.generate(params, with_dispatch(base, dispatch), prompt[:, :8], 2,
                       impl=impl, cache_len=16, device=dev)
    torch.cuda.synchronize()
    for fn in counters().values():
        fn.launches = 0
    for impl, dispatch in combos:
        torch.cuda.reset_peak_memory_stats(dev)
        timings: dict = {}
        seq = serve.generate(params, with_dispatch(base, dispatch), prompt,
                             ARCTIC_GEN, impl=impl, cache_len=cache_len,
                             device=dev, timings=timings)
        check(seq.shape == (ARCTIC_BATCH, ARCTIC_PROMPT + ARCTIC_GEN)
              and bool(((seq >= 0) & (seq < base.vocab_size)).all()),
              f"arctic {impl}/{dispatch}: bad tokens")
        dec = statistics.median(timings["decode_s"])
        print(f"serve arctic-480b {impl}/{dispatch} ({ARCTIC_LAYERS} layers): "
              f"prefill {ARCTIC_BATCH}x{ARCTIC_PROMPT} "
              f"{timings['prefill_s'] * 1e3:.2f} ms; decode {dec * 1e3:.3f} "
              f"ms/step median over {len(timings['decode_s'])}; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB", flush=True)
    serving = {k: fn.launches for k, fn in counters().items()}
    print(f"main path launches (arctic-480b serving): {json.dumps(serving)}",
          flush=True)
    for name in SERVE_KERNELS:
        check(serving[name] > 0, f"arctic serving never launched {name}")

    # layer 0's MoE block on the prompt's hidden states after its attention
    with torch.no_grad():
        p0 = params["layers"][0]
        x = embed_lookup(params["embed"], prompt, torch.bfloat16)
        from repro_torch.models import attention as A
        x = x + A.gqa_apply(p0["attn"], apply_norm(p0["norm1"], x, base.norm),
                            base.attention, window=1 << 30)
        h = apply_norm(p0["norm2"], x, base.norm)
        ffn = p0["ffn"]
        check("dense" in ffn, "arctic's MoE block has no dense residual")
        ffn32 = {"router": lm.cast_params(ffn["router"], torch.float32),
                 "experts": ffn["experts"],
                 "dense": lm.cast_params(ffn["dense"], torch.float32)}
        for impl, dispatch in combos:
            moe = dataclasses.replace(base.moe, dispatch=dispatch)
            with expertwise_f32():
                oracle = fmoe.fmoe_apply(ffn32, h.float(), moe, act=base.act,
                                         impl="f32")[0]
            paths = {"plain bf16": fmoe.fmoe_apply(ffn, h, moe, act=base.act,
                                                   impl="einsum")[0],
                     f"kernel bf16 {impl}/{dispatch}": fmoe.fmoe_apply(
                         ffn, h, moe, act=base.act, impl=impl)[0]}
            logits_within_floor(f"arctic-480b layer 0 MoE block with the "
                                f"dense residual, {ARCTIC_BATCH}x"
                                f"{ARCTIC_PROMPT} tokens, {dispatch}",
                                oracle.float(), {k: v.float() for k, v in
                                                 paths.items()},
                                SERVE_REL_SLACK, SERVE_ABS_SLACK, 1.0)
            del oracle, paths
    del params
    torch.cuda.empty_cache()
    return serving


def dense_phase(dev):
    """The dense configs at full width (DENSE_RUNS; qwen2-72b cut to 24 of
    80 layers), each served greedily: DENSE_BATCH prompts of DENSE_PROMPT
    tokens, DENSE_GEN steps, the counters at 0 just before and read just
    after (the flash forward once a layer a prefill); then the prefill
    logits of the kernel path (flash attention) against the f32 plain path
    on the same weights (each layer cast to f32 at use), within the bf16
    plain path's distance (SC2_*: no experts to switch)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    launches = {}
    for name, layers in DENSE_RUNS:
        cfg = get_config(name)
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params = lm.init_params(cfg, seed=0, device=dev)
        n = sum(t.numel() for t in tree_leaves(params))
        prompt = torch.randint(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT),
                               device=dev, generator=torch.Generator(
                                   device=dev).manual_seed(8))
        cache_len = serve.cache_len_for(cfg, DENSE_PROMPT + DENSE_GEN)
        serve.generate(params, cfg, prompt[:, :8], 2, cache_len=16, device=dev)
        torch.cuda.synchronize()
        for fn in counters().values():
            fn.launches = 0
        timings: dict = {}
        seq = serve.generate(params, cfg, prompt, DENSE_GEN,
                             cache_len=cache_len, device=dev, timings=timings)
        torch.cuda.synchronize()
        runs = {k: fn.launches for k, fn in counters().items()}
        launches[name] = runs
        check(seq.shape == (DENSE_BATCH, DENSE_PROMPT + DENSE_GEN)
              and bool(((seq >= 0) & (seq < cfg.vocab_size)).all()),
              f"{name}: bad tokens")
        check(runs["flash_attention_fwd"] == cfg.num_layers,
              f"{name}: the prefill launched the flash forward "
              f"{runs['flash_attention_fwd']} times over {cfg.num_layers} "
              f"layers")
        dec = statistics.median(timings["decode_s"])
        a = cfg.attention
        print(f"serve {name} ({cfg.num_layers} layers, {n / 1e9:.3f} B params, "
              f"{a.num_heads}/{a.num_kv_heads} heads of {a.head_dim}): "
              f"prefill {DENSE_BATCH}x{DENSE_PROMPT} "
              f"{timings['prefill_s'] * 1e3:.2f} ms; decode {dec * 1e3:.3f} "
              f"ms/step median over {len(timings['decode_s'])}; peak "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; launches "
              f"{json.dumps({k: v for k, v in runs.items() if v})}", flush=True)
        with torch.no_grad():
            with plain_attention():
                oracle = lm.forward(params, dataclasses.replace(
                    cfg, dtype="float32"), prompt, device=dev)[0]
                plain = lm.forward(params, cfg, prompt, device=dev)[0]
            kern = lm.forward(params, cfg, prompt, device=dev)[0]
        logits_within_floor(f"{name} {cfg.num_layers} layers, {DENSE_BATCH}x"
                            f"{DENSE_PROMPT}", oracle,
                            {"plain bf16": plain, "kernel bf16": kern},
                            SC2_REL_SLACK, 0.0, SC2_AGREE_SLACK)
        del params, oracle, plain, kern
        torch.cuda.empty_cache()
    return launches


def deepseek_train_phase(dev):
    """deepseek-v2-236b trained at every width, DS_TRAIN_LAYERS of 60
    layers with DS_TRAIN_EXPERTS of 160 routed experts (f32 masters, bf16
    compute), fused/ragged, DS_TRAIN_BATCH x DS_TRAIN_SEQ tokens: the
    step-0 loss and every gradient leaf against the f32 einsum oracle
    (plain attention) within the bf16 einsum path's distance, the kernel
    path counted (counters at 0 just before, read just after: the flash
    backward at MLA's (192, 128), the fused FFN dX and dW at K 5120 / H
    1536 SwiGLU), then AdamW steps timed with peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    base = get_config("deepseek-v2-236b")
    cfg = dataclasses.replace(base, num_layers=DS_TRAIN_LAYERS,
                              moe=dataclasses.replace(
                                  base.moe, num_experts=DS_TRAIN_EXPERTS,
                                  dispatch="ragged"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init_params(cfg, seed=0, device=dev, param_dtype="float32")
    n = sum(t.numel() for t in tree_leaves(params))
    data = SyntheticLM(cfg.vocab_size, DS_TRAIN_SEQ, seed=0).batches(
        DS_TRAIN_BATCH)
    batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
    print(f"deepseek-v2-236b training: {DS_TRAIN_LAYERS} of 60 layers, "
          f"{DS_TRAIN_EXPERTS} of 160 routed experts, every width: "
          f"{n / 1e9:.3f} B f32 params ({16 * n / 1e9:.1f} GB at 16 B a "
          f"param)", flush=True)
    runs = grads_within_floor(
        f"deepseek-v2-236b {DS_TRAIN_LAYERS} layers {DS_TRAIN_EXPERTS} "
        f"experts ragged, {DS_TRAIN_BATCH}x{DS_TRAIN_SEQ}", params, cfg, batch,
        dev, ("fused",))["fused"]
    for k in ("fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw",
              "flash_attention_fwd", "flash_attention_bwd",
              "gather_rows_by_source", "combine_topk"):
        check(runs[k] > 0, f"deepseek training never launched {k}")
    for simple in SIMPLE_KERNELS:
        check(runs[simple] == 0, f"deepseek training ran {simple}")
    opt = AdamW()
    state = opt.init(params)
    step_fn = train.make_train_step(cfg, opt, impl="fused", device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    times, losses = [], []
    for step in range(1 + DS_TRAIN_STEPS):
        timings: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step_fn(params, state, batch, step, timings=timings)
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]), f"deepseek step {step}: loss "
                                         f"{losses[-1]}")
        if step:
            times.append(((time.perf_counter() - t0) * 1e3, timings))
    med = statistics.median(t for t, _ in times)
    split = {k: statistics.median(t[k] for _, t in times)
             for k in ("fwd_s", "bwd_s", "opt_s")}
    print(f"train deepseek-v2-236b fused/ragged: step {med:.1f} ms median of "
          f"{len(times)} ({DS_TRAIN_BATCH * DS_TRAIN_SEQ / med * 1e3:.0f} "
          f"tokens/s; forward {split['fwd_s'] * 1e3:.1f} ms, backward "
          f"{split['bwd_s'] * 1e3:.1f} ms, optimizer "
          f"{split['opt_s'] * 1e3:.1f} ms), AdamW included; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; losses "
          + " ".join(f"{v:.4f}" for v in losses) + f"; step-0 launches "
          f"{json.dumps({k: v for k, v in runs.items() if v})}", flush=True)
    del params, state, opt, step_fn
    torch.cuda.empty_cache()
    return runs


def dw_ulp_atol(x, ws, wo, dy, gs, act) -> float:
    """One bf16 ulp of the largest |dg| (|du|) the dW recompute rounds,
    times the largest |x|: what one flipped rounding of an intermediate
    moves a dW output by (see DW_TOL)."""
    import torch
    from repro_torch.kernels import fused_ffn_bwd as fb
    top, lo = 0.0, 0
    for e, n in enumerate(gs.tolist()):
        if n:
            xe, dye = x[lo:lo + n].float(), dy[lo:lo + n].float()
            dg, du = fb.act_vjp(xe @ ws[0][e].float(),
                                xe @ ws[1][e].float() if len(ws) == 2 else None,
                                dye @ wo[e].float().T, act)
            top = max(top, float(dg.abs().max()),
                      0.0 if du is None else float(du.abs().max()))
        lo += n
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max(DW_TOL["bfloat16"]["atol"], ulp * float(x.abs().max()))


def ds_bwd_kernel_phase(dev, flush):
    """The fused FFN at deepseek-v2's training rows (DS_TRAIN_BATCH x
    DS_TRAIN_SEQ tokens' top-6 over DS_TRAIN_EXPERTS experts: 12288 rows,
    K 5120, H 1536, SwiGLU, bf16): forward, dX and dW against their plain
    versions (the ring kernels, as the counters show), timed beside their
    bounds, the plain versions and the unfused references by
    torch._grouped_mm."""
    import torch
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_ffn_bwd as fb

    g = torch.Generator(device=dev).manual_seed(9)
    nE, K, Hh, k = DS_TRAIN_EXPERTS, 5120, 1536, 6
    T = DS_TRAIN_BATCH * DS_TRAIN_SEQ
    M = T * k
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    ids = routed(T, k, 0, dev, nE)
    gs = torch.bincount(ids.flatten(), minlength=nE).to(torch.int32)
    n, used = int(gs.sum()), int((gs > 0).sum())
    wi, wu = randn(nE, K, Hh, scale=K ** -0.5), randn(nE, K, Hh, scale=K ** -0.5)
    wo = randn(nE, Hh, K, scale=Hh ** -0.5)
    x, dy = randn(M, K), randn(M, K)
    ws = (wi, wu)
    tol = KERNEL_TOL["bfloat16"]
    before = bwd_counts()
    dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, "swiglu")
    dws, dwo = fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, "swiglu")
    y = ff.fused_ffn(x, ws, wo, gs, "swiglu")
    torch.cuda.synchronize()
    check(bwd_counts() == (before[0] + 1, before[1], before[2] + 1, before[3]),
          f"deepseek training rows: the backward did not take the ring "
          f"kernels ({before} -> {bwd_counts()})")
    errs = {"fused_ffn_bwd_dx": close(
        "fused_ffn_bwd_dx deepseek train", dx,
        fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, "swiglu"), tol)}
    rws, rwo = fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "swiglu")
    dw_tol = dict(DW_TOL["bfloat16"],
                  atol=dw_ulp_atol(x, ws, wo, dy, gs, "swiglu"))
    print(f"fused_ffn_bwd_dw deepseek train: elementwise tolerance {dw_tol} "
          f"(one bf16 ulp of the largest |dg| times the largest |x|)",
          flush=True)
    e2 = 0.0
    for a, b in zip((*dws, dwo), (*rws, rwo)):
        e2 = max(e2, close("fused_ffn_bwd_dw deepseek train", a, b, dw_tol))
        fro = ((a - b).norm() / b.norm()).item()
        check(fro <= DW_FRO, f"fused_ffn_bwd_dw deepseek train: relative "
                             f"Frobenius error {fro:.2e}")
    errs["fused_ffn_bwd_dw"] = e2
    errs["fused_ffn"] = close("fused_ffn_swiglu deepseek train", y,
                              ff.fused_ffn_plain(x, ws, wo, gs, "swiglu"), tol)
    del dx, dws, dwo, rws, rwo, y
    wbytes = used * 3 * K * Hh * 2
    cases = {
        "fused_ffn_bwd_dx": (
            lambda: fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, "swiglu"),
            lambda: fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, "swiglu"),
            2 * 3 * M * K + wbytes + 4 * nE, 8 * n * K * Hh),
        "fused_ffn_bwd_dw": (
            lambda: fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, "swiglu"),
            lambda: fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "swiglu"),
            2 * 2 * M * K + wbytes + 4 * 3 * nE * K * Hh + 4 * nE,
            12 * n * K * Hh),
        "fused_ffn": (
            lambda: ff.fused_ffn(x, ws, wo, gs, "swiglu"),
            lambda: ff.fused_ffn_plain(x, ws, wo, gs, "swiglu"),
            2 * 2 * M * K + wbytes + 4 * nE, 6 * n * K * Hh),
    }
    timed = {}
    p = fb.plan_bwd(M, nE, Hh)
    print(f"plan_bwd deepseek train ({M} rows, {used} experts with rows, "
          f"largest {int(gs.max())}): dX row tile {p.bm}, {p.splits} splits",
          flush=True)
    for kname, (kern, plain, nbytes, flops) in cases.items():
        ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush, 3)
        fl = device_floor(nbytes, flops, "bfloat16")
        dev_ms = device_ms(kern, floor=fl, what=f"{kname} deepseek train")
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        timed[kname] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None, device_ms=dev_ms,
                            max_abs_err=errs[kname])
        print(f"kernel {kname} deepseek train bf16: {ms:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.0f} MB, "
              f"{flops / 1e9:.1f} GFLOP)  plain {plain_ms:.4f} ms  library "
              f"n/a; device (L2 warm) {dev_ms:.4f} ms", flush=True)
    offs = torch.cumsum(gs, 0).to(torch.int32)
    ref = unfused_ffn("fused_ffn_swiglu deepseek train", x, wi, wo, offs,
                      flush, wu=wu)
    if ref:
        timed["fused_ffn"]["unfused_ms"], timed["fused_ffn"]["unfused_device_ms"] = ref
    ref = unfused_ffn_bwd("fused_ffn_bwd deepseek train", x, wi, wo, dy, offs,
                          flush, wu=wu) or {}
    for what, kname in (("dX", "fused_ffn_bwd_dx"), ("dW", "fused_ffn_bwd_dw")):
        if what in ref:
            timed[kname]["unfused_ms"], timed[kname]["unfused_device_ms"] = \
                ref[what]
    del x, dy, wi, wu, wo
    torch.cuda.empty_cache()
    return timed


def rel_err(a, b):
    """Relative L2 error of each position's logit vector, flattened."""
    return ((a - b).norm(dim=-1) / b.norm(dim=-1)).flatten()


def logits_within_floor(label, oracle, paths: dict, rel_slack: float,
                        abs_slack: float, agree_slack: float) -> None:
    """Each of paths (name -> logits, the bf16 plain path first) against
    the f32 oracle: per-position relative error and argmax agreement; each
    later path within the first's (the floor): median <= rel_slack x floor
    + abs_slack, agreement >= floor - agree_slack."""
    import torch
    floor = None
    for name, lg in paths.items():
        check(lg.shape == oracle.shape and bool(torch.isfinite(lg).all()),
              f"{label}: {name} logits malformed")
        rel = rel_err(lg, oracle)
        med = rel.median().item()
        agree = (lg.argmax(-1) == oracle.argmax(-1)).float().mean().item()
        print(f"{label}: {name} logits vs f32 plain path: per-position "
              f"relative error p50 {med:.5f} p90 {rel.quantile(0.9).item():.5f} "
              f"max {rel.max().item():.5f}, argmax agree {agree:.4f}", flush=True)
        if floor is None:
            floor = (med, agree)
            continue
        check(med <= rel_slack * floor[0] + abs_slack
              and agree >= floor[1] - agree_slack,
              f"{label}: {name} logits further from the f32 oracle than the "
              f"bf16 plain path (floor {floor}; slack x{rel_slack} "
              f"+{abs_slack}, agreement -{agree_slack})")


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
    for dk, dv in fa.HEAD_DIM_PAIRS:
        for bq, sq in ((64, 1), (128, 1 << 20)):
            got = lib.flash_attention_fwd_smem(dk, dv, bq)
            cfg = fa.fwd_config(1, sq, 64, dk, dv)
            check(cfg.bq == bq and got == cfg.smem,
                  f"flash forward (dk {dk}, dv {dv}) bq {bq}: kernel asks "
                  f"{got} B, host mirror {cfg.smem} B")
            sizes[("flash", (dk, dv), bq)] = got
    check(all(0 < v <= fa.SMEM_LIMIT for v in sizes.values()),
          f"dynamic shared memory out of range: {sizes}")
    print("  dynamic shared memory (bytes): fused_ffn_ring_kernel (bm, hc, "
          "gated) " + ", ".join(f"{k}: {v}" for k, v in sizes.items()
                                if k[0] != "flash")
          + "; flash_fwd_wgmma_kernel ((dk, dv), bq) "
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


# ---------------------------------------------------------------------------
# Expert placement (slice 14)
# ---------------------------------------------------------------------------


# the placed train steps: each path under plan (a) (a seeded permutation
# per layer) and plan (b) ((a) with the last PLACE_SHADOW physical slots
# shadowed) over a 1x1 NCCL mesh, and locally under (a)
PLACE_COMBOS = (("fused", "capacity"), ("fused", "ragged"),
                ("pallas", "capacity"), ("pallas", "ragged"))
PLACE_LOCAL = ("fused", "ragged")  # the combo (a) also runs locally
# the combos whose AdamW steps are timed: one capacity, one ragged
PLACE_TIMED = (("fused", "ragged"), ("pallas", "capacity"))
PLACE_SHADOW, PLACE_SHRINK, PLACE_SEED = 8, 0.75, 14
PLACE_STEPS = 3  # timed AdamW steps a case, in turns, after a warm one
# Under (b) the shadowed experts are a launch of their own, planned for the
# whole (E, C) buffer's rows (the chunked steps' rule), so the forward and
# dX are bit-equal to the unplaced step's and with them the loss and every
# gradient leaf but the experts': each expert's dW then sums its rows in
# a launch of another shape, held as a chunked step's expert leaves are
# (relative L2 to the unplaced step's).
PLACE_EXPERT_L2 = OVERLAP_EXPERT_L2
PLACE_CLI_STEPS, PLACE_CLI_EVERY = 12, 4


def placement_plans(num_layers: int):
    """Plans (a), (b), (c) for fastmoe-gpt at one rank: (a) a seeded random
    permutation per layer, (b) (a) with PLACE_SHADOW shadowed experts, (c)
    (b) with the exchange's capacity scaled by PLACE_SHRINK."""
    import numpy as np
    from repro_torch import placement as P
    rng = np.random.default_rng(PLACE_SEED)
    perms = [tuple(int(i) for i in rng.permutation(E))
             for _ in range(num_layers)]
    a = P.per_layer_placement([P.ExpertPlacement(E, 1, p) for p in perms])
    b = P.per_layer_placement([p._replace(num_shadow=PLACE_SHADOW)
                               for p in a.layers])
    c = P.per_layer_placement([p._replace(capacity_scale=PLACE_SHRINK)
                               for p in b.layers])
    return a, b, c


def row_fingerprints(tree) -> list:
    """Per expert leaf, a 64-bit fingerprint of each expert's row: its
    int32 bit patterns weighted by a fixed pseudo-random vector, summed in
    int64 (a row moved, or a bit changed, shows; a permutation of rows
    keeps the multiset of row sums, which the row order then pins)."""
    import torch
    out = []
    weights = {}
    for path, leaf in leaf_paths(tree):
        if "/experts/" not in path:
            continue
        n = leaf[0].numel()
        if n not in weights:
            g = torch.Generator(device=leaf.device).manual_seed(n)
            weights[n] = torch.randint(1, 1 << 20, (n,), generator=g,
                                       device=leaf.device)
        bits = leaf.detach().view(torch.int32).reshape(leaf.shape[0], -1)
        out.append((bits.long() * weights[n]).sum(1))
    return out


def placement_kernels(dev, flush):
    """The kernels at the placed launches' shapes (fastmoe-gpt, 8 x 256
    tokens, C = 56): the fused FFN and its dX on the shadowed experts'
    buffer (8 x 56 rows) planned for the whole buffer's 96 x 56, each held
    to its plain version and its rows bit-equal to the same rows of the
    whole buffer's launch; the grouped GEMM on the owned buffer at plan
    (c)'s shrunk capacity (88 x 48).  Times beside bounds."""
    import torch
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import fused_ffn_bwd as fb
    from repro_torch.kernels import grouped_gemm as gg

    g = torch.Generator(device=dev).manual_seed(PLACE_SEED)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)
    C, S = CAP_ROWS, PLACE_SHADOW
    wi = randn(E, D, H, scale=D ** -0.5)
    wo = randn(E, H, D, scale=H ** -0.5)
    x = randn(E * C, D)
    dy = randn(E * C, D)
    whole = torch.full((E,), C, dtype=torch.int32, device=dev)
    sh = whole[:S]
    xs, dys = x[(E - S) * C:], dy[(E - S) * C:]
    out = {}
    y_whole = ff.fused_ffn(x, (wi,), wo, whole, "gelu")
    dx_whole = fb.fused_ffn_bwd_dx(x, (wi,), wo, dy, whole, "gelu")
    cases = {
        "fused_ffn": (lambda: ff.fused_ffn(xs, (wi[E - S:],), wo[E - S:], sh,
                                           "gelu", E * C),
                      lambda: ff.fused_ffn_plain(xs, (wi[E - S:],), wo[E - S:],
                                                 sh, "gelu"),
                      y_whole[(E - S) * C:], 2 * S * C * D * H * 2,
                      xs.numel() * 2 + 2 * S * D * H * 2 + xs.numel() * 2),
        "fused_ffn_bwd_dx": (
            lambda: fb.fused_ffn_bwd_dx(xs, (wi[E - S:],), wo[E - S:], dys,
                                        sh, "gelu", E * C),
            lambda: fb.fused_ffn_bwd_dx_plain(xs, (wi[E - S:],), wo[E - S:],
                                              dys, sh, "gelu"),
            dx_whole[(E - S) * C:], 3 * S * C * D * H * 2,
            3 * xs.numel() * 2 + 2 * S * D * H * 2),
    }
    Cm = 48  # plan (c): 8 * ceil(56 * 0.75 / 8)
    xo = randn((E - S) * Cm, D)
    owned = torch.full((E - S,), Cm, dtype=torch.int32, device=dev)
    cases["grouped_gemm"] = (
        lambda: gg.grouped_gemm(xo, wi[:E - S], owned),
        lambda: gg.grouped_gemm_plain(xo, wi[:E - S], owned),
        None, 2 * xo.shape[0] * D * H,
        xo.numel() * 2 + (E - S) * D * H * 2 + xo.shape[0] * H * 2)
    libs = {"grouped_gemm": grouped_mm_call(
        xo, wi[:E - S], torch.cumsum(owned, 0, dtype=torch.int32))}
    for name, (kern, plain, want, flops, nbytes) in cases.items():
        got = kern()
        err = close(f"placement {name}", got, plain(),
                    KERNEL_TOL["bfloat16"])
        if want is not None:
            check(torch.equal(got, want), f"placement {name}: the shadowed "
                  f"launch's rows differ from the whole buffer's launch's")
        ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush)
        lib = libs.get(name)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, max_abs_err=err)
        print(f"kernel {name:16s} placement "
              f"{'shadow 8 x 56 (plan rows 96 x 56)' if want is not None else 'owned 88 x 48'}"
              f" bf16: {ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  plain "
              f"{plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; max |err| "
              f"{err:.3e}"
              + ("; rows bit-equal to the whole launch's" if want is not None
                 else ""), flush=True)
    return out


def placement_phase(dev):
    """Expert placement (ROADMAP §1 item 4) on full-width fastmoe-gpt at
    TRAIN_LAYERS layers, 8 x 256 tokens, over a 1x1 mesh (a world-size-1
    NCCL group in this process).  At one rank no plan pays for itself, so
    the card drives forced plans (``placement_plans``): for each of
    PLACE_COMBOS the step-0 loss and every gradient leaf, mapped back to
    logical order, against the unplaced a2a step's (under (a) bit for bit,
    a2a and, on PLACE_LOCAL, local; under (b) the loss and non-expert
    leaves bit for bit, the expert leaves within PLACE_EXPERT_L2), the
    launch counters at 0 just before each placed run and read just after
    (under (b) every expert kernel launches twice as often: the shadowed
    experts' launch); (c)'s drop fraction against the host's count from
    the routing and the two capacities; the AdamW steps of each plan timed
    in turns on PLACE_TIMED; the migration of the whole params and AdamW
    state (ms, peak memory, the round trip bit-equal by row fingerprints); a ReplanHook whose forced
    switch to (a) mid-run gives the unplaced run's next loss, grad norm
    and params bit for bit, and whose monitor resolves
    ``ragged_bound="auto"`` to 0; then ``train --mesh 1x1 --replan_every
    --ragged_bound auto`` against the same CLI without the hook; and
    (slice 15, ``placed_psum_train``) the placed psum train step under
    (a) and (b) against the identity-placed one.  Returns the launches
    summed over the placed runs and the kernel times."""
    import torch
    import torch.distributed as tdist
    from repro_torch import placement as P
    from repro_torch.configs import get_config
    from repro_torch.core import fmoe
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves

    t_phase = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    kernel_times = placement_kernels(dev, flush)
    del flush
    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    totals = {k: 0 for k in counters()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    plan_a, plan_b, plan_c = placement_plans(TRAIN_LAYERS)
    try:
        mesh = make_local_mesh(1, 1)
        base = dataclasses.replace(get_config("fastmoe-gpt"),
                                   num_layers=TRAIN_LAYERS)
        data = SyntheticLM(base.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        torch.cuda.empty_cache()
        params = lm.init_params(base, seed=0, device=dev,
                                param_dtype=base.param_dtype)

        def counted(fn, add=True):
            for f in counters().values():
                f.launches = 0
            out = fn()
            torch.cuda.synchronize()
            runs = {k: f.launches for k, f in counters().items()}
            if add:
                for k, v in runs.items():
                    totals[k] += v
            return out, runs

        expert_kernels = ("fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw",
                          "grouped_gemm")
        for impl, dispatch in PLACE_COMBOS:
            cfg = with_dispatch(base, dispatch)
            plain = train.moe_dist(cfg, mesh, tokens)
            (loss_u, _, g_u), runs_u = counted(lambda: train.loss_and_grads(
                params, cfg, batch, impl=impl, device=dev, dist=plain), False)
            paths = [p for p, _ in leaf_paths(g_u)]
            expert = {i for i, p in enumerate(paths) if "/experts/" in p}
            cases = [("a", plan_a, plain._replace(placement=plan_a)),
                     ("b", plan_b, plain._replace(placement=plan_b))]
            if (impl, dispatch) == PLACE_LOCAL:
                cases.insert(1, ("a local", plan_a,
                                 fmoe.DistConfig.local(plan_a)))
            for label, plan, dist in cases:
                P.from_logical(params, plan)
                (loss_p, _, g_p), runs = counted(
                    lambda: train.loss_and_grads(params, cfg, batch,
                                                 impl=impl, device=dev,
                                                 dist=dist))
                P.to_logical(params, plan)
                P.to_logical(g_p, plan)
                pairs = list(zip(tree_leaves(g_p), tree_leaves(g_u)))
                unequal = {i for i, (a, b) in enumerate(pairs)
                           if not torch.equal(a, b)}
                worst = max(_grad_dists(*zip(*pairs))[i] for i in expert)
                may_differ = expert if plan is plan_b else set()
                ratio = {k: runs[k] / runs_u[k] for k in expert_kernels
                         if runs_u[k]}
                print(f"placement {impl}/{dispatch} plan ({label}) 1x1: "
                      f"step-0 loss {float(loss_p):.6f}, unplaced "
                      f"{float(loss_u):.6f}, "
                      f"{'equal' if torch.equal(loss_p, loss_u) else 'UNEQUAL'}; "
                      f"{len(pairs) - len(unequal)} of {len(pairs)} gradient "
                      f"leaves bit-equal after to_logical (rule: all"
                      f"{' but the expert leaves' if may_differ else ''}); "
                      f"expert leaves' relative L2 max {worst:.2e}; expert "
                      f"kernel launches / unplaced {json.dumps(ratio)}; "
                      f"launches {json.dumps({k: v for k, v in runs.items() if v})}",
                      flush=True)
                check(torch.equal(loss_p, loss_u), f"placement {impl}/"
                      f"{dispatch} ({label}): step-0 loss differs")
                check(unequal <= may_differ, f"placement {impl}/{dispatch} "
                      f"({label}): gradient leaves differ: "
                      f"{[paths[i] for i in sorted(unequal - may_differ)]}")
                check(worst <= PLACE_EXPERT_L2, f"placement {impl}/{dispatch}"
                      f" ({label}): expert gradients {worst:.2e} away")
                want = 2 if plan is plan_b else 1  # the shadowed launch
                check(all(v == want for v in ratio.values()),
                      f"placement {impl}/{dispatch} ({label}): expert kernel "
                      f"launches {ratio} x the unplaced, not {want}")
                for k in needed_kernels(impl, dispatch):
                    check(runs[k] > 0, f"placement {impl}/{dispatch} "
                                       f"({label}): kernel {k} never launched")
                for simple in SIMPLE_KERNELS:
                    check(runs[simple] == 0, f"placement {impl}/{dispatch}: "
                                             f"{simple} ran at a model shape")
                del g_p, pairs
                torch.cuda.empty_cache()
            del g_u
            torch.cuda.empty_cache()
        placed_psum_train(dev, base, mesh, batch, params, (plan_a, plan_b),
                          counted)
        placement_drops(dev, base, mesh, batch, params, plan_c, counted)
        del params
        torch.cuda.empty_cache()
        placement_times(dev, base, mesh, batch, (plan_a, plan_b), counted)
        placement_switch(dev, base, mesh, plan_a)
    finally:
        tdist.destroy_process_group()
    torch.cuda.empty_cache()
    placement_cli(dev)
    print(f"main path launches (placed training, 1x1): {json.dumps(totals)}",
          flush=True)
    print(f"placement phase wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return totals, kernel_times


def placed_psum_train(dev, base, mesh, batch, params, plans, counted):
    """(slice 15) The placed psum train step (fused/ragged, token axes
    ("data",) over the 1x1 mesh): the step-0 loss and every gradient leaf,
    mapped back to logical order, under plans (a) and (b) against the
    identity-placed step's (the slot-wise reduction too): under (a) bit
    for bit, under (b) the loss and the non-expert leaves bit for bit and
    the expert leaves within PLACE_EXPERT_L2; the shadowed launch counted
    (every expert kernel twice as often under (b))."""
    import torch
    from repro_torch import placement as P
    from repro_torch.core import fmoe
    from repro_torch.launch import train
    from repro_torch.optim.adamw import tree_leaves

    cfg = with_dispatch(base, "ragged")
    psum = fmoe.DistConfig(mesh, ("data",))
    ident = P.identity_per_layer(E, 1, base.num_layers)

    def step(dist):
        return train.loss_and_grads(params, cfg, batch, impl="fused",
                                    device=dev, dist=dist)
    (loss_i, _, g_i), runs_i = counted(
        lambda: step(psum._replace(placement=ident)))
    paths = [p for p, _ in leaf_paths(g_i)]
    expert = {i for i, p in enumerate(paths) if "/experts/" in p}
    for label, plan in zip(("a", "b"), plans):
        P.from_logical(params, plan)
        (loss_p, _, g_p), runs = counted(
            lambda: step(psum._replace(placement=plan)))
        P.to_logical(params, plan)
        P.to_logical(g_p, plan)
        pairs = list(zip(tree_leaves(g_p), tree_leaves(g_i)))
        unequal = {i for i, (u, v) in enumerate(pairs) if not torch.equal(u, v)}
        worst = max(_grad_dists(*zip(*pairs))[i] for i in expert)
        may_differ = expert if label == "b" else set()
        ratio = {k: runs[k] / runs_i[k] for k in
                 ("fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw")}
        print(f"placement psum fused/ragged plan ({label}) 1x1: step-0 loss "
              f"{float(loss_p):.6f}, identity-placed {float(loss_i):.6f}, "
              f"{'equal' if torch.equal(loss_p, loss_i) else 'UNEQUAL'}; "
              f"{len(pairs) - len(unequal)} of {len(pairs)} gradient leaves "
              f"bit-equal after to_logical (rule: all"
              f"{' but the expert leaves' if may_differ else ''}); expert "
              f"leaves' relative L2 max {worst:.2e}; expert kernel launches / "
              f"identity-placed {json.dumps(ratio)}; combine_topk "
              f"{runs['combine_topk']} (identity-placed "
              f"{runs_i['combine_topk']})", flush=True)
        check(torch.equal(loss_p, loss_i), f"placement psum ({label}): the "
                                           f"step-0 loss differs")
        check(unequal <= may_differ, f"placement psum ({label}): gradient "
              f"leaves differ: {[paths[i] for i in sorted(unequal - may_differ)]}")
        check(worst <= PLACE_EXPERT_L2, f"placement psum ({label}): expert "
                                        f"gradients {worst:.2e} away")
        want = 2 if label == "b" else 1
        check(all(v == want for v in ratio.values()),
              f"placement psum ({label}): expert kernel launches {ratio}")
        del g_p, pairs
        torch.cuda.empty_cache()
    del g_i
    torch.cuda.empty_cache()


def placement_drops(dev, base, mesh, batch, params, plan_c, counted):
    """Plan (c) on fused/capacity: the forward's drop fraction against the
    host's count of the rows past their expert's capacity (the owned
    experts' shrunk one, the shadowed experts' full one), slot-major in
    each layer's physical routing, as the capacity plan assigns them."""
    import numpy as np
    import torch
    from repro_torch import placement as P
    from repro_torch.core import dispatch as Dsp
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = with_dispatch(base, "capacity")
    dist = train.moe_dist(cfg, mesh, TRAIN_BATCH * TRAIN_SEQ,
                          placement=plan_c)
    seen = []
    orig = Dsp.make_capacity_plan

    def tap(ids, num_experts, capacity):
        seen.append((ids.detach().cpu().numpy(), np.asarray(capacity)))
        return orig(ids, num_experts, capacity)
    P.from_logical(params, plan_c)
    Dsp.make_capacity_plan = tap
    try:
        with torch.no_grad():
            (_, aux), _ = counted(lambda: lm.loss_fn(
                params, cfg, batch, impl="fused", device=dev, dist=dist),
                False)
    finally:
        Dsp.make_capacity_plan = orig
        P.to_logical(params, plan_c)
    check(len(seen) == TRAIN_LAYERS, f"placement (c): {len(seen)} plans")
    drops = []
    for ids, caps in seen:
        arrivals = np.zeros(E, np.int64)
        kept = 0
        for e in ids.T.reshape(-1):  # slot-major
            kept += arrivals[e] < caps[e]
            arrivals[e] += 1
        drops.append(1.0 - kept / ids.size)
    host = float(np.mean(drops))
    got = float(aux["drop_frac"])
    print(f"placement fused/capacity plan (c) (owned capacity "
          f"{int(seen[0][1].min())}, shadowed {int(seen[0][1].max())}): "
          f"drop_frac {got:.6f}, host count {host:.6f} (layers "
          + " ".join(f"{d:.4f}" for d in drops) + ")", flush=True)
    check(host > 0 and abs(got - host) <= 1e-6,
          f"placement (c): drop_frac {got} against the host's {host}")


def placement_times(dev, base, mesh, batch, plans, counted):
    """Each PLACE_TIMED path's AdamW step unplaced and under (a) and (b),
    in turns on one set of params and moments (migrated between the turns,
    untimed), PLACE_STEPS timed after a warm one; then the migration of
    the whole 10-layer params and AdamW state from logical order to (b)
    and back: ms, peak memory, and the round trip bit-equal by row
    fingerprints."""
    import torch
    from repro_torch import placement as P
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW

    opt = AdamW()
    params = lm.init_params(base, seed=0, device=dev,
                            param_dtype=base.param_dtype)
    state = opt.init(params)
    names = ("unplaced", "a", "b")
    for impl, dispatch in PLACE_TIMED:
        cfg = with_dispatch(base, dispatch)
        plain = train.moe_dist(cfg, mesh, TRAIN_BATCH * TRAIN_SEQ)
        steps = {n: train.make_train_step(
            cfg, opt, dist=plain._replace(placement=pl), impl=impl,
            device=dev) for n, pl in zip(names, (None, *plans))}
        times = {n: [] for n in names}
        launches = {}
        for rnd in range(1 + PLACE_STEPS):
            for n, pl in zip(names, (None, *plans)):
                if pl is not None:
                    for t in (params, state.mu, state.nu):
                        P.from_logical(t, pl)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                (params, state, m), runs = counted(
                    lambda: steps[n](params, state, batch, rnd), False)
                wall = time.perf_counter() - t0
                check(math.isfinite(float(m["loss"])),
                      f"placement timing {n}: loss not finite")
                if pl is not None:
                    for t in (params, state.mu, state.nu):
                        P.to_logical(t, pl)
                if rnd:
                    times[n].append(wall * 1e3)
                    launches[n] = sum(runs.values())
        med = {n: statistics.median(v) for n, v in times.items()}
        print(f"placement train step {impl}/{dispatch} 1x1, {TRAIN_LAYERS}-"
              f"layer fastmoe-gpt, batch {TRAIN_BATCH}x{TRAIN_SEQ}, AdamW "
              f"included, in turns: "
              + ", ".join(f"{n} {med[n]:.1f} ms ({' '.join(f'{v:.1f}' for v in times[n])}; "
                          f"{launches[n]} launches)" for n in names)
              + f"; (a) - unplaced {med['a'] - med['unplaced']:+.1f} ms, (b)"
              f" - unplaced {med['b'] - med['unplaced']:+.1f} ms", flush=True)
    before = [row_fingerprints(t) for t in (params, state.mu, state.nu)]
    for label, plan in (("a", plans[0]), ("b", plans[1])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        for t in (params, state.mu, state.nu):
            P.from_logical(t, plan)
        torch.cuda.synchronize()
        there = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        moved = sum(not torch.equal(x, y) for x, y in
                    zip(before[0], row_fingerprints(params)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        for t in (params, state.mu, state.nu):
            P.to_logical(t, plan)
        torch.cuda.synchronize()
        back = (time.perf_counter() - t0) * 1e3
        peak = max(peak, torch.cuda.max_memory_allocated(dev))
        after = [row_fingerprints(t) for t in (params, state.mu, state.nu)]
        same = all(torch.equal(x, y) for b_, a_ in zip(before, after)
                   for x, y in zip(b_, a_))
        print(f"placement migrate plan ({label}): params and AdamW moments of "
              f"{TRAIN_LAYERS}-layer fastmoe-gpt ({held / 1e9:.2f} GB held), "
              f"to the plan {there:.1f} ms, back {back:.1f} ms; peak memory "
              f"of the migrations {peak / 1e9:.2f} GB (+"
              f"{(peak - held) / 1e9:.2f} GB scratch); "
              f"{moved} of {len(before[0])} expert param leaves moved; round "
              f"trip {'bit-equal' if same else 'DIFFERS'} (row fingerprints "
              f"of every expert leaf of params, mu and nu)", flush=True)
        check(same, f"placement migrate ({label}): the round trip differs")
        check(moved == len(before[0]), f"placement migrate ({label}): only "
              f"{moved} expert leaves moved")
        check(peak < 80e9, f"placement migrate: peak {peak / 1e9:.1f} GB")
    del params, state
    torch.cuda.empty_cache()


def placement_switch(dev, base, mesh, plan_a):
    """fused/ragged: run A trains 3 unplaced steps from seed 0; run B
    trains 2 through a ReplanHook's step, forces ``hook._switch`` to plan
    (a) (params and moments migrated, the step rebuilt) and takes the
    third under it.  Run B's losses, its third step's grad norm, and its
    params after it mapped to logical order must equal run A's bit for
    bit.  The hook's monitor, fed the real loads, resolves
    ``ragged_bound="auto"`` to the dropless 0 at one rank."""
    import torch
    from repro_torch import placement as P
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    cfg = with_dispatch(base, "ragged")
    opt = AdamW()
    runs, observe_ms = [], []
    for forced in (False, True):
        params = lm.init_params(base, seed=0, device=dev,
                                param_dtype=base.param_dtype)
        state = opt.init(params)
        hook = train.ReplanHook(cfg, opt, mesh, TRAIN_BATCH, TRAIN_SEQ,
                                every=PLACE_CLI_EVERY,
                                opts=dict(impl="fused", device=dev))
        step_fn = hook.build()
        losses = []
        for step in range(3):
            if forced and step == 2:
                params, state, step_fn = hook._switch(hook.placement, plan_a,
                                                      params, state)
            params, state, m = step_fn(params, state, batch_of(base, step, dev),
                                       step)
            losses.append(m["loss"])
            if not forced:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hook.observe(step, m, params, state)
                observe_ms.append((time.perf_counter() - t0) * 1e3)
        norm = m["grad_norm"]
        if forced:
            P.to_logical(params, plan_a)
            unequal = [i for i, (a, b) in enumerate(zip(runs[0][2],
                                                        tree_leaves(params)))
                       if not torch.equal(a.to(dev), b)]
            same = [torch.equal(a, b) for a, b in zip(runs[0][0], losses)]
            print(f"placement ReplanHook forced switch to plan (a) before "
                  f"step 2 (fused/ragged): losses "
                  + " ".join(f"{float(v):.6f}" for v in losses)
                  + f", unplaced run " + " ".join(f"{float(v):.6f}"
                                                  for v in runs[0][0])
                  + f" (equal {same}); step-2 grad norm "
                  f"{'equal' if torch.equal(norm, runs[0][1]) else 'UNEQUAL'}; "
                  f"{len(unequal)} of {len(runs[0][2])} params after it "
                  f"differ in logical order", flush=True)
            check(all(same) and torch.equal(norm, runs[0][1]) and not unequal,
                  f"placement forced switch: losses {same}, params {unequal}")
        else:
            auto = train.moe_dist(cfg, mesh, TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                  ragged_bound="auto",
                                  load_monitor=hook.monitor)
            print(f"placement ReplanHook at 1x1: monitor fed {hook.monitor.steps} "
                  f"steps (imbalance {hook.monitor.imbalance:.2f}; observe "
                  + " ".join(f"{v:.2f}" for v in observe_ms)
                  + f" ms of host time a step, after a synchronize), "
                  f"{hook.controller.replans} replans, ragged_bound='auto' "
                  f"resolves to {auto.ragged_bound}", flush=True)
            check(auto.ragged_bound == 0 and hook.controller.replans == 0,
                  f"placement hook at 1x1: bound {auto.ragged_bound}, "
                  f"{hook.controller.replans} replans")
            runs.append((losses, norm, [t.detach().cpu()
                                        for t in tree_leaves(params)]))
        del params, state, step_fn, hook
        torch.cuda.empty_cache()


def batch_of(cfg, step: int, dev):
    """SyntheticLM's batch ``step`` of 8 x 256 tokens from seed 0."""
    import torch
    from repro_torch.data import SyntheticLM
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
    for _ in range(step):
        next(data)
    return {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}


def placement_cli(dev):
    """``train --mesh 1x1 --replan_every 4 --ragged_bound auto --steps 12``
    (fused/ragged, 10 layers) and the same without the hook, in turns
    (hook, none), in this process over a world-size-1 NCCL
    group on localhost (the CLI's own init): the hook's runs record no
    replan, the bound resolves to 0, and the step times with and without
    the hook (the log's per-step ms, hook included, median of steps 2-11)
    are printed."""
    import contextlib as cl
    import io
    import os
    import socket
    import torch
    from repro_torch.launch import train

    common = ["--arch", "fastmoe-gpt", "--num_layers", str(TRAIN_LAYERS),
              "--mesh", "1x1", "--dispatch", "ragged", "--impl", "fused",
              "--steps", str(PLACE_CLI_STEPS), "--log_every", "1",
              "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
              "--max_bad_steps", "0"]  # the hook's cost alone, no guard
    med = collections.defaultdict(list)
    hook = ["--replan_every", str(PLACE_CLI_EVERY), "--ragged_bound", "auto"]
    for label, extra in (("with the hook", hook), ("without", [])):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            train.main(common + extra)
        lines = buf.getvalue().splitlines()
        step_ms = [float(ln.rsplit(", ", 1)[1].split()[0]) for ln in lines
                   if ln.startswith("step") and " loss " in ln]
        check(len(step_ms) == PLACE_CLI_STEPS, f"placement CLI {label}: "
              f"{len(step_ms)} step lines")
        med[label].append(statistics.median(step_ms[2:]))
        mesh_line = next(ln for ln in lines if ln.startswith("mesh"))
        place = [ln for ln in lines if ln.startswith("placement:")]
        print(f"placement train CLI {label} ({' '.join(extra) or 'no hook'}): "
              f"{mesh_line}; {place[0] if place else 'no placement line'}; "
              f"step {med[label][-1]:.1f} ms median of steps 2-"
              f"{PLACE_CLI_STEPS - 1} (" + " ".join(f"{v:.1f}" for v in step_ms)
              + "); losses "
              + " ".join(ln.split()[3] for ln in lines
                         if ln.startswith("step") and " loss " in ln),
              flush=True)
        if extra:
            check("ragged bound 0" in mesh_line and place
                  and place[0].startswith("placement: 0 replans"),
                  f"placement CLI: {mesh_line} / {place}")
        torch.cuda.empty_cache()
    hooked, plain = (statistics.mean(med[k]) for k in ("with the hook",
                                                       "without"))
    print(f"placement train CLI in turns (hook, none): with the "
          f"hook {' '.join(f'{v:.1f}' for v in med['with the hook'])} ms, "
          f"without {' '.join(f'{v:.1f}' for v in med['without'])} ms; "
          f"difference of the means {hooked - plain:+.1f} ms", flush=True)


# ---------------------------------------------------------------------------
# serving under placement (slice 15): the psum mode's slot-wise reduction,
# shadowed experts outside it, mid-stream replans, and the serve-time hook
# ---------------------------------------------------------------------------

# continuous_phase's stream (CB_*) over its 1x1 NCCL mesh in the placed
# psum mode, on these paths; plans (a) and (b) of placement_plans at the
# full 12 layers; the switches identity -> (b) after tick 8 and (b) -> (a)
# after tick 16; the CLI's replan period and its stream (8 requests)
SP_COMBOS = CB_PSUM
SP_SWITCH_TICKS = (8, 16)
SP_REPLAN_EVERY, SP_CLI_REQUESTS = 8, 8


def placed_copy(params, plan):
    """``params`` with fresh expert leaves in ``plan``'s physical order
    (every other leaf shared)."""
    from repro_torch import placement as P
    layers = [{**l, "ffn": {**l["ffn"], "experts": {
        k: v.clone() for k, v in l["ffn"]["experts"].items()}}}
        for l in params["layers"]]
    return P.from_logical({**params, "layers": layers}, plan)


def serve_placement_kernels(dev):
    """The kernels at the placed psum tick's shapes (fastmoe-gpt, 8 slots,
    top-2: 16 sorted rows over 96 experts, the last PLACE_SHADOW
    shadowed): the fused FFN on the owned segment (88 groups) and on the
    shadowed tail (8 groups), each launch planned for the whole buffer's
    16 rows and 96 experts, its rows bit-equal to the whole launch's; the
    grouped GEMM on the capacity tick's owned (88 x 8) and shadowed (8 x
    8) buffers, likewise; and combine_topk at k = 1 (the slot-wise
    combine: 16 rows, each one slot), bit-equal to its plain version.
    Each against its plain version, timed beside its bound and the
    library call where there is one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import dispatch as Dsp
    from repro_torch.kernels import fused_ffn as ff
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import token_shuffle as ts

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(PLACE_SEED + 1)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)
    S, n = PLACE_SHADOW, 2 * CB_SLOTS
    wi, wo = randn(E, D, H, scale=D ** -0.5), randn(E, H, D, scale=H ** -0.5)
    ids = routed(CB_SLOTS, 2, 0, dev, experts=E)
    gs = torch.bincount(ids.reshape(-1), minlength=E).to(torch.int32)
    lo = int(gs[:E - S].sum())
    x = randn(n, D)
    y_whole = ff.fused_ffn(x, (wi,), wo, gs, "gelu")
    own, tail = torch.zeros_like(x), torch.zeros_like(x)
    own[:lo], tail[:n - lo] = x[:lo], x[lo:]
    busy = lambda sizes: int((sizes > 0).sum())  # experts whose weights move
    C = Dsp.expert_capacity(CB_SLOTS, E, 2, 1.25)
    xc = randn(E * C, D)
    caps = torch.full((E,), C, dtype=torch.int32, device=dev)
    h_whole = gg.grouped_gemm(xc, wi, caps)
    cases = {
        ("fused_ffn", "owned"): (
            lambda: ff.fused_ffn(own, (wi[:E - S],), wo[:E - S], gs[:E - S],
                                 "gelu", plan_rows=n, plan_groups=E),
            lambda: ff.fused_ffn_plain(own, (wi[:E - S],), wo[:E - S],
                                       gs[:E - S], "gelu"),
            (y_whole[:lo], slice(0, lo)), 2 * lo * D * H * 2,
            4 * n * D + busy(gs[:E - S]) * 2 * D * H * 2, None),
        ("fused_ffn", "shadow"): (
            lambda: ff.fused_ffn(tail, (wi[E - S:],), wo[E - S:], gs[E - S:],
                                 "gelu", plan_rows=n, plan_groups=E),
            lambda: ff.fused_ffn_plain(tail, (wi[E - S:],), wo[E - S:],
                                       gs[E - S:], "gelu"),
            (y_whole[lo:], slice(0, n - lo)), 2 * (n - lo) * D * H * 2,
            4 * n * D + busy(gs[E - S:]) * 2 * D * H * 2, None),
        ("grouped_gemm", "owned"): (
            lambda: gg.grouped_gemm(xc[:(E - S) * C], wi[:E - S], caps[:E - S]),
            lambda: gg.grouped_gemm_plain(xc[:(E - S) * C], wi[:E - S],
                                          caps[:E - S]),
            (h_whole[:(E - S) * C], slice(None)), 2 * (E - S) * C * D * H,
            2 * (E - S) * (C * D + D * H + C * H),
            grouped_mm_call(xc[:(E - S) * C], wi[:E - S],
                            torch.cumsum(caps[:E - S], 0, dtype=torch.int32))),
        ("grouped_gemm", "shadow"): (
            lambda: gg.grouped_gemm(xc[(E - S) * C:], wi[E - S:], caps[:S]),
            lambda: gg.grouped_gemm_plain(xc[(E - S) * C:], wi[E - S:],
                                          caps[:S]),
            (h_whole[(E - S) * C:], slice(None)), 2 * S * C * D * H,
            2 * S * (C * D + D * H + C * H),
            grouped_mm_call(xc[(E - S) * C:], wi[E - S:],
                            torch.cumsum(caps[:S], 0, dtype=torch.int32))),
    }
    rows = torch.randperm(n, generator=g, device=dev).to(torch.int32)[:, None]
    w = torch.rand(n, 1, generator=g, device=dev).to(torch.bfloat16)
    cases[("combine_topk", "k=1")] = (
        lambda: ts.combine_topk(y_whole, rows, w),
        lambda: ts.combine_topk_plain(y_whole, rows, w),
        None, n * D, 2 * (2 * n * D) + 6 * n,
        lambda: F.embedding_bag(rows, y_whole, per_sample_weights=w,
                                mode="sum"))
    out = {}
    for (name, part), (kern, plain, want, flops, nbytes, lib) in cases.items():
        got = kern()
        ref = plain()
        torch.cuda.synchronize()
        err = close(f"serve placement {name} {part}", got, ref,
                    KERNEL_TOL["bfloat16"])
        if want is not None:
            check(torch.equal(got[want[1]], want[0]), f"serve placement "
                  f"{name} {part}: rows differ from the whole launch's")
        if name == "combine_topk":
            check(torch.equal(got, ref), "combine_topk k=1: not bit-equal to "
                                         "its plain version")
        ms, plain_ms = time_ms(kern, flush), time_ms(plain, flush)
        lib_ms = time_ms(lib, flush) if lib is not None else None
        b_ms, b_by = bound(nbytes, flops, "bfloat16")
        out.setdefault(name, {})[part] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, max_abs_err=err)
        shape = {"fused_ffn": f"16 rows, {'88' if part == 'owned' else '8'} "
                              f"groups (plan 16 x 96)",
                 "grouped_gemm": f"{'88' if part == 'owned' else '8'} x {C}",
                 "combine_topk": "16 rows x 1 slot"}[name]
        print(f"kernel {name:16s} serve placement {part} {shape} bf16: "
              f"{ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  plain "
              f"{plain_ms:.4f} ms  library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; max |err| "
              f"{err:.3e}" + ("; rows bit-equal to the whole launch's"
                              if want is not None else "; bit-equal"
                              if name == "combine_topk" else ""), flush=True)
    del flush
    return out


def serve_placement_phase(dev, base, params, params32, mesh, plain):
    """Serving under placement (ROADMAP §1 item 5) on continuous_phase's
    params (full-width 12-layer fastmoe-gpt, bf16), stream (CB_*) and 1x1
    NCCL mesh, in the placed psum mode, for SP_COMBOS: (i) each request's
    tokens under the identity per-layer plan (the slot-wise reduction),
    plan (a) (a seeded permutation per layer) and plan (b) ((a) with
    PLACE_SHADOW shadowed experts outside the all-reduce), each a main path
    of its own (counters at 0 just before, read just after), bit-equal to
    the identity-placed run's; (ii) the identity run switched to (b) after
    tick 8 and to (a) after tick 16 (``apply_placement``: the params
    migrated in place, ms printed), bit-equal as well; (iii) the first
    tick's logits under (b) (kernel path and bf16 einsum floor on the
    slot-wise path) against the f32 einsum oracle by the SERVE_* slack, and
    the placed tokens' agreement with the plain psum run's (``plain``);
    (iv) a steady tick in turns (median of CB_ROUNDS) of the plain psum,
    identity-placed and (b) batchers, and one profiled tick of each.
    ``plain``: the plain psum runs' tokens by (impl, dispatch).  Returns
    the launches, the profiled ticks' launches and the kernel rows
    (``serve_placement_kernels``)."""
    import torch
    from repro_torch import placement as P
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve import request_stream
    from repro_torch.launch.serve_api import ServeConfig

    t0 = time.perf_counter()
    kernels = serve_placement_kernels(dev)
    L = base.num_layers
    plan_a, plan_b, _ = placement_plans(L)
    ident = P.identity_per_layer(E, 1, L)
    plans = {"identity": ident, "a": plan_a, "b": plan_b}
    scfg = ServeConfig(slots=CB_SLOTS, block_size=CB_BLOCK, max_len=CB_MAX_LEN)
    kw = dict(prompt_len=CB_PROMPT, gen=CB_GEN)
    total = {k: 0 for k in counters()}
    per_tick = {}
    for impl, dispatch in SP_COMBOS:
        cfg = with_dispatch(base, dispatch)
        runs = {}
        for label, plan in (*plans.items(), ("switched", ident)):
            p = params if label == "identity" else placed_copy(params, plan)
            switches = ((zip(SP_SWITCH_TICKS, (plan_b, plan_a)))
                        if label == "switched" else ())
            runs[label] = run_continuous(
                f"{impl}/{dispatch} placed ({label}) psum 1x1", p, cfg, scfg,
                impl, dev, mesh=mesh, requests=CB_REQUESTS, placement=plan,
                switches=tuple(switches), **kw)
            for k, v in runs[label][2].items():
                total[k] += v
            del p
            torch.cuda.empty_cache()
        ref = runs["identity"][0]
        first = {}
        for label in ("a", "b", "switched"):
            got = runs[label][0]
            bad = [(i, j) for i in sorted(ref) for j, (u, v) in
                   enumerate(zip(ref[i], got[i])) if u != v]
            first[label] = bad[0] if bad else None
        n_tok = sum(len(v) for v in ref.values())
        agree = sum(u == v for i in ref for u, v in
                    zip(ref[i], plain[(impl, dispatch)][i])) / n_tok
        print(f"serve placement {impl}/{dispatch} psum 1x1, {CB_REQUESTS} "
              f"requests, {n_tok} tokens: plans (a), (b) and the switches "
              f"identity->(b)->(a) after ticks {SP_SWITCH_TICKS} against the "
              f"identity plan: first differing (request, token) "
              f"{json.dumps(first)} (null: bit-equal); tok/s "
              + ", ".join(f"{k} {v[1]['tok_s']:.1f}" for k, v in runs.items())
              + f"; migrations {' '.join(f'{v:.1f}' for v in runs['switched'][4])}"
              f" ms; placed (slot-wise) tokens equal to the plain psum run's "
              f"(combined reduction) {agree:.4f}", flush=True)
        check(all(v is None for v in first.values()),
              f"serve placement {impl}/{dispatch}: tokens differ from the "
              f"identity plan's at {first}")
        # (iii) the first tick's logits under (b)
        pb = placed_copy(params, plan_b)
        b = ContinuousBatcher(pb, cfg, scfg, mesh=mesh, impl=impl, device=dev,
                              placement=plan_b)
        for r in request_stream(cfg, num_requests=CB_SLOTS, **kw):
            b.submit(r)
        b._admit()
        tick_logits(f"{impl}/{dispatch} placed (b) psum 1x1, first tick", b,
                    params32)
        del b
        # (iv) steady ticks in turns: plain psum, identity-placed, (b)
        race = {name: filled(p, cfg, scfg, impl, dev, mesh=mesh, placement=pl,
                             **kw)
                for name, p, pl in (("plain psum", params, None),
                                    ("identity", params, ident),
                                    ("b", pb, plan_b))}
        med = tick_race(f"fastmoe-gpt {impl}/{dispatch} placed psum 1x1", race)
        for name, bt in race.items():
            per_tick[f"{impl}/{dispatch} placed psum 1x1 {name}"] = \
                profile_tick(f"{impl}/{dispatch} placed psum 1x1 {name}", bt)
        print(f"serve placement {impl}/{dispatch}: a steady tick identity "
              f"{med['identity'] - med['plain psum']:+.2f} ms, (b) "
              f"{med['b'] - med['plain psum']:+.2f} ms against the plain psum "
              f"tick ({med['plain psum']:.2f} ms)", flush=True)
        del race, pb
        torch.cuda.empty_cache()
    print(f"main path launches (placed continuous serving, psum 1x1): "
          f"{json.dumps(total)}", flush=True)
    return dict(launches=total, per_tick=per_tick, kernels=kernels, t0=t0)


def serve_placement_cli():
    """``serve --continuous --mesh 1x1 --replan_every SP_REPLAN_EVERY`` on
    fused/ragged (full width, SP_CLI_REQUESTS requests of the CB_* stream)
    and the same without the hook, in turns (hook, none), in this process
    over a world-size-1 NCCL group on localhost (the CLI's own init): the
    hook's run records no replan (at one rank the planner keeps the
    identity) and both print their tok/s."""
    import contextlib as cl
    import io
    import os
    import socket
    import torch
    from repro_torch.launch import serve

    common = ["--arch", "fastmoe-gpt", "--continuous", "--mesh", "1x1",
              "--impl", "fused", "--dispatch", "ragged", "--slots",
              str(CB_SLOTS), "--block_size", str(CB_BLOCK), "--max_len",
              str(CB_MAX_LEN), "--prompt_len", str(CB_PROMPT), "--gen",
              str(CB_GEN), "--requests", str(SP_CLI_REQUESTS)]
    rates = {}
    for label, extra in (("with the hook", ["--replan_every",
                                            str(SP_REPLAN_EVERY)]),
                         ("without", [])):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
        buf = io.StringIO()
        with cl.redirect_stdout(buf):
            serve.main(common + extra)
        line = buf.getvalue().splitlines()[0]
        rates[label] = float(line.split(" tok/s")[0].rsplit("(", 1)[1])
        replans = line.rsplit("replans=", 1)[1]
        print(f"serve placement CLI {label} ({' '.join(extra) or 'no hook'}): "
              f"{line}", flush=True)
        check(f"{SP_CLI_REQUESTS} requests" in line and replans == "0",
              f"serve placement CLI {label}: {line}")
        torch.cuda.empty_cache()
    print(f"serve placement CLI in turns (hook, none): "
          f"{rates['with the hook']:.1f} vs {rates['without']:.1f} tok/s",
          flush=True)
    return rates


def tp_shards(bwd_timed, name):
    """A kernel's times at the hidden shards of expert-internal tensor
    parallelism (the training rows' capacity buffer), where timed."""
    shards = {f"capacity h{h}": bwd_timed[(name, f"capacity tp h{h}")]
              for h in TP_HIDDEN if (name, f"capacity tp h{h}") in bwd_timed}
    return {"tp_shards": shards} if shards else {}


def chunk_rows(chunk_ms, name):
    """A kernel's times at the §5.2 schedule's chunk rows, where timed."""
    rows = {f"capacity {E}x{r}": chunk_ms[(name, r)]
            for r in (CAP_ROWS, *CHUNK_ROWS) if (name, r) in chunk_ms}
    return {"overlap_chunk_rows": rows} if rows else {}


def ep_by_path(ep_launches, name):
    """A kernel's launches on each EP training path at 1x1."""
    return {f"fastmoe-gpt EP training 1x1{'' if path == 'a2a' else ' ' + path}":
            runs[name] for path, runs in ep_launches.items()}


# ---------------------------------------------------------------------------
# resilience (slice 16): checkpoints, the step guard, fault drills, telemetry
# ---------------------------------------------------------------------------

# full-width fastmoe-gpt cut to 2 of 12 layers (0.92 B f32 params, ~11 GB
# with both AdamW moments: each save writes that, each restore hashes it,
# each snapshot copies it), 8 x 256 tokens, seed 0
RES_LAYERS, RES_STEPS = 2, 6
RES_DIR = ROOT / "build" / "resilience"  # checkpoints, inside the checkout
RES_TURNS, RES_TURN_STEPS = 2, 3  # guard + telemetry on / off, in turns


def res_cfg(dispatch):
    from repro_torch.configs import get_config
    return with_dispatch(dataclasses.replace(get_config("fastmoe-gpt"),
                                             num_layers=RES_LAYERS), dispatch)


def res_argv(impl, dispatch, *extra):
    """The train CLI's flags for the phase's model, data and path."""
    return ["--arch", "fastmoe-gpt", "--num_layers", str(RES_LAYERS),
            "--dispatch", dispatch, "--impl", impl, "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log_every", "1",
            *extra]


def res_run(cfg, impl, dev, *, guard=None, times=None, steps=RES_STEPS,
            then=None, start=None, verify=True):
    """The train CLI's loop through the functions it calls (params and data
    from seed 0, the faults applied after each step, the guard's check,
    restore and commit where given): (params, AdamW state, {step: loss}).
    ``times`` gains the guard's commit and restore ms (synchronized);
    ``then`` = (step, cfg, impl) switches the path from that step on;
    ``start`` = a checkpoint path: the run resumes from it, as ``--resume``
    does (the data stream replayed to the step after the checkpoint's),
    its sha256s checked with ``verify``; ``times["ckpt_restore"]``."""
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.resilience import faults

    params = lm.init_params(cfg, seed=0, device=dev,
                            param_dtype=cfg.param_dtype)
    opt = AdamW()
    state = opt.init(params)
    first = 0
    if start is not None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = ckpt.restore(start, {"params": params, "opt": state},
                            inplace=True, verify=verify)
        torch.cuda.synchronize()
        if times is not None:
            times["ckpt_restore"] = [(time.perf_counter() - t0) * 1e3]
        params, state = tree["params"], tree["opt"]
        first = ckpt.load_manifest(start)["step"] + 1
    step_fn = train.make_train_step(cfg, opt, impl=impl, device=dev)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
    for _ in range(first):
        next(data)

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if times is not None:
            times.setdefault(key, []).append((time.perf_counter() - t0) * 1e3)
        return out

    losses = {}
    if guard is not None:
        timed("commit", lambda: guard.commit(first - 1, params, state))
    for step in range(first, steps):
        if then is not None and step == then[0]:
            step_fn = train.make_train_step(then[1], opt, impl=then[2],
                                            device=dev)
        batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
        while True:
            params, state, m = step_fn(params, state, batch, step)
            params, state, m = faults.apply_step(params, state, m, step=step)
            loss, gnorm, drop = train._host_floats(m["loss"], m["grad_norm"],
                                                   m["drop_frac"])
            if guard is None or guard.check(step, loss=loss, grad_norm=gnorm,
                                            drop=drop).ok:
                break
            params, state = timed("restore", guard.restore)
        losses[step] = loss
        if guard is not None:
            timed("commit", lambda: guard.commit(step, params, state))
    return params, state, losses


def state_leaves(params, state) -> list:
    from repro_torch.optim.adamw import tree_leaves
    return tree_leaves((params, state.mu, state.nu))


def same_state(params, state, ref: list) -> bool:
    """Every param and moment bit-equal to ``ref`` (state_leaves')."""
    import torch
    got = state_leaves(params, state)
    return len(got) == len(ref) and all(torch.equal(a, b)
                                        for a, b in zip(got, ref))


def res_cli(tag, argv, faults_spec=None, mesh=False):
    """``train.main(argv)`` in this process with ``REPRO_FAULTS`` set to
    ``faults_spec`` and its records in a JSONL file (on a 1x1 mesh, the
    CLI's own NCCL init on localhost): (stdout lines, records, the faults
    that fired)."""
    import contextlib as cl
    import io
    import os
    import socket
    from repro_torch.launch import train
    from repro_torch.obs import sink as obs_sink
    from repro_torch.obs import trace as obs_trace
    from repro_torch.resilience import faults

    metrics = RES_DIR / f"{tag}.jsonl"
    if mesh:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                          RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    faults.clear()
    if faults_spec is not None:
        os.environ["REPRO_FAULTS"] = json.dumps(faults_spec)
    buf = io.StringIO()
    try:
        with cl.redirect_stdout(buf):
            train.main(argv + ["--metrics_out", str(metrics)])
    finally:
        os.environ.pop("REPRO_FAULTS", None)
        obs_trace.configure(enabled=False)
    fired = list(faults.fired)
    faults.clear()
    return (buf.getvalue().splitlines(), obs_sink.jsonl_records(str(metrics)),
            fired)


def res_losses(records) -> dict:
    return {r["step"]: r["loss"] for r in records if r["kind"] == "train_step"}


def span_ms(trace_path, name) -> list:
    from repro_torch.obs import trace as obs_trace
    return [e["dur"] / 1e3 for e in obs_trace.load_trace(str(trace_path))
            ["traceEvents"] if e["name"] == name]


def resilience_phase(dev):
    """Checkpoints, the step guard, the fault drills and telemetry on
    full-width fastmoe-gpt cut to RES_LAYERS layers, 8 x 256 tokens,
    fused/ragged, seed 0.  The machine counts every byte written to its
    disk (45 GiB a call), so the phase saves three ~11 GB checkpoints in
    all: (1) RES_STEPS uninterrupted steps (the losses, the final params
    and moments, and their ``ckpt.digests``); (2) a ``nonfinite`` fault at
    step 2: the guard skips, restores its host snapshot and retries, and
    the losses and final state are bit-equal to (1); (3) ``python -m
    repro_torch.launch.train`` checkpointing every 2 steps, crashed (exit
    137) before the publish of the step-3 save: the step-1 checkpoint
    intact, the torn save invisible; ``--resume`` in this process over a
    1x1 NCCL mesh (the a2a exchange, bit-equal to local at one rank) with
    ``--metrics_out`` and ``--trace``, the launch counters set to 0 just
    before and read just after, to step 5: its losses and final state (the
    step-5 manifest's sha256 of every array) bit-equal to (1), its records
    carrying the seven counters, the tallied collective bytes and their
    ratio, its trace the train_step, ckpt_save and ckpt_restore spans, and
    a ``corrupt_array`` fault rotting its checkpoint after the checksum;
    (4) ``restore_latest`` skips the rotted checkpoint (``ckpt_corrupt``)
    for step 1; (5) the same resume from step 1 on pallas/capacity (the
    grouped GEMM on a resumed path), through the functions the CLI calls,
    bit-equal to the run that switches to pallas/capacity after step 1;
    (6) over a 1x1 NCCL mesh with ``--ragged_bound 1024``, a
    ``drop_spike`` over ``--drop_patience 2`` steps rebuilds the step with
    the dropless bound (``drop_fallback applied=true``); (7) the collective
    tally of a step with the counters on and off; (8) a step with the
    guard and telemetry on and off, in turns.  Prints the save, restore,
    snapshot and guard times and the phase's wall; fails, before anything
    is written, when the host or the disk cannot hold what it needs.
    Returns the resumed runs' launches."""
    import os
    import shutil
    import torch
    import torch.distributed as tdist
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import comm
    from repro_torch.core.fmoe import DistConfig
    from repro_torch.core.sync import sync_grads
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.models import lm
    from repro_torch.obs import events as obs_events
    from repro_torch.obs import sink as obs_sink
    from repro_torch.obs import trace as obs_trace
    from repro_torch.obs.stats import StepStats
    from repro_torch.optim import AdamW
    from repro_torch.resilience import CheckpointManager, StepGuard, faults

    t_phase = time.perf_counter()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    RES_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    cfg = res_cfg("ragged")

    # (1) the uninterrupted run
    params, state, ref = res_run(cfg, "fused", dev)
    nbytes = state_bytes(params, state)
    avail, disk = host_room(RES_DIR)
    print(f"resilience: a {RES_LAYERS}-layer fastmoe-gpt state is "
          f"{nbytes / 1e9:.2f} GB; host MemAvailable {avail / 1e9:.2f} GB, "
          f"disk free under build/ {disk / 1e9:.2f} GB", flush=True)
    # two complete checkpoints and a torn save; the guard's pinned snapshot
    # and a save's host copies
    check(disk > 4 * nbytes, f"resilience: {disk / 1e9:.2f} GB of disk free, "
                             f"the drills need {4 * nbytes / 1e9:.2f}")
    check(avail > 3 * nbytes, f"resilience: {avail / 1e9:.2f} GB of host "
                              f"memory available, the drills need "
                              f"{3 * nbytes / 1e9:.2f}")
    ref_state = [t.clone() for t in state_leaves(params, state)]
    t0 = time.perf_counter()
    ref_digest = ckpt.digests({"params": params, "opt": state})
    digest_s = time.perf_counter() - t0
    print("resilience (1) uninterrupted fused/ragged: losses "
          + " ".join(f"{ref[s]:.6f}" for s in sorted(ref))
          + f"; digest of {len(ref_digest)} arrays in {digest_s:.1f} s",
          flush=True)
    del params, state

    # (2) a transient NaN: skip, restore, retry
    faults.clear()
    faults.arm({"kind": "nonfinite", "point": "train_step", "step": 2})
    sink = obs_sink.MemorySink()
    guard, times = StepGuard(sink=sink), {}
    params, state, got = res_run(cfg, "fused", dev, guard=guard, times=times)
    fired = list(faults.fired)
    faults.clear()
    check(len(fired) == 1 and fired[0]["fault_kind"] == "nonfinite",
          f"resilience (2): faults fired {fired}")
    kinds = [r["kind"] for r in sink.records]
    check(kinds == [obs_events.GUARD_SKIP, obs_events.GUARD_RESTORE],
          f"resilience (2): guard events {kinds}")
    check(got == ref, f"resilience (2): retried losses {got} != {ref}")
    check(same_state(params, state, ref_state), "resilience (2): the retried "
          "run's final params and moments != the uninterrupted run's")
    commits = times["commit"]
    again = statistics.median(commits[1:])
    print(f"resilience (2) NaN at step 2 skipped, restored and retried: "
          f"losses and final params and moments bit-equal to (1); snapshot "
          f"(device to pinned host, {nbytes / 1e9:.2f} GB) first "
          f"{commits[0]:.1f} ms (registering the buffer + copy), then "
          f"{again:.1f} ms median of {len(commits) - 1} "
          f"({nbytes / again / 1e6:.1f} GB/s); guard restore "
          f"{times['restore'][0]:.1f} ms", flush=True)
    del params, state, ref_state
    guard.sink = None  # reused in (8): its buffer is registered already
    torch.cuda.empty_cache()

    # (3) a crash before the step-3 save's publish, then --resume (both
    # without the guard, which (2) drills: each process would page-lock
    # another 11 GB for its snapshot)
    ck = RES_DIR / "ck"
    spec = [{"kind": "crash", "point": "ckpt_save_pre_commit", "at": 2}]
    env = dict(os.environ, PYTHONPATH=str(SRC), REPRO_FAULTS=json.dumps(spec))
    t0 = time.perf_counter()
    crashed = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train",
         *res_argv("fused", "ragged", "--steps", str(RES_STEPS), "--ckpt_dir",
                   str(ck), "--save_every", "2", "--max_bad_steps", "0")],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    crash_s = time.perf_counter() - t0
    check(crashed.returncode == faults.CRASH_EXIT_CODE,
          f"resilience (3): the crashed run exited {crashed.returncode}, not "
          f"{faults.CRASH_EXIT_CODE}: {crashed.stderr[-2000:]}")
    done = [s for s, _ in ckpt.complete_steps(str(ck))]
    check(done == [1] and ckpt.latest_step(str(ck)) == ckpt.step_path(str(ck), 1),
          f"resilience (3): after the crash {os.listdir(ck)}")
    torn = [d for d in os.listdir(ck) if d.startswith(".tmp-")]
    print(f"resilience (3) crash (exit {crashed.returncode}) at the step-3 "
          f"save's publish after {crash_s:.1f} s: complete checkpoints "
          f"{done}, the torn save {torn} invisible to latest_step", flush=True)
    trace = RES_DIR / "resume_trace.json"
    for f in counters().values():
        f.launches = 0
    lines, recs, fired = res_cli(
        "resume", res_argv("fused", "ragged", "--steps", str(RES_STEPS),
                           "--ckpt_dir", str(ck), "--resume", "--mesh", "1x1",
                           "--trace", str(trace), "--max_bad_steps", "0"),
        [{"kind": "corrupt_array", "point": "ckpt_save_file",
          "match": "opt/nu/embed/table", "at": 1}], mesh=True)
    res_launches = {k: f.launches for k, f in counters().items()}
    for name in needed_kernels("fused", "ragged"):
        check(res_launches[name] > 0, f"resilience (3): the resumed run never "
                                      f"launched {name}")
    check(any(ln.startswith("resumed from step 1") for ln in lines),
          f"resilience (3): {lines[:3]}")
    got = res_losses(recs)
    check(got == {s: ref[s] for s in range(2, RES_STEPS)},
          f"resilience (3): resumed losses {got} != {ref}")
    kinds = [r["kind"] for r in recs]
    check(kinds.count(obs_events.RESUME) == 1
          and kinds.count(obs_events.CKPT_SAVE) == 1,
          f"resilience (3): events {kinds}")
    final = {k: v["sha256"] for k, v in ckpt.load_manifest(
        ckpt.step_path(str(ck), RES_STEPS - 1))["params"].items()}
    check(final == ref_digest, "resilience (3): the resumed run's final "
                               "state != the uninterrupted run's")
    check(len(fired) == 1 and fired[0]["fault_kind"] == "corrupt_array",
          f"resilience (3): corrupt_array fired {fired}")
    steps = [r for r in recs if r["kind"] == "train_step"]
    want = {"wire_elems", "wire_bytes", "dropped", "shadow_hits", "imbalance",
            "wire_bytes_intra", "wire_bytes_inter", "modeled_all_to_all_bytes",
            "modeled_all_reduce_bytes", "wire_measured_over_modeled"}
    check(len(steps) == RES_STEPS - 2 and all(want <= set(r) for r in steps)
          and all(r["wire_bytes"] > 0 for r in steps),
          f"resilience (3): train_step records {[sorted(r) for r in steps]}")
    spans = {e["name"] for e in obs_trace.load_trace(str(trace))["traceEvents"]}
    check({"train_step", "ckpt_save", "ckpt_restore"} <= spans,
          f"resilience (3): spans {spans}")
    saves, restores = span_ms(trace, "ckpt_save"), span_ms(trace, "ckpt_restore")
    print(f"resilience (3) --resume over a 1x1 NCCL mesh from step 1 to "
          f"{RES_STEPS - 1}: losses and final state (the step-{RES_STEPS - 1} "
          f"manifest's sha256 of {len(final)} arrays) bit-equal to (1); save "
          + ", ".join(f"{v:.0f} ms ({nbytes / v / 1e6:.2f} GB/s)" for v in saves)
          + f"; restore with sha256 {restores[0]:.0f} ms "
          f"({nbytes / restores[0] / 1e6:.2f} GB/s); launches "
          f"{json.dumps({k: v for k, v in res_launches.items() if v})}",
          flush=True)
    print("resilience (3) telemetry: train_step records carry "
          f"{sorted(want)}; wire bytes a step "
          + " ".join(f"{r['wire_bytes']:.0f}" for r in steps)
          + "; modeled all-to-all bytes "
          + " ".join(f"{r['modeled_all_to_all_bytes']:.0f}" for r in steps)
          + "; wire_measured_over_modeled "
          + " ".join(f"{r['wire_measured_over_modeled']:.4f}" for r in steps)
          + f"; step wall s " + " ".join(f"{r['wall_s']:.4f}" for r in steps)
          + f"; spans {sorted(spans)}", flush=True)

    # (4) bit rot: the newest checkpoint fails its checksum, the next wins
    p = lm.init_params(cfg, seed=1, device=dev, param_dtype=cfg.param_dtype)
    like = {"params": p, "opt": AdamW().init(p)}
    sink = obs_sink.MemorySink()
    t0 = time.perf_counter()
    res = CheckpointManager(str(ck), sink=sink).restore_latest(like,
                                                              inplace=True)
    torch.cuda.synchronize()
    fallback_ms = (time.perf_counter() - t0) * 1e3
    events = [(r["kind"], r["step"]) for r in sink.records]
    check(res is not None and res[1] == 1
          and events == [(obs_events.CKPT_CORRUPT, RES_STEPS - 1),
                         (obs_events.RESUME, 1)],
          f"resilience (4): restore_latest {None if res is None else res[1]}, "
          f"events {events}")
    print(f"resilience (4) the step-{RES_STEPS - 1} checkpoint rotted after "
          f"its checksum: restore_latest skipped it ({events[0][0]}) and "
          f"restored step 1 in {fallback_ms:.0f} ms (hashing the rotted "
          f"one, then the step-1 restore with its sha256s)", flush=True)
    del p, like, res
    torch.cuda.empty_cache()

    # (5) the same resume on pallas/capacity, against the run that switches
    cap = res_cfg("capacity")
    params, state, ref2 = res_run(cfg, "fused", dev, then=(2, cap, "pallas"))
    ref2_state = [t.clone() for t in state_leaves(params, state)]
    del params, state
    torch.cuda.empty_cache()
    for f in counters().values():
        f.launches = 0
    times = {}
    params, state, got = res_run(cap, "pallas", dev, times=times,
                                 start=ckpt.step_path(str(ck), 1), verify=False)
    bare_ms = times["ckpt_restore"][0]
    launches = {k: f.launches for k, f in counters().items()}
    check(launches["grouped_gemm"] > 0,
          "resilience (5): the resumed pallas run never launched grouped_gemm")
    for k, v in launches.items():
        res_launches[k] += v
    check(got == {s: ref2[s] for s in range(2, RES_STEPS)}
          and same_state(params, state, ref2_state),
          f"resilience (5): pallas/capacity resumed losses {got} != {ref2}, "
          f"or its final state differs")
    print("resilience (5) pallas/capacity resumed from step 1: losses "
          + " ".join(f"{got[s]:.6f}" for s in sorted(got))
          + " and final params and moments bit-equal to the run that "
          f"switched after step 1; its restore without sha256 {bare_ms:.0f} ms "
          f"({nbytes / bare_ms / 1e6:.2f} GB/s); launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}",
          flush=True)
    del params, state, ref2_state
    torch.cuda.empty_cache()

    # (6) the dropless fallback over a 1x1 NCCL mesh
    lines, recs, _ = res_cli(
        "fallback", res_argv("fused", "ragged", "--steps", "4", "--mesh",
                             "1x1", "--ragged_bound", "1024",
                             "--drop_patience", "2"),
        [{"kind": "drop_spike", "point": "train_step", "step": 0, "until": 2,
          "value": 0.9}], mesh=True)
    fb = [r for r in recs if r["kind"] == obs_events.DROP_FALLBACK]
    check(len(fb) == 1 and fb[0]["applied"] is True and fb[0]["step"] == 1
          and any("forced dropless ragged bound" in ln for ln in lines),
          f"resilience (6): fallback records {fb}")
    steps = [r for r in recs if r["kind"] == "train_step"]
    check(len(steps) == 4 and all(r["dropped"] == 0.0 for r in steps[2:]),
          f"resilience (6): dropped rows a step {[r['dropped'] for r in steps]}")
    print("resilience (6) drop spike over 2 steps on --ragged_bound 1024 (1x1 "
          "NCCL): dropless rebuild at step 1 (drop_fallback applied=true); "
          "dropped rows a step "
          + " ".join(f"{r['dropped']:.0f}" for r in steps)
          + "; wire bytes " + " ".join(f"{r['wire_bytes']:.0f}" for r in steps),
          flush=True)

    # (7) the collectives of a step with the counters on and off
    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        mesh = make_local_mesh(1, 1)
        params = lm.init_params(cfg, seed=0, device=dev,
                                param_dtype=cfg.param_dtype)
        batch = batch_of(cfg, 0, dev)
        seen = {}
        for obs in (True, False):
            dist = DistConfig(mesh, ("data", "model"), obs=obs)
            comm.tally_reset()
            loss, aux, grads = train.loss_and_grads(
                params, cfg, batch, impl="fused", device=dev, dist=dist)
            sync_grads(grads, dist)
            torch.cuda.synchronize()
            seen[obs] = (comm.tallied_calls(), comm.tallied(), float(loss),
                         float(aux["wire_bytes"]))
            del grads
        check(seen[True][:3] == seen[False][:3] and seen[True][3] > 0
              and seen[False][3] == 0.0,
              f"resilience (7): tally on {seen[True]} / off {seen[False]}")
        print(f"resilience (7) a step's collectives with the counters on and "
              f"off (1x1 NCCL), the same: calls {json.dumps(seen[True][0])}, "
              f"bytes {json.dumps(seen[True][1])}; the loss equal", flush=True)
        del params
    finally:
        tdist.destroy_process_group()

    # (8) a step with the guard and telemetry on and off, in turns
    params = lm.init_params(cfg, seed=0, device=dev,
                            param_dtype=cfg.param_dtype)
    opt = AdamW()
    state = opt.init(params)
    step_fn = train.make_train_step(cfg, opt, impl="fused", device=dev)
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, seed=0).batches(TRAIN_BATCH)
    sink = obs_sink.MemorySink()
    obs_trace.configure(enabled=True)
    step, ms = 0, collections.defaultdict(list)

    def steps_ms(on):
        nonlocal params, state, step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(RES_TURN_STEPS):
            batch = {"tokens": torch.from_numpy(next(data)["tokens"]).to(dev)}
            ts = time.perf_counter()
            comm.tally_reset()
            with (obs_trace.span("train_step", step=step) if on
                  else contextlib.nullcontext()):
                params, state, m = step_fn(params, state, batch, step)
                if on:
                    torch.cuda.synchronize()
            if on:
                keys = [k for k in train.STEP_COUNTERS if k in m]
                out = dict(zip(keys, train._host_floats(*(m[k] for k in keys))))
                guard.check(step, loss=out["loss"], drop=out["drop_frac"],
                            grad_norm=train._host_floats(m["grad_norm"])[0])
                sink.emit(StepStats("train_step", step,
                                    time.perf_counter() - ts, counters=out,
                                    modeled=comm.tallied()).record())
                guard.commit(step, params, state)
            step += 1
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / RES_TURN_STEPS

    steps_ms(True)  # warm (the guard's buffer is registered from (2))
    for _ in range(RES_TURNS):
        for on in (False, True):
            ms[on].append(steps_ms(on))
    obs_trace.configure(enabled=False)
    off, on = (statistics.mean(ms[k]) for k in (False, True))
    print(f"resilience (8) a {RES_LAYERS}-layer fused/ragged step in turns "
          f"(off, on; the mean of {RES_TURN_STEPS} steps each): guard and "
          f"telemetry off {' '.join(f'{v:.1f}' for v in ms[False])} ms, on "
          f"(host read, snapshot, sync, tally, record) "
          f"{' '.join(f'{v:.1f}' for v in ms[True])} ms; difference of the "
          f"means {on - off:+.1f} ms ({on / off:.2f}x)", flush=True)
    del params, state, step_fn, guard
    torch.cuda.empty_cache()
    shutil.rmtree(RES_DIR, ignore_errors=True)
    print(f"resilience phase wall {time.perf_counter() - t_phase:.1f} s; "
          f"three {nbytes / 1e9:.2f} GB checkpoints written", flush=True)
    return res_launches


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

    def mark(phase):  # where the script's wall time goes
        print(f"timeline: {phase} done at {time.perf_counter() - t0:.1f} s",
              flush=True)
    libs = _build.build_all()
    print(f"built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    ptxas_report(libs)
    dynamic_smem_report()

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    errs, timed = kernel_phase(dev, flush)
    mark("kernel_phase")
    bwd_errs, bwd_timed = bwd_kernel_phase(dev, flush)
    mark("bwd_kernel_phase")
    ds_bwd = ds_bwd_kernel_phase(dev, flush)
    mark("ds_bwd_kernel_phase")
    fa_errs, fa_timed = flash_phase(dev, flush)
    mark("flash_phase")
    del flush
    small_reference(dev)
    mark("small_reference")
    small_reference_train(dev)
    mark("small_reference_train")
    launches = serve_phase(dev)
    mark("serve_phase")
    torch.cuda.empty_cache()  # the serving params are gone with serve_phase
    train_launches, _, routing = train_phase(dev)
    mark("train_phase")
    ep_launches = ep_phase(dev)
    mark("ep_phase")
    ep_launches["overlap"], chunk_ms = overlap_phase(dev)
    mark("overlap_phase")
    print("hierarchical (two-level) exchange: not run here; it needs 1 < "
          "nodes < ranks, at least 4 ranks, and this machine has one card "
          "(the CPU tests hold it over gloo)", flush=True)
    init_phase(dev)
    mark("init_phase")
    cb_launches, cb_tick, served = continuous_phase(dev)
    mark("continuous_phase")
    routing_ms = model_routing_phase(dev, routing)
    mark("model_routing_phase")
    grad_oracle_phase(dev)
    mark("grad_oracle_phase")
    starcoder2_logits_phase(dev)
    mark("starcoder2_logits_phase")
    sc2_launches = starcoder2_serve_phase(dev)
    mark("starcoder2_serve_phase")
    deepseek_logits_phase(dev)
    mark("deepseek_logits_phase")
    ds_launches, dsc_launches, dsc_tick = deepseek_serve_phase(dev)
    mark("deepseek_serve_phase")
    zoo_launches = router_phase(dev)
    mark("router_phase")
    sw_launches, sw_train_launches = switch_phase(dev)
    mark("switch_phase")
    arctic_launches = arctic_phase(dev)
    mark("arctic_phase")
    dense_launches = dense_phase(dev)
    mark("dense_phase")
    dst_launches = deepseek_train_phase(dev)
    mark("deepseek_train_phase")
    place_launches, place_kernels = placement_phase(dev)
    mark("placement_phase")
    res_launches = resilience_phase(dev)
    mark("resilience_phase")
    slice13 = {"fastmoe-gpt routing zoo training (step 0, 10 paths)":
               zoo_launches,
               "switch-base-128 serving": sw_launches,
               "switch-base-128 training": sw_train_launches,
               "arctic-480b serving": arctic_launches,
               **{f"{n} serving": v for n, v in dense_launches.items()},
               "fastmoe-gpt placed training (1x1, step 0: plans a and b "
               "in a2a and the psum mode, a locally on fused/ragged)":
                   place_launches,
               "fastmoe-gpt placed continuous serving (psum 1x1: identity, "
               "a, b, switched)": served["launches"],
               "fastmoe-gpt resumed training (2 layers, from step 1: "
               "fused/ragged over a 1x1 mesh, pallas/capacity; steps "
               "2-5 each)": res_launches}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    replaces = {
        "grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                         "src/repro/kernels/grouped_gemm.py:49"),
        "gather_rows": ("src/repro_torch/csrc/token_shuffle.cu",
                        "src/repro/kernels/token_shuffle.py:29"),
        "gather_rows_by_source": ("src/repro_torch/csrc/token_shuffle.cu",
                                  "src/repro/kernels/token_shuffle.py:29"),
        "combine_topk": ("src/repro_torch/csrc/token_shuffle.cu",
                         "src/repro/kernels/token_shuffle.py:56"),
        "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                      "src/repro/kernels/fused_ffn.py:111"),
    }
    kernels = []
    for name, (source, rep) in replaces.items():
        t = timed[(name, "decode")]
        by_shape = {shape: v for (n, shape), v in timed.items()
                    if n == name and name in SHUFFLE_KERNELS}
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": rep,
            "launches": launches[name],
            "launches_by_path": {"fastmoe-gpt serving": launches[name],
                                 "fastmoe-gpt continuous serving": cb_launches[name],
                                 "deepseek-v2-236b continuous serving": dsc_launches[name],
                                 "fastmoe-gpt training": train_launches[name],
                                 **ep_by_path(ep_launches, name),
                                 **{k: v[name] for k, v in slice13.items()},
                                 "deepseek-v2-236b training":
                                     dst_launches[name]},
            "launches_per_tick": {**{f"fastmoe-gpt {k}": v.get(name, 0)
                                     for k, v in {**cb_tick,
                                                  **served["per_tick"]}.items()},
                                  "deepseek-v2-236b fused/ragged paged":
                                      dsc_tick.get(name, 0)},
            "max_abs_err": errs[(name, "bfloat16", "decode")],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "decode, batch 8, bf16",
            **({"by_shape": by_shape} if by_shape else {}),
            **({"deepseek_train": ds_bwd["fused_ffn"]} if name == "fused_ffn"
               else {}),
            **({"placement": place_kernels[name]} if name in place_kernels
               else {}),
            **({"serve_placement": served["kernels"][name]}
               if name in served["kernels"] else {}),
            **tp_shards(bwd_timed, name), **chunk_rows(chunk_ms, name)})
    for name, rep in (("fused_ffn_bwd_dx", "src/repro/kernels/fused_ffn_bwd.py:190"),
                      ("fused_ffn_bwd_dw", "src/repro/kernels/fused_ffn_bwd.py:228")):
        kind = name[-2:]
        t = bwd_timed[(name, "ragged")]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/fused_ffn_bwd.cu", "replaces": rep,
            "launches": train_launches[name],
            "launches_by_path": {"fastmoe-gpt training": train_launches[name],
                                 **ep_by_path(ep_launches, name),
                                 **{k: v[name] for k, v in slice13.items()},
                                 "deepseek-v2-236b training":
                                     dst_launches[name]},
            "deepseek_train": ds_bwd[name],
            **({"placement": place_kernels[name]} if name in place_kernels
               else {}),
            "max_abs_err": bwd_errs[(name, "bfloat16", "ragged", "gelu")],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "first_version_ms": t["first_version_ms"],
            "first_version_max_abs_err": bwd_errs[(name + "_simple", "bfloat16",
                                                   "ragged", "gelu")],
            "skewed_ms": bwd_timed[("fused_ffn_bwd", "skewed")][kind],
            "model_routing_ms": routing_ms[kind],
            "model_routing_first_version_ms": routing_ms[kind + "_first"],
            **tp_shards(bwd_timed, name), **chunk_rows(chunk_ms, name),
            "shape": "train, 2048 tokens top-2 = 4096 ragged rows, bf16"})
    for name, rep in (("flash_attention_fwd", "src/repro/kernels/flash_attention.py:73"),
                      ("flash_attention_bwd", "src/repro/models/attention.py:67")):
        t = fa_timed[(name, "starcoder2")]
        by_path = {"fastmoe-gpt serving": launches[name],
                   "fastmoe-gpt continuous serving": cb_launches[name],
                   "fastmoe-gpt training": train_launches[name],
                   **ep_by_path(ep_launches, name),
                   "starcoder2-15b serving": sc2_launches[name],
                   **{k: v[name] for k, v in slice13.items()}}
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu", "replaces": rep,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": fa_errs[(name, "bfloat16", "starcoder2")],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": "one starcoder2-15b kv group: 2 x 8192, 12 heads over 1 "
                     "kv head x 128, window 4096, bf16"})
    # MLA's instances (dk 192, dv 128): the forward runs once a layer in
    # each deepseek prefill and training forward, the backward once a layer
    # in each deepseek training step
    for name, (shape, kname, _) in FLASH_FULL.items():
        t = fa_timed[(kname, name)]
        rep = ("src/repro/kernels/flash_attention.py:73" if kname.endswith("fwd")
               else "src/repro/models/attention.py:67")
        fwd = kname.endswith("fwd")
        runs = ds_launches[kname] if fwd else dst_launches[kname]
        B, S, H, KV, dk, dv, _ = shape
        kernels.append({
            "name": f"{kname} (dk {dk}, dv {dv})", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu", "replaces": rep,
            "launches": runs, "launches_by_path": {
                "deepseek-v2-236b serving": ds_launches[kname] if fwd else 0,
                "deepseek-v2-236b continuous serving":
                    dsc_launches[kname] if fwd else 0,
                "deepseek-v2-236b training": dst_launches[kname]},
            "max_abs_err": fa_errs[(kname, "bfloat16", name)],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
            "shape": f"{B}x{S}, {H}/{KV} heads, dk {dk}, dv {dv}, causal, bf16"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
