"""Static-decode A/B of two source trees on one GPU.

Runs the static serving path of full-width fastmoe-gpt (weights from seed
0, batch 8 x prompt 128, greedy) in fresh processes, one tree after the
other in ABBA order, so that a change in host time per decode step can be
told from the spread between runs:

    python scripts/decode_ab.py --trees PARENT_DIR CHANGE_DIR --pairs 10 \
        [--out decode_ab.jsonl]

Each run is one process with ``TREE/src`` first on its path.  For each of
fused/ragged, pallas/ragged and fused/capacity it runs one warm-up, then
``--reps`` rounds (the paths in turns) of a prefill and 31 decode steps,
each step ``lm.decode_step`` and its argmax ending in a device
synchronize, as ``serve.generate(timings=)`` times it.  A run reports, per
path, the median wall time of a step and the mean CPU time of the
process a step (``time.process_time``: the host work, without the waits
of a shared host; a mean, since that clock may tick in 10 ms steps, and
the sum of a run's steps is exact to a tick).  The summary gives, per path, each tree's median over
runs and, over the pairs, the median of change minus parent and how many
pairs the change was slower in.  The trees' kernels are built first, one
tree at a time (each tree builds into its own ``build/``).
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

COMBOS = (("fused", "ragged"), ("pallas", "ragged"), ("fused", "capacity"))
BATCH, PROMPT, GEN = 8, 128, 32


def worker(reps: int) -> None:
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    dev = torch.device("cuda", 0)
    base = get_config("fastmoe-gpt")
    params = lm.init_params(base, seed=0, device=dev)
    prompt = torch.randint(0, base.vocab_size, (BATCH, PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    def cfg_of(dispatch):
        return dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, dispatch=dispatch))

    def run(impl, dispatch, steps):
        cfg = cfg_of(dispatch)
        cache = lm.init_cache(cfg, BATCH, PROMPT + GEN, device=dev)
        logits, cache, _ = lm.prefill(params, cfg, prompt, cache, impl=impl,
                                      device=dev)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        torch.cuda.synchronize()
        wall, cpu = [], []
        for pos in range(PROMPT, PROMPT + steps):
            t0, c0 = time.perf_counter(), time.process_time()
            logits, cache, _ = lm.decode_step(params, cfg, tok, pos, cache,
                                              impl=impl, device=dev)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            cpu.append(time.process_time() - c0)
        return wall, cpu

    for impl, dispatch in COMBOS:  # warm-up: first-call costs out of the timing
        run(impl, dispatch, 2)
    got = {f"{i}/{d}": ([], []) for i, d in COMBOS}
    for _ in range(reps):
        for impl, dispatch in COMBOS:
            wall, cpu = run(impl, dispatch, GEN - 1)
            got[f"{impl}/{dispatch}"][0].extend(wall)
            got[f"{impl}/{dispatch}"][1].extend(cpu)
    print(json.dumps({k: {"wall_ms": statistics.median(w) * 1e3,
                          "cpu_ms": statistics.fmean(c) * 1e3,
                          "steps": len(w)} for k, (w, c) in got.items()}))


def one_run(tree: Path, reps: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(tree / "src"))
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--worker", "--reps", str(reps)], cwd=tree, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise RuntimeError(f"run in {tree} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("PARENT", "CHANGE"))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        worker(args.reps)
        return 0
    trees = {"parent": Path(args.trees[0]).resolve(),
             "change": Path(args.trees[1]).resolve()}
    for tree in trees.values():
        subprocess.run([sys.executable, "-c", "from repro_torch.kernels import "
                        "_build; _build.build_all()"], cwd=tree, check=True,
                       env=dict(os.environ, PYTHONPATH=str(tree / "src")),
                       capture_output=True, timeout=900)
    runs = {"parent": [], "change": []}
    sink = open(args.out, "a") if args.out else None
    for pair in range(args.pairs):
        order = ("parent", "change") if pair % 2 == 0 else ("change", "parent")
        for who in order:
            rec = one_run(trees[who], args.reps)
            runs[who].append(rec)
            line = json.dumps({"pair": pair, "tree": who, **rec})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    for combo in (f"{i}/{d}" for i, d in COMBOS):
        parts = []
        for metric in ("wall_ms", "cpu_ms"):
            p = [r[combo][metric] for r in runs["parent"]]
            c = [r[combo][metric] for r in runs["change"]]
            diff = [b - a for a, b in zip(p, c)]
            parts.append(
                f"{metric} parent {statistics.median(p):.2f} ({min(p):.2f}-"
                f"{max(p):.2f}), change {statistics.median(c):.2f} "
                f"({min(c):.2f}-{max(c):.2f}), change - parent median "
                f"{statistics.median(diff):+.2f}, slower in "
                f"{sum(d > 0 for d in diff)} of {len(diff)} pairs")
        print(f"decode A/B {combo}: " + "; ".join(parts), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
