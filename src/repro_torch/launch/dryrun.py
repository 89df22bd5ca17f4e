"""Dry run: every (arch x input shape x mesh) step on the meta device, one
rank's, without a card: the per-rank bytes, whether the step fits the
card, and its roofline.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh 16x16
    python -m repro_torch.launch.dryrun --arch fastmoe-gpt --shape train_4k \\
        --mesh 2x4 --out experiments/dryrun_torch

For each combination one rank runs the step the shape names on tensors of
the ``meta`` device (shapes and dtypes only; nothing is computed or held):
the train step (forward, backward, the gradient sync and AdamW, params and
moments in the train layout of ``launch/sharding``), the prefill forward
(serving params, the cache filled), or one decode step against a cache of
the sequence's length.  Serving draws its params under the serving layout
(``launch/sharding.serve_layout``: the train-mode specs, or with ``--opts
serve_tp`` the serve-mode ones; ``head_aware``; a dense config's tiny
batch drops both, as the reference's dry run does) and computes GQA
attention, the dense FFN, the embedding and the head tensor-parallel.  Meshes: ``16x16`` (the reference's single pod),
the port's own ``DxM`` and ``DxNxM``; ``1x1`` is the single-process path.
The collectives run through a fake process group (``torch.testing.
_internal.distributed.fake_pg``: rank 0 of a world of D*M ranks, no peer),
and ``core.comm`` tallies their bytes.

What it reports (and writes as one JSON a combination under ``--out``):

* state bytes: the rank's params, gradients and AdamW moments, summed over
  its meta tensors (the moments: 8 B a param);
* the peak: the resident state (params and moments, or params and cache)
  and the most bytes of meta storage the step holds above it at once,
  from ``torch.distributed._tools.mem_tracker.MemTracker``; and that
  activation peak above the resident params and moments;
* ``fits``: the peak and ``ALLOCATOR_SLACK`` of it within the card's
  memory (``--card_bytes``), and the largest depth that does so;
* the roofline (``launch/roofline``): operations, bytes and collective
  bytes per rank, counted as the step runs (``roofline.Count``).

Data-dependent ops have no values on meta: the ragged plan's group sizes
(``core/dispatch.make_ragged_plan``'s bincount) and the grouped dW's per-
group loop (``kernels/grouped_gemm.grouped_dw_plain``) take even groups,
and every kernel wrapper takes its meta branch (the kernel's outputs and
workspaces allocated, its count entered in ``kernels.cost``).  The bytes a
path allocates follow its row counts and bounds, not how the rows split
among experts; its operations are those of even groups.

Depth: the step runs at 1 and at 2 layers, and the whole stack is composed
as the one-layer program + (L - 1) x the second layer's increment (the
reference's full program + (L - 1) x layer probe), for the roofline and
the peak alike.  This bounds the run time of every family, and most of
all of the recurrent ones (rwkv6 and hymba's mamba heads), whose time
loops (``models/rwkv6.wkv_scan``, ``models/mamba.ssm_scan``) run once per
position: two layers of them, not L.  :func:`largest_depth` solves the
same line for the deepest stack that fits.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as tdist

from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config
from repro_torch.core.fmoe import DistConfig, moe_dist
from repro_torch.core.sync import sync_grads
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve import cache_len_for, serve_setup
from repro_torch.launch.sharding import make_layout
from repro_torch.launch.train import loss_and_grads
from repro_torch.models import lm
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import tree_leaves
from repro_torch.placement.calibrate import H100_SXM5_HBM_BYTES

META = torch.device("meta")
CARD_BYTES = H100_SXM5_HBM_BYTES
# the caching allocator's rounding and the fragmentation of its cached
# blocks: a step fits where its peak and this share of it fit the card
ALLOCATOR_SLACK = 0.05


def parse_mesh(name: str) -> tuple:
    """"DxM" or "DxNxM" -> (data, node, model)."""
    dims = [int(v) for v in name.lower().split("x")]
    if len(dims) not in (2, 3) or min(dims) < 1:
        raise ValueError(f"mesh {name!r}: DxM or DxNxM")
    return dims[0], dims[1] if len(dims) == 3 else 1, dims[-1]


class _FakeWorld:
    """A fake process group of ``world`` ranks (this process rank 0) and
    the mesh over it; None for one rank (the single-process path)."""

    def __init__(self, name: str):
        self.data, self.node, self.model = parse_mesh(name)
        self.world = self.data * self.node * self.model
        self.mesh = None

    def __enter__(self):
        if self.world == 1:
            return self
        if tdist.is_initialized():
            raise RuntimeError("the dry run's fake process group needs a "
                               "process without one")
        from torch.testing._internal.distributed.fake_pg import FakeStore
        tdist.init_process_group("fake", store=FakeStore(), rank=0,
                                 world_size=self.world)
        self.mesh = make_local_mesh(self.data, self.model, self.node)
        return self

    def __exit__(self, *exc):
        if self.mesh is not None:
            tdist.destroy_process_group()
        return False


def _inputs(cfg, rows: int, seq: int) -> dict:
    batch = {"tokens": torch.empty(rows, seq, dtype=torch.int64,
                                   device=META)}
    dtype = getattr(torch, cfg.dtype)
    if cfg.frontend == "vision":
        batch["patches"] = torch.empty(rows, cfg.num_patches, cfg.d_model,
                                       dtype=dtype, device=META)
    if cfg.family == "audio":
        batch["frames"] = torch.empty(rows, cfg.encoder.num_frames,
                                      cfg.d_model, dtype=dtype, device=META)
    return batch


def _rows(batch: int, dist) -> int:
    if dist is None or dist.mesh is None:
        return batch
    return batch // dist.mesh.axes_size(dist.token_axes)


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _train(cfg, shape, mesh, impl: str, out: dict, region,
           opts=None) -> None:
    """One train step of the rank: forward and backward, the sync, AdamW."""
    B, S = shape.global_batch, shape.seq_len
    layout = dist = None
    if mesh is not None:
        layout = make_layout(cfg, mesh, "train")
        dist = moe_dist(cfg, mesh, B, seq_len=S, layout=layout)
        if dist is None:  # no experts: data parallelism under the layout
            axes = tuple(mesh.axis_names)
            if B % mesh.size:
                axes = ("data",) if B % mesh.shape["data"] == 0 else ()
            dist = DistConfig(mesh, axes, layout=layout)
    params = lm.init_params(cfg, device=META, param_dtype=cfg.param_dtype,
                            layout=layout)
    opt = AdamW()
    state = opt.init(params)
    out["params"] = _tensor_bytes(params)
    out["moments"] = _tensor_bytes((state.mu, state.nu))
    batch = _inputs(cfg, _rows(B, dist), S)
    with region(params, state.mu, state.nu):
        _, _, grads = loss_and_grads(params, cfg, batch, impl=impl,
                                     device=META, dist=dist)
        out["grads"] = _tensor_bytes(grads)
        if dist is not None:
            sync_grads(grads, dist)
        opt.update(grads, state, params, dist=dist)
        del grads


def _serve_setup(cfg, shape, mesh, opts=None):
    """(params, dist, rows) of serving ``shape`` on ``mesh``: the params
    drawn under the serving layout of the shape's batch (the reference's
    train- or serve-mode specs by ``opts``, and its tiny-batch policy,
    ``launch/sharding.serve_layout``), the rank's rows of the batch."""
    B = shape.global_batch
    layout, dist = serve_setup(cfg, mesh, B, opts)
    params = lm.init_params(cfg, device=META, layout=layout)
    rows = B // mesh.shape["data"] if (
        dist is not None and "data" in dist.token_axes) else B
    return params, dist, rows


def _layout(dist):
    return None if dist is None else dist.layout


def _prefill(cfg, shape, mesh, impl: str, out: dict, region,
             opts=None) -> None:
    params, dist, rows = _serve_setup(cfg, shape, mesh, opts)
    out["params"] = _tensor_bytes(params)
    batch = _inputs(cfg, rows, shape.seq_len)
    cache = lm.init_cache(cfg, rows, cache_len_for(cfg, shape.seq_len),
                          device=META, layout=_layout(dist))
    out["cache"] = _tensor_bytes(cache)
    with region(params, cache), torch.no_grad():
        lm.prefill(params, cfg, batch["tokens"], cache, impl=impl,
                   device=META, dist=dist, frames=batch.get("frames"),
                   patches=batch.get("patches"))


def _decode(cfg, shape, mesh, impl: str, out: dict, region,
            opts=None) -> None:
    params, dist, rows = _serve_setup(cfg, shape, mesh, opts)
    out["params"] = _tensor_bytes(params)
    enc = (torch.empty(rows, cfg.encoder.num_frames, cfg.d_model,
                       dtype=getattr(torch, cfg.dtype), device=META)
           if cfg.family == "audio" else None)
    cache = lm.init_cache(cfg, rows, cache_len_for(cfg, shape.seq_len),
                          device=META, enc_out=enc, layout=_layout(dist))
    out["cache"] = _tensor_bytes(cache)
    tokens = torch.empty(rows, 1, dtype=torch.int64, device=META)
    with region(params, cache), torch.no_grad():
        lm.decode_step(params, cfg, tokens, shape.seq_len - 1, cache,
                       impl=impl, device=META, dist=dist)


PROGRAMS = {"train": _train, "prefill": _prefill, "decode": _decode}


def measure(cfg, shape, mesh, *, impl: str = "fused",
            n_devices: int = 1, opts: dict | None = None) -> dict:
    """One program on meta: {"roofline": the step's Roofline, "peak": the
    most bytes live at once over the step, the resident state (registered
    with the tracker before the step) included, the state bytes it
    reports, "kernels": the kernels' counts}.  The set-up
    (params, moments, cache) runs outside the count: the step alone is
    counted, as on the card, where its peak is read after the set-up.
    ``opts``: serving's layout options (``serve_tp``, ``head_aware``)."""
    import contextlib
    from torch.distributed._tools.mem_tracker import MemTracker
    out: dict = {}

    @contextlib.contextmanager
    def region(*resident):
        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(resident)
                                 if isinstance(t, torch.Tensor)])
        with tracker, R.Count(n_devices) as count:
            yield
        snap = tracker.get_tracker_snapshot("peak")
        out["peak"] = int(sum(v["Total"] for v in snap.values()))
        out["roofline"] = count.roofline
        out["kernels"] = count.kernels

    PROGRAMS[shape.mode](cfg, shape, mesh, impl, out, region, opts)
    return out


def _line(one: dict, two: dict, key: str) -> tuple:
    """(intercept, slope) of ``key`` over depth through depths 1 and 2."""
    return one[key] - (two[key] - one[key]), two[key] - one[key]


def dry_run(cfg, shape, mesh_name: str = "1x1", *, impl: str = "fused",
            depth: int | None = None, card_bytes: float = CARD_BYTES,
            opts: dict | None = None) -> dict:
    """The record of one (config, shape, mesh): ``depth`` layers (default
    the config's) composed from its 1- and 2-layer programs.  ``opts``:
    serving's layout options, as ``launch.serve.make_serve_step``'s."""
    L = depth or cfg.num_layers
    with _FakeWorld(mesh_name) as world:
        runs = [measure(dataclasses.replace(cfg, num_layers=d), shape,
                        world.mesh, impl=impl, n_devices=world.world,
                        opts=opts)
                for d in (1, 2)]
    one, two = runs
    rec = {"arch": cfg.name, "shape": shape.name, "mode": shape.mode,
           "global_batch": shape.global_batch, "seq_len": shape.seq_len,
           "mesh": mesh_name, "num_layers": L, "impl": impl,
           "opts": dict(opts or {})}
    for key in ("params", "grads", "moments", "cache", "peak"):
        if key in one:
            a, b = _line(one, two, key)
            rec[key + "_bytes"] = int(a + b * L)
            rec[key + "_line"] = (int(a), int(b))
    state = rec.get("params_bytes", 0) + rec.get("moments_bytes", 0)
    rec["activation_peak_bytes"] = rec["peak_bytes"] - state
    rec["card_bytes"] = card_bytes
    rec["fits"] = rec["peak_bytes"] * (1 + ALLOCATOR_SLACK) <= card_bytes
    rl = R.combine(one["roofline"], R.difference(two["roofline"],
                                                 one["roofline"]), L - 1)
    rl.model_flops = R.model_flops_for(dataclasses.replace(
        cfg, num_layers=L), shape)
    rec["roofline"] = rl.as_dict()
    rec["kernels_per_layer"] = {
        k: [two["kernels"].get(k, (0, 0, 0))[i] - one["kernels"].get(
            k, (0, 0, 0))[i] for i in range(3)]
        for k in set(one["kernels"]) | set(two["kernels"])}
    return rec


def largest_depth(rec: dict, budget: float) -> int:
    """The most layers whose peak (on the record's line over depth) and
    ``ALLOCATOR_SLACK`` of it fit ``budget`` bytes; 0 if one layer does
    not."""
    a, b = rec["peak_line"]
    budget = budget / (1 + ALLOCATOR_SLACK)
    if a + b > budget:
        return 0
    return int((budget - a) // b) if b > 0 else 1 << 30


def run_one(arch: str, shape_name: str, mesh_name: str = "16x16", *,
            out_dir: str | None = None, impl: str = "fused",
            card_bytes: float = CARD_BYTES, opts: dict | None = None) -> dict:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    t0 = time.time()
    try:
        rec = dry_run(cfg, shape, mesh_name, impl=impl,
                      card_bytes=card_bytes, opts=opts)
        rec["largest_depth"] = largest_depth(rec, card_bytes)
        rec["ok"] = True
    except Exception as e:  # a failure here is a bug in the port
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "ok": False, "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-2000:]}
    rec["total_s"] = round(time.time() - t0, 1)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fn = os.path.join(out_dir, f"{arch}_{shape_name}_{mesh_name}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def _gb(n: float) -> str:
    return f"{n / 1e9:.2f}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all",
                    help="comma list, or 'all' (the ten assigned archs)")
    ap.add_argument("--shape", default="all",
                    help=f"comma list of {sorted(INPUT_SHAPES)}, or 'all'")
    ap.add_argument("--mesh", default="16x16",
                    help="comma list of DxM / DxNxM (1x1: one process)")
    ap.add_argument("--impl", default="fused",
                    choices=["einsum", "pallas", "fused"])
    ap.add_argument("--card_bytes", type=float, default=CARD_BYTES,
                    help="device memory a rank may use")
    ap.add_argument("--out", default="",
                    help="write one JSON a combination here")
    ap.add_argument("--opts", default="",
                    help="comma list of serving's layout options: serve_tp "
                         "(the serve-mode specs), head_aware")
    args = ap.parse_args(argv)
    opts = {k: True for k in args.opts.split(",") if k}
    unknown = set(opts) - {"serve_tp", "head_aware"}
    if unknown:
        ap.error(f"unknown --opts {sorted(unknown)}")
    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mesh in args.mesh.split(","):
                rec = run_one(arch, shape, mesh, out_dir=args.out or None,
                              impl=args.impl, card_bytes=args.card_bytes,
                              opts=opts)
                if not rec["ok"]:
                    n_fail += 1
                    print(f"FAIL {arch:18s} {shape:12s} {mesh:8s} "
                          f"{rec['error'][:200]}", flush=True)
                    continue
                rl = rec["roofline"]
                state = " ".join(f"{k}={_gb(rec[k + '_bytes'])}"
                                 for k in ("params", "grads", "moments",
                                           "cache") if k + "_bytes" in rec)
                print(f"OK   {arch:18s} {shape:12s} {mesh:8s} GB/rank: "
                      f"{state} act={_gb(rec['activation_peak_bytes'])} "
                      f"peak={_gb(rec['peak_bytes'])} "
                      f"fits={'yes' if rec['fits'] else 'no'} "
                      f"(<= {rec['largest_depth']} layers) "
                      f"comp={rl['compute_s']:.3e}s mem={rl['memory_s']:.3e}s "
                      f"coll={rl['collective_s']:.3e}s dom={rl['dominant']} "
                      f"({rec['total_s']}s)", flush=True)
    print(f"failures: {n_fail}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
