"""Typed serving API: the one interface the scheduler, the CLI and the
chip script speak.

``ServeConfig`` carries the serving loop's knobs (decode slots, paged-cache
block geometry, admission policy, mesh, replan cadence); ``Request`` is what a client
submits; ``Completion`` is what comes back, with the timestamps every
serving SLO is written against (queued / first token / done) and every
token's emission time, so time to first token and per-token p50/p99 fall
out without extra plumbing.

``launch/serve.py main()`` builds a ServeConfig from its CLI flags
(``ServeConfig.from_args``) and ``launch/scheduler.ContinuousBatcher``
consumes it: flags and constructor arguments map onto this one dataclass.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import List, Optional

import numpy as np


@dataclass
class ServeConfig:
    """Serving-loop configuration (the model rides separately as a
    ``repro_torch.configs.base.ModelConfig``).

    slots          decode-batch width: the in-flight sequences one decode
                   tick advances (requests are admitted and retired into
                   these slots every tick)
    max_len        per-request cap on prompt + generated tokens; sizes the
                   ring cache (not paged) and the per-slot block table
    block_size     rows per KV-cache block (paged mode)
    num_blocks     physical blocks in the shared pool; 0 = auto (slots *
                   ceil(max_len / block_size) + the 2 reserved null and
                   scratch blocks: admission never waits on pool space)
    paged          use the paged KV cache (GQA and MLA caches both page)
    policy         "continuous" (admit into any free slot every tick) or
                   "static" (admit only when every slot is free: the
                   head-of-line-blocking baseline)
    mesh           "DxM" rank mesh for expert-parallel decode in the psum
                   mode ("" = one device): a batcher per data group, each
                   decoding its B/D of the slots over its model group
    replan_every   decode ticks between placement-controller polls, fed
                   the decode step's (L, E) expert loads
                   (``scheduler.ServeReplanHook``); 0 = no serve-time
                   replanning
    per_layer_plans  plan each layer apart (a PerLayerPlacement) on the
                   serve-time replans
    eos_id         optional early-stop token id
    metrics_out / trace   telemetry outputs (``repro_torch.obs``): a JSONL
                   file of records and a Chrome trace of host spans, the
                   same semantics as the train CLI's flags

    The reference's arch and reduced fields are the CLI's flags here
    (``launch/serve.py``).
    """

    slots: int = 8
    max_len: int = 256
    block_size: int = 16
    num_blocks: int = 0
    paged: bool = True
    policy: str = "continuous"
    mesh: str = ""
    replan_every: int = 0
    per_layer_plans: bool = True
    eos_id: Optional[int] = None
    metrics_out: str = ""
    trace: str = ""

    def __post_init__(self):
        if self.policy not in ("continuous", "static"):
            raise ValueError(f"unknown serving policy {self.policy!r}")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.max_len < 1:
            raise ValueError("max_len must be >= 1")

    @property
    def blocks_per_slot(self) -> int:
        """Block-table width: logical blocks covering max_len positions."""
        return -(-self.max_len // self.block_size)

    @property
    def pool_blocks(self) -> int:
        """Physical pool size (auto-sized unless num_blocks is explicit).
        Blocks 0 (null: read target of unallocated table entries) and 1
        (scratch: write target of idle slots) are reserved."""
        if self.num_blocks:
            return self.num_blocks
        return self.slots * self.blocks_per_slot + 2

    def mesh_shape(self) -> Optional[tuple]:
        """Parsed (data, model) mesh dims, or None for one device.  A
        (data, node, model) mesh is refused: the reference's serving has
        no node path."""
        if not self.mesh:
            return None
        dims = [int(v) for v in self.mesh.lower().split("x")]
        if len(dims) == 3:
            from repro_torch.launch.serve import check_serving_mesh
            check_serving_mesh(dims[1])
        d, m = dims
        return d, m

    @classmethod
    def from_args(cls, args) -> "ServeConfig":
        """argparse.Namespace -> ServeConfig: any attribute named like a
        field and not None is taken, everything else keeps its default.
        ``--batch`` maps to ``slots`` when no ``--slots`` was given."""
        kw = {f.name: getattr(args, f.name) for f in fields(cls)
              if getattr(args, f.name, None) is not None}
        if "slots" not in kw and getattr(args, "batch", None) is not None:
            kw["slots"] = args.batch
        return cls(**kw)


@dataclass
class Request:
    """One generation request.  ``arrival`` is the client-side submission
    time (time.time()); None means "stamp at submit"."""

    id: int
    prompt: np.ndarray  # (S,) int token ids
    max_new_tokens: int
    arrival: Optional[float] = None


@dataclass
class Completion:
    """A finished request: generated tokens and the serving timeline.

    queued        when the request entered the queue (Request.arrival)
    first_token   when the first generated token was emitted (prefill done)
    done          when the last token was emitted
    token_times   emission time of every generated token: consecutive
                  differences are the per-token latencies
    """

    request_id: int
    tokens: List[int] = field(default_factory=list)
    prompt_len: int = 0
    queued: float = 0.0
    first_token: float = 0.0
    done: float = 0.0
    token_times: List[float] = field(default_factory=list)

    @property
    def ttft(self) -> float:
        """Time to first token (queue wait + prefill)."""
        return self.first_token - self.queued

    @property
    def latencies(self) -> List[float]:
        """Per-token latencies: the first pays the queue and the prefill,
        the rest are decode-tick gaps (stalls included)."""
        if not self.token_times:
            return []
        out = [self.token_times[0] - self.queued]
        out.extend(b - a for a, b in zip(self.token_times, self.token_times[1:]))
        return out
