"""Canonical incident-event vocabulary for the resilience layer.

Every fault injection, guarded step skip, state restore, dropless fallback,
checkpoint save/skip, resume, and placement rollback emits one flat record
through the same :mod:`repro_torch.obs.sink` pipeline as the per-step telemetry,
so ``--metrics_out`` carries the *whole incident timeline* — what fired,
what the guard did about it, and where training picked back up — in one
queryable stream.  The kinds live here (not scattered as string literals)
so tests and tooling can filter on one vocabulary.
"""
from __future__ import annotations

# fault registry (repro_torch.resilience.faults)
FAULT = "fault"  # an armed fault fired at its point

# step guard (repro_torch.resilience.guard)
GUARD_SKIP = "guard_skip"  # non-finite step detected; state discarded
GUARD_RESTORE = "guard_restore"  # last-good snapshot reinstated for retry
GUARD_ABORT = "guard_abort"  # max_bad_steps exceeded; training stopped
DROP_SPIKE = "drop_spike"  # sustained drop_frac above threshold
DROP_FALLBACK = "drop_fallback"  # train loop forced the dropless bound

# checkpointing (repro_torch.resilience.recovery / repro_torch.checkpoint)
CKPT_SAVE = "ckpt_save"  # atomic checkpoint committed
CKPT_GC = "ckpt_gc"  # retention GC removed old checkpoints
CKPT_CORRUPT = "ckpt_corrupt"  # a checkpoint failed verification on restore
RESUME = "resume"  # training resumed from a complete checkpoint

# placement replan probation (launch.train.ReplanHook)
REPLAN_ROLLBACK = "replan_rollback"  # post-replan regression: plan reverted
REPLAN_COMMIT = "replan_commit"  # probation passed; new plan kept

# routing (launch.train --freeze_router_at)
ROUTER_FROZEN = "router_frozen"  # gate distillation ended; frozen router live

# telemetry self-reporting (the reference's HLO byte modeling; the port
# tallies its collectives on the host and never emits it)
MODELED_ERROR = "modeled_bytes_error"


def emit(sink, kind: str, **fields) -> dict | None:
    """Emit ``{"kind": kind, **fields}`` into ``sink`` (None sink = no-op).

    Returns the record (or None) so call sites can also print/log it.
    """
    if sink is None:
        return None
    rec = {"kind": kind, **fields}
    sink.emit(rec)
    return rec


def of_kind(records: list, *kinds: str) -> list:
    """Filter a record stream (e.g. ``jsonl_records`` output) by kind."""
    want = set(kinds)
    return [r for r in records if r.get("kind") in want]
