"""Resilience: fault-tolerant training for a system that replans its
placement and rebuilds its step mid-run (the JAX package's
``repro/resilience``).

* :mod:`faults` — the deterministic fault-injection registry (crash at a
  point, corrupt an array, a non-finite step, a drop spike), armable from
  the ``REPRO_FAULTS`` environment variable for subprocess drills.
* :mod:`guard` — the per-step guard: non-finite detection with bounded
  retry from a host snapshot of the last good state, and the sustained
  drop-spike fallback to the dropless bound; the replan probation is
  ``repro_torch.placement.ReplanProbation``, re-exported here.
* :mod:`recovery` — :class:`CheckpointManager`: periodic atomic verified
  saves with retention GC and newest-complete-wins auto-resume.

``faults`` imports first: ``repro_torch.checkpoint`` fires its points.
"""
from repro_torch.resilience import faults  # noqa: F401  (must import first)
from repro_torch.resilience.guard import (GuardVerdict,  # noqa: F401
                                          StepGuard, TrainingAborted)
from repro_torch.placement.probation import (ProbationDecision,  # noqa: F401
                                             ReplanProbation)
from repro_torch.resilience.recovery import CheckpointManager  # noqa: F401

__all__ = ["CheckpointManager", "GuardVerdict", "ProbationDecision",
           "ReplanProbation", "StepGuard", "TrainingAborted", "faults"]
