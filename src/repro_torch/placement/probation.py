"""Replan probation: judge a freshly applied placement plan against the
loss and drop baselines from before it, and decide its rollback (the
reference keeps it in ``resilience/guard.py``; the launch's ``ReplanHook``
executes the migration; ``repro_torch.resilience`` re-exports it).  With
a ``sink`` every verdict emits a ``replan_rollback`` or ``replan_commit``
record (``repro_torch.obs.events``)."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

from repro_torch.obs import events as obs_events


class ProbationDecision(NamedTuple):
    rollback: bool
    reason: str = ""
    old_plan: object = None  # the plan to roll back to (rollback=True only)
    new_plan: object = None  # the regressing plan (to blacklist)


class ReplanProbation:
    """``start`` opens a ``window``-step probation carrying the old plan and
    the baseline loss and drop EMAs; ``observe`` feeds the steps after the
    replan.  Once ``min_samples`` have accrued, a mean loss above
    ``baseline * loss_tol`` or a mean drop above ``baseline + drop_tol``
    returns a rollback decision at once; surviving the window commits the
    plan.  A metric given as None does not take part."""

    def __init__(self, *, window: int = 16, loss_tol: float = 1.05,
                 drop_tol: float = 0.05, min_samples: int = 3, sink=None):
        self.window = int(window)
        self.loss_tol = float(loss_tol)
        self.drop_tol = float(drop_tol)
        self.min_samples = int(min_samples)
        self.sink = sink
        self._active = None

    @property
    def active(self) -> bool:
        return self._active is not None

    @property
    def old_plan(self):
        return self._active["old"] if self._active else None

    @property
    def new_plan(self):
        return self._active["new"] if self._active else None

    def start(self, step: int, old_plan, new_plan, *,
              baseline_loss: Optional[float] = None,
              baseline_drop: Optional[float] = None) -> None:
        self._active = {"start": step, "old": old_plan, "new": new_plan,
                        "baseline_loss": baseline_loss,
                        "baseline_drop": baseline_drop,
                        "losses": [], "drops": []}

    def _finish(self, step: int, kind: str, **fields) -> None:
        obs_events.emit(self.sink, kind, step=step,
                        start=self._active["start"], **fields)
        self._active = None

    def observe(self, step: int, *, loss: Optional[float] = None,
                drop: Optional[float] = None) -> ProbationDecision:
        """Feed one step after the replan: rollback, commit or keep
        watching."""
        a = self._active
        if a is None:
            return ProbationDecision(False)
        if loss is not None and math.isfinite(loss):
            a["losses"].append(float(loss))
        if drop is not None and math.isfinite(drop):
            a["drops"].append(float(drop))
        n = max(len(a["losses"]), len(a["drops"]))
        if n >= self.min_samples:
            bl, bd = a["baseline_loss"], a["baseline_drop"]
            old, new = a["old"], a["new"]
            if (bl is not None and a["losses"]
                    and sum(a["losses"]) / len(a["losses"]) > bl * self.loss_tol):
                mean = sum(a["losses"]) / len(a["losses"])
                self._finish(step, obs_events.REPLAN_ROLLBACK, metric="loss",
                             mean=mean, baseline=bl)
                return ProbationDecision(True,
                                         f"loss {mean:.4f} > {bl:.4f}"
                                         f" * {self.loss_tol}", old, new)
            if (bd is not None and a["drops"]
                    and sum(a["drops"]) / len(a["drops"]) > bd + self.drop_tol):
                mean = sum(a["drops"]) / len(a["drops"])
                self._finish(step, obs_events.REPLAN_ROLLBACK, metric="drop",
                             mean=mean, baseline=bd)
                return ProbationDecision(True,
                                         f"drop {mean:.4f} > {bd:.4f}"
                                         f" + {self.drop_tol}", old, new)
        if step - a["start"] >= self.window:
            self._finish(step, obs_events.REPLAN_COMMIT)
        return ProbationDecision(False)
