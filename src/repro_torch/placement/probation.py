"""Replan probation: judge a freshly applied placement plan against the
loss and drop baselines from before it, and decide its rollback (the
reference keeps it in ``resilience/guard.py``; the launch's ``ReplanHook``
executes the migration).  The reference's ``sink=`` is the telemetry
slice, ROADMAP §1 item 7: anything but None is refused."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

from repro_torch.core.monitor import refuse_sink


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
        refuse_sink(sink, "ReplanProbation")
        self.window = int(window)
        self.loss_tol = float(loss_tol)
        self.drop_tol = float(drop_tol)
        self.min_samples = int(min_samples)
        self.sink = None
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
                self._active = None
                return ProbationDecision(True,
                                         f"loss {mean:.4f} > {bl:.4f}"
                                         f" * {self.loss_tol}", old, new)
            if (bd is not None and a["drops"]
                    and sum(a["drops"]) / len(a["drops"]) > bd + self.drop_tol):
                mean = sum(a["drops"]) / len(a["drops"])
                self._active = None
                return ProbationDecision(True,
                                         f"drop {mean:.4f} > {bd:.4f}"
                                         f" + {self.drop_tol}", old, new)
        if step - a["start"] >= self.window:
            self._active = None  # committed
        return ProbationDecision(False)
