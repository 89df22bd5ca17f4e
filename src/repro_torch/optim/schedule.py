"""Learning-rate schedules (linear warmup + cosine/linear decay), the JAX
package's ``repro/optim/schedule.py``: step 0 trains too (``step + 1``)."""
from __future__ import annotations

import math


def _warm_frac(step: int, warmup: int, total: int):
    s = float(step) + 1.0
    warm = min(s / max(warmup, 1), 1.0)
    frac = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return warm, frac


def warmup_cosine(step: int, *, warmup: int, total: int,
                  floor: float = 0.1) -> float:
    warm, frac = _warm_frac(step, warmup, total)
    return warm * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))


def warmup_linear(step: int, *, warmup: int, total: int,
                  floor: float = 0.0) -> float:
    warm, frac = _warm_frac(step, warmup, total)
    return warm * (1 - (1 - floor) * frac)
