"""StepStats: one record of a step's wall time, its device-side counters
and its *modeled* collective bytes, the modeled-vs-measured comparison of
the JAX package's ``repro/obs/stats.py`` in a shape any sink can emit.

The reference models the bytes from its compiled step's HLO.  The port has
no compiled program to parse: its modeled side is ``core.comm``'s host
tally of the collectives the step issued (output bytes per rank, by the
reference's op names), which :func:`modeled_collective_bytes` reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


def modeled_collective_bytes() -> dict:
    """{op: output bytes per rank} of the collectives tallied since the
    last ``core.comm.tally_reset``."""
    from repro_torch.core import comm
    return comm.tallied()


@dataclass
class StepStats:
    """One step's telemetry: wall time, device counters, modeled bytes."""

    name: str
    step: int
    wall_s: float
    counters: dict = field(default_factory=dict)  # measured (device-side)
    modeled: dict = field(default_factory=dict)  # collective bytes by op

    @property
    def measured_wire_bytes(self) -> Optional[float]:
        v = self.counters.get("wire_bytes")
        return float(v) if v is not None else None

    @property
    def modeled_wire_bytes(self) -> float:
        """The exchange ops the wire counters cover: all-to-all when the
        exchange is one call, collective-permute when it takes the shifts."""
        return float(self.modeled.get("all-to-all", 0)
                     + self.modeled.get("collective-permute", 0))

    @property
    def wire_ratio(self) -> Optional[float]:
        m = self.measured_wire_bytes
        if m is None or not self.modeled:
            return None
        return m / max(self.modeled_wire_bytes, 1e-9)

    def record(self) -> dict:
        """Flat dict for a MetricsSink."""
        rec = {"kind": self.name, "step": self.step, "wall_s": self.wall_s}
        rec.update({k: v for k, v in self.counters.items()})
        for op, b in self.modeled.items():
            rec[f"modeled_{op.replace('-', '_')}_bytes"] = b
        r = self.wire_ratio
        if r is not None:
            rec["wire_measured_over_modeled"] = r
        return rec
