"""The placement cost model's hardware constants, and their calibration
from measured benchmark results.

The default :class:`CostConstants` are the card's own datasheet numbers
(NVIDIA H100 SXM5 80GB, the card the port runs on; the repo's chip runs
read ``NVIDIA H100 80GB HBM3, 700.00 W`` from ``nvidia-smi``):

* ``hbm_bw``    3.35e12 B/s — HBM3 bandwidth;
* ``peak_flops`` 989e12 flop/s — dense bf16 tensor-core peak;
* ``ici_bw``    450e9 B/s — the expert-parallel wire: fourth-generation
  NVLink, 900 GB/s per GPU counting both directions, so 450 GB/s each
  way.  A datasheet figure, not a measurement: the port's chip runs have
  one card, so no wire has been measured.

:func:`calibrate_constants` keeps the reference's rules on a results dict
(fig8's wire rate from the placement-on / placement-off deltas, fig3's best
grouped-GEMM rate; rows not measured on a real accelerator are refused, and
values outside the sanity clamps are artifacts), falling back field by
field to the defaults above.  :func:`load_calibration` with no path returns
the defaults: the port has no results file of its own yet.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional

H100_SXM5_HBM_BW = 3.35e12  # B/s, HBM3 (datasheet)
H100_SXM5_BF16_FLOPS = 989e12  # flop/s, dense bf16 tensor cores (datasheet)
H100_SXM5_NVLINK_BW = 450e9  # B/s each way, NVLink 4 (datasheet: 900 both)
H100_SXM5_HBM_BYTES = 80e9  # device memory (datasheet: 80 GB)
DEFAULT_SOURCE = "h100-sxm-datasheet"

# sanity clamps: outside these a "measurement" is an artifact
_BW_MIN, _BW_MAX = 1e7, 1e14
_FLOPS_MIN, _FLOPS_MAX = 1e9, 1e18

# only rows measured on a real accelerator may calibrate; CPU fake-device
# rows time memcpys, not a wire
_REAL_BACKENDS = ("tpu", "gpu")


class CostConstants(NamedTuple):
    """Hardware constants the placement cost model prices plans with."""

    ici_bw: float = H100_SXM5_NVLINK_BW  # bytes/s, the expert-parallel wire
    hbm_bw: float = H100_SXM5_HBM_BW  # bytes/s per card
    peak_flops: float = H100_SXM5_BF16_FLOPS  # flop/s per card
    source: str = DEFAULT_SOURCE  # provenance, for logs


def calibrate_constants(results: dict, *,
                        bytes_per_elem: int = 4) -> CostConstants:
    """Effective constants from a ``results.json``-shaped dict, falling
    back field by field to the defaults where a measurement is absent or
    non-informative."""
    srcs = []
    ici = H100_SXM5_NVLINK_BW
    for row in results.get("fig8", []):
        if row.get("backend") not in _REAL_BACKENDS:
            continue  # a fake-device memcpy time is not a wire measurement
        dt_s = (row.get("us_off", 0.0) - row.get("us_on", 0.0)) * 1e-6
        delems = row.get("a2a_elems_off", 0) - row.get("a2a_elems_on", 0)
        # fig8 times one forward pass: dispatch + return = 2 payload moves
        dbytes = 2.0 * delems * bytes_per_elem
        if dt_s <= 0 or dbytes <= 0:
            continue  # shrinking the buffer did not pay: wire not the limit
        bw = dbytes / dt_s
        if _BW_MIN <= bw <= _BW_MAX:
            ici = bw
            srcs.append("fig8")
            break
    flops = H100_SXM5_BF16_FLOPS
    fig3 = [r.get("gflops", 0.0) for r in results.get("fig3", [])
            if r.get("backend") in _REAL_BACKENDS]
    if fig3:
        best = max(fig3) * 1e9
        if _FLOPS_MIN <= best <= _FLOPS_MAX:
            flops = best
            srcs.append("fig3")
    return CostConstants(ici, H100_SXM5_HBM_BW, flops,
                         "measured:" + "+".join(srcs) if srcs
                         else DEFAULT_SOURCE)


def load_calibration(path: Optional[str] = None) -> CostConstants:
    """CostConstants from a results file; the defaults with no path or an
    unreadable file."""
    if not path:
        return CostConstants()
    try:
        with open(path) as f:
            results = json.load(f)
    except (OSError, ValueError):
        return CostConstants()
    return calibrate_constants(results)
