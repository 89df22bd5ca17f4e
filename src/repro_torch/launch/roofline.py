"""Roofline of a step from the dry run's counts (no card needed).

Three terms per (arch x shape x mesh), seconds per step on one rank, from
the H100 SXM5 datasheet constants (``placement/calibrate``):

  compute    = operations / peak bf16 rate
  memory     = bytes / HBM rate
  collective = sum over ops of bytes * hops / NVLink rate (one direction)

The reference reads the first two from XLA's cost analysis of the
compiled step and parses the third from its HLO.  The port has no
compiler to ask, so the dry run (``launch/dryrun``) counts them as the step
runs on the meta device (:class:`Count`):

* operations: ``torch.utils.flop_counter.FlopCounterMode`` for the torch
  ops, plus each hand-written kernel's own count (``kernels.cost``, the
  formulas of the card's bound column);
* bytes: the inputs and outputs of every torch op that moves data, and of
  every kernel: an upper bound, as XLA's "bytes accessed" is;
* collective bytes: ``core.comm``'s tally of each collective's output bytes
  per rank, under the reference's op names.

:func:`combine` composes a whole program from a shallower one and a
per-layer difference, as the reference's layer probe does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import comm
from repro_torch.kernels import cost
from repro_torch.placement.calibrate import (H100_SXM5_BF16_FLOPS,
                                             H100_SXM5_HBM_BW,
                                             H100_SXM5_NVLINK_BW)

PEAK_FLOPS = H100_SXM5_BF16_FLOPS
HBM_BW = H100_SXM5_HBM_BW
ICI_BW = H100_SXM5_NVLINK_BW

_HOPS = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
         "all-to-all": 1.0, "collective-permute": 1.0}


@dataclass
class Roofline:
    flops: float  # per device
    hbm_bytes: float  # per device
    coll_bytes: dict  # per device, by op type
    n_devices: int
    model_flops: float = 0.0  # 6*N_active*D etc (global)

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return sum(b * _HOPS.get(op, 1.0)
                   for op, b in self.coll_bytes.items()) / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def step_s(self) -> float:
        """Roofline step-time lower bound (max of the three terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "collective_bytes": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "step_s_bound": self.step_s,
        }


def combine(full: Roofline, layer: Roofline, extra_layers: int) -> Roofline:
    """total = full_program + extra_layers * layer_probe."""
    coll = dict(full.coll_bytes)
    for op, b in layer.coll_bytes.items():
        coll[op] = coll.get(op, 0) + extra_layers * b
    return Roofline(full.flops + extra_layers * layer.flops,
                    full.hbm_bytes + extra_layers * layer.hbm_bytes,
                    coll, full.n_devices, full.model_flops)


def difference(deep: Roofline, shallow: Roofline) -> Roofline:
    """What ``deep`` counts beyond ``shallow`` (a layer, for programs one
    layer apart)."""
    ops = set(deep.coll_bytes) | set(shallow.coll_bytes)
    return Roofline(deep.flops - shallow.flops,
                    deep.hbm_bytes - shallow.hbm_bytes,
                    {op: deep.coll_bytes.get(op, 0)
                     - shallow.coll_bytes.get(op, 0) for op in ops},
                    deep.n_devices)


def model_flops_for(cfg, shape) -> float:
    """Paper-style useful-FLOPs estimate: 6*N_active*tokens (train) or
    2*N_active*tokens (inference)."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: 1 new token/seq


# ops that allocate or alias without moving data
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "set_",
               "resize_", "record_stream"}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


class _Bytes(TorchDispatchMode):
    """Sums the bytes of every torch op's tensor inputs and outputs, views
    and allocations aside."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.__name__.split(".")[0]
        if not (func.is_view or name in _NO_TRAFFIC):
            self.total += (_nbytes(list(args)) + _nbytes(
                list((kwargs or {}).values())) + _nbytes(out))
        return out


class Count:
    """Counts a region's operations, bytes and collective bytes (one
    rank's): ``with Count(n_devices) as c: ...`` then ``c.roofline``."""

    def __init__(self, n_devices: int = 1, model_flops: float = 0.0):
        self.n_devices, self.model_flops = n_devices, model_flops
        self.roofline = None

    def __enter__(self):
        cost.reset()
        comm.tally_reset()
        self._flops = FlopCounterMode(display=False)
        self._bytes = _Bytes()
        self._flops.__enter__()
        self._bytes.__enter__()
        return self

    def __exit__(self, *exc):
        self._bytes.__exit__(*exc)
        self._flops.__exit__(*exc)
        kern = cost.tallied()
        self.kernels = kern
        self.roofline = Roofline(
            float(self._flops.get_total_flops())
            + sum(v[2] for v in kern.values()),
            float(self._bytes.total) + sum(v[1] for v in kern.values()),
            comm.tallied(), self.n_devices, self.model_flops)
        return False
