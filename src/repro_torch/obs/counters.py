"""Device-side telemetry counters riding the MoE metrics.

One :class:`ObsCounters` per MoE layer, summed over the layers with the
rest of :class:`repro_torch.core.balance.MoEMetrics`, so the counters reach
the host with the loss and add no device->host synchronize of their own.

The fields come only from (a) host constants of the step (buffer shapes,
wire dtypes, the shift decomposition's fraction), kept as Python floats so
they cost no kernel, and (b) values the MoE paths already reduce for the
load monitor (the counts exchange, the all-reduced loads and the mean drop
fraction), as 0-d f32 tensors.  No counter adds a collective
(``tests/test_torch_ep.py`` holds the collective tally equal with the
counters on and off).

Semantics, per train or decode step, summed over the MoE layers (the JAX
package's, ``repro/obs/counters.py``):

  wire_elems / wire_bytes: elements / bytes of the expert exchange that
    cross the wire per rank: dispatch and return payloads (at the wire
    dtype's width) and the counts exchange, times (mp - 1) / mp when the
    §5.2 schedule takes the shifts (a rank's own slice stays put).
  dropped: (token, slot) assignments dropped over every rank.
  shadow_hits: assignments served by shadowed experts over every rank.
  imbalance: max / mean of the per-expert-rank received load (1.0 =
    balanced); ``models.lm.loss_fn`` divides the sum by the layer count.
  wire_bytes_intra / wire_bytes_inter: wire_bytes split by mesh level; a
    flat exchange counts every byte as inter.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.core.pipeline import wire_torch_dtype

Value = Union[float, torch.Tensor]  # a host constant or a 0-d f32 tensor


class ObsCounters(NamedTuple):
    """Per-layer counters, '+'-accumulable; each field a float or a 0-d f32
    tensor (:meth:`tensors` makes them all tensors)."""

    wire_elems: Value
    wire_bytes: Value
    dropped: Value
    shadow_hits: Value
    imbalance: Value
    wire_bytes_intra: Value
    wire_bytes_inter: Value

    @staticmethod
    def zero() -> "ObsCounters":
        return ObsCounters(*(0.0,) * 7)

    def __add__(self, other: "ObsCounters") -> "ObsCounters":
        return ObsCounters(*(a + b for a, b in zip(self, other)))

    def as_dict(self) -> dict:
        return dict(zip(self._fields, self))

    def tensors(self, device) -> "ObsCounters":
        """Every field a 0-d f32 tensor on ``device`` (a float by a fill
        kernel, not a host copy)."""
        return ObsCounters(*(
            v.float() if isinstance(v, torch.Tensor)
            else torch.full((), float(v), dtype=torch.float32, device=device)
            for v in self))


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _widths(wire_dtype, in_dtype, out_dtype) -> tuple:
    wd = wire_torch_dtype(wire_dtype)
    return (_itemsize(wd or in_dtype), _itemsize(wd or out_dtype))


def _f32(v) -> Value:
    return v.float() if isinstance(v, torch.Tensor) else float(v)


def exchange_counters(*, frac: float, fwd_rows: int, d_in: int, in_dtype,
                      ret_rows: int, d_out: int, out_dtype, counts_elems: int,
                      wire_dtype=None, dropped, shadow_hits,
                      imbalance) -> ObsCounters:
    """Counters of one flat exchange (capacity or ragged): ``frac`` the
    wire fraction of the nominal buffer (``core.pipeline.wire_fraction``);
    the payloads at ``wire_dtype``'s width where it is set, the counts leg
    int32.  ``dropped``, ``shadow_hits`` and ``imbalance``: the caller's
    values from reductions it already made."""
    bi, bo = _widths(wire_dtype, in_dtype, out_dtype)
    elems = frac * (fwd_rows * d_in + ret_rows * d_out + counts_elems)
    byts = frac * (fwd_rows * d_in * bi + ret_rows * d_out * bo
                   + counts_elems * 4)
    return ObsCounters(float(elems), float(byts), _f32(dropped),
                       _f32(shadow_hits), _f32(imbalance), 0.0, float(byts))


def hier_exchange_counters(*, intra_frac: float, inter_frac: float,
                           intra_rows: int, inter_rows: int, d_in: int,
                           in_dtype, d_out: int, out_dtype, counts_elems: int,
                           wire_dtype=None, dropped, shadow_hits,
                           imbalance) -> ObsCounters:
    """Counters of the two-level ragged exchange: each level a forward and
    a return payload leg plus a counts leg, ``intra_rows`` rows each way
    over the node-local axes, ``inter_rows`` over the node axis (the slim
    shards), the counts at full per-source-rank granularity on both."""
    bi, bo = _widths(wire_dtype, in_dtype, out_dtype)
    elems = (intra_frac * (intra_rows * (d_in + d_out) + counts_elems)
             + inter_frac * (inter_rows * (d_in + d_out) + counts_elems))
    b_intra = intra_frac * (intra_rows * (d_in * bi + d_out * bo)
                            + counts_elems * 4)
    b_inter = inter_frac * (inter_rows * (d_in * bi + d_out * bo)
                            + counts_elems * 4)
    return ObsCounters(float(elems), float(b_intra + b_inter), _f32(dropped),
                       _f32(shadow_hits), _f32(imbalance), float(b_intra),
                       float(b_inter))


def reduction_counters(*, payload_elems: int, payload_dtype, dropped,
                       shadow_hits, imbalance) -> ObsCounters:
    """Counters of the psum mode: the all-reduce of the combined output is
    its only wire traffic (no counts leg)."""
    b = payload_elems * _itemsize(payload_dtype)
    return ObsCounters(float(payload_elems), float(b), _f32(dropped),
                       _f32(shadow_hits), _f32(imbalance), 0.0, float(b))


def local_counters(*, dropped) -> ObsCounters:
    """The single-worker path: nothing crosses a wire."""
    return ObsCounters(0.0, 0.0, _f32(dropped), 0.0, 1.0, 0.0, 0.0)


def imbalance(owned_load: torch.Tensor, mp: int, E_local: int) -> torch.Tensor:
    """max / mean of the per-expert-rank received load, from a global
    physical-order load of the owned experts (no collective of its own)."""
    per_rank = owned_load.float().reshape(mp, E_local).sum(1)
    return per_rank.max() / per_rank.mean().clamp_min(1e-6)
