"""Shadowed ("hot") expert execution: the data-plane half of placement.

A shadowed expert is replicated on every expert-parallel rank: each rank
holds its weights, computes it on the rank's *own* rows, and its buffer
rows are left out of the exchanged payload.  Per-rank FLOPs are unchanged
(the owner no longer computes the mp-fanned rows of that expert; every
rank computes its own rows of it instead), so shadowing is a pure
communication win paid for by the replicas' gradient sync
(``plan.placement_cost``).

Physical layout (``plan.ExpertPlacement``): owned experts occupy physical
slots ``[0, num_owned)`` in contiguous per-rank blocks; shadowed experts
occupy ``[num_owned, E)``.  The exchange buffer covers only the owned
slots, at a capacity the planner may shrink to the residual load peak.
A rank's expert stacks hold its owned block, then the shadowed experts
(``core/fmoe`` splits the tail off).  In the psum mode (decode) the
shadowed experts run on every rank outside the reduction, and
``shadow_only`` lays their outputs into the combine buffer of the local
addend.

The split lives in ``core/dispatch`` with the other buffer geometry, so
the MoE layer does not depend on the planner; this module is its name
under ``placement``.
"""
from repro_torch.core.dispatch import (ShadowSpec, merge_outputs,
                                       shadow_only, shadow_spec, split_buffer)

__all__ = ["ShadowSpec", "merge_outputs", "shadow_only", "shadow_spec",
           "split_buffer"]
