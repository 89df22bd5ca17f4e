"""Dynamic expert placement and shadowing (closing FastMoE §6's open loop).

plan.py      — ExpertPlacement / PerLayerPlacement, the roofline cost model
               and the PlacementController
migrate.py   — permute live params and optimizer state between layouts
               (a per-layer plan permutes each layer with its own table)
shadow.py    — replicated hot experts, left out of the exchange
calibrate.py — the cost model's constants (the card's own by default)
probation.py — the replan probation that decides a rollback
"""
from repro_torch.placement.calibrate import (CostConstants,
                                             calibrate_constants,
                                             load_calibration)
from repro_torch.placement.migrate import (from_logical, migrate,
                                           router_index_table, to_logical)
from repro_torch.placement.plan import (ExpertPlacement, PerLayerPlacement,
                                        PlacementController,
                                        identity_per_layer,
                                        identity_placement, per_layer_cost,
                                        per_layer_placement, placement_cost,
                                        plan_placement,
                                        plan_placement_per_layer)
from repro_torch.placement.probation import ProbationDecision, ReplanProbation
from repro_torch.placement.shadow import (ShadowSpec, merge_outputs,
                                          shadow_only, shadow_spec,
                                          split_buffer)

__all__ = [
    "CostConstants", "ExpertPlacement", "PerLayerPlacement",
    "PlacementController", "ProbationDecision", "ReplanProbation",
    "ShadowSpec", "calibrate_constants",
    "from_logical", "identity_per_layer",
    "identity_placement", "load_calibration", "merge_outputs", "migrate",
    "per_layer_cost", "per_layer_placement", "placement_cost",
    "plan_placement", "plan_placement_per_layer", "router_index_table",
    "shadow_only", "shadow_spec", "split_buffer", "to_logical",
]
