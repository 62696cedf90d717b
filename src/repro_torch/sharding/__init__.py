"""Sharding rules: logical activation names and parameter-path rules ->
specs for the FSDP('data') x TP('model') (+ 'pod' pure-DP) meshes, and
their DTensor placements."""
from .hooks import activation_rules, constrain, current_rules
from .rules import (P, ShardingRules, batch_axes, make_rules,
                    param_placements, param_specs, placements,
                    sanitize_spec)

__all__ = [
    "P", "ShardingRules", "activation_rules", "batch_axes", "constrain",
    "current_rules", "make_rules", "param_placements", "param_specs",
    "placements", "sanitize_spec",
]
