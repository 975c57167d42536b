from .rules import (
    RULE_SETS,
    current_rules,
    local_shard,
    logical_to_spec,
    shard,
    shardings_from_axes,
    spec_to_placements,
    splittable,
    use_rules,
    weight_for,
)

__all__ = ["RULE_SETS", "current_rules", "local_shard", "logical_to_spec", "shard",
           "shardings_from_axes", "spec_to_placements", "splittable", "use_rules",
           "weight_for"]
