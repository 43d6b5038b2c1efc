from .logical import (
    DEFAULT_RULES,
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    current_rules,
    logical_spec,
    named_sharding,
    placements,
    shard,
    use_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "NamedSharding",
    "PartitionSpec",
    "ShardingRules",
    "current_rules",
    "logical_spec",
    "named_sharding",
    "placements",
    "shard",
    "use_rules",
]
