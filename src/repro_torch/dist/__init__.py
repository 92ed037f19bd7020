"""Distribution: sharding rules, activations under them, collectives."""

from repro_torch.dist import act
from repro_torch.dist.sharding import ShardingRules, Sharding

__all__ = ["act", "ShardingRules", "Sharding"]
