from repro_torch.sharding.constrain import (  # noqa: F401
    active_policy,
    logical_constraint,
    use_policy,
)
from repro_torch.sharding.rules import ShardingPolicy, specs_to_shardings  # noqa: F401
