from repro_torch.sharding.partition import (LOGICAL_RULES, NamedSharding, batch_spec,
                                            cache_shardings, constrain, device_put,
                                            param_shardings, placements, resolve_spec,
                                            sp_boundary)

__all__ = [
    "LOGICAL_RULES", "NamedSharding", "batch_spec", "cache_shardings", "constrain",
    "device_put", "param_shardings", "placements", "resolve_spec", "sp_boundary",
]
