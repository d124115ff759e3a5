from repro_torch.parallel.sharding import (DEFAULT_RULES, P, PartitionSpec,
                                           Sharder, placements)

__all__ = ["Sharder", "DEFAULT_RULES", "PartitionSpec", "P", "placements"]
