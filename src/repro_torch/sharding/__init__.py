"""Sharded execution of the packed round over ``torch.distributed`` ranks
(counterpart of ``repro/sharding``; see ``shardexec.py``)."""
from repro_torch.sharding.shardexec import (TOPK_BISECT_ITERS, ShardExec,
                                            plan_for)

__all__ = ["TOPK_BISECT_ITERS", "ShardExec", "plan_for"]
