"""Partitioned solves over ``torch.distributed`` (counterpart of
:mod:`raocp_tpu.parallel`): the replicated-spine subtree partition. The
flat node split (``node_sharding``, ``shard_problem``, ``shard_variables``)
is not ported: ROADMAP.md queue 1 item 14b."""

from raocp_tpu_torch.parallel.sharding import (AXIS, initialize_distributed,
                                               make_mesh)
from raocp_tpu_torch.parallel.subtree import (SubtreeProblem,
                                              build_subtree_problem,
                                              choose_frontier,
                                              subtree_eligible,
                                              subtree_plan)

__all__ = ["AXIS", "initialize_distributed", "make_mesh", "SubtreeProblem",
           "build_subtree_problem", "choose_frontier", "subtree_eligible",
           "subtree_plan"]
