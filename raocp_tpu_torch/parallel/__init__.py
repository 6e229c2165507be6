"""Partitioned solves over ``torch.distributed`` (counterpart of
:mod:`raocp_tpu.parallel`): the replicated-spine subtree partition
(:mod:`.subtree`) and the flat node partition (:func:`node_sharding`,
:func:`shard_problem`, :func:`shard_variables`; :mod:`.flat`)."""

from raocp_tpu_torch.parallel.flat import FlatProblem, flat_plan
from raocp_tpu_torch.parallel.sharding import (AXIS, initialize_distributed,
                                               make_mesh, node_sharding,
                                               shard_problem,
                                               shard_variables)
from raocp_tpu_torch.parallel.subtree import (SubtreeProblem,
                                              build_subtree_problem,
                                              choose_frontier,
                                              subtree_eligible,
                                              subtree_plan)

__all__ = ["AXIS", "initialize_distributed", "make_mesh", "node_sharding",
           "shard_problem", "shard_variables", "FlatProblem", "flat_plan",
           "SubtreeProblem", "build_subtree_problem", "choose_frontier",
           "subtree_eligible", "subtree_plan"]
