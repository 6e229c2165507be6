import raocp_tpu_torch.core.constraints  # noqa: F401
from raocp_tpu_torch.core.tree import (ScenarioTree,
                                       MarkovChainScenarioTreeFactory)
from raocp_tpu_torch.core.elements import (Node, Nonleaf, Leaf, NodeKind,
                                           Dynamics, Quadratic, AVaR,
                                           TotalVariation,
                                           MeanUpperSemideviation,
                                           ConicRisk, ConicForm)
from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.core.stacked import StackedProblem, build_stacked
from raocp_tpu_torch.core.variables import Primal, Dual

__all__ = [
    "ScenarioTree",
    "MarkovChainScenarioTreeFactory",
    "Node",
    "NodeKind",
    "Nonleaf",
    "Leaf",
    "Dynamics",
    "Quadratic",
    "AVaR",
    "TotalVariation",
    "MeanUpperSemideviation",
    "ConicRisk",
    "ConicForm",
    "RAOCP",
    "StackedProblem",
    "build_stacked",
    "Primal",
    "Dual",
]
