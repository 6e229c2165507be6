"""raocp_tpu_torch — the PyTorch + CUDA port of :mod:`raocp_tpu`, a solver
for multistage Risk-Averse Optimal Control Problems (RAOCPs) on scenario
trees.

The problem-building layer (tree, elements, constraints, spec, example
families) is a NumPy copy of the JAX package's; the stacked problem, the
operators L / L', the proximal maps and the Chambolle-Pock loop run on
torch tensors on the device given to :class:`Solver` (``device="cuda"``
on a GPU). The dynamics-projection sweep of ``prox_f`` is a hand-written
CUDA kernel (:mod:`raocp_tpu_torch.ops.sweep`). The accelerated loops
(:mod:`raocp_tpu_torch.accel`), closed-loop MPC (:mod:`raocp_tpu_torch.mpc`)
and the NumPy reporting helpers (:mod:`raocp_tpu_torch.utils`) sit on top;
:mod:`raocp_tpu_torch.parallel` runs a solve partitioned over
``torch.distributed`` ranks (``Solver(mesh=...)``). This package imports no
JAX.
"""

from raocp_tpu_torch.core.tree import (ScenarioTree,
                                       MarkovChainScenarioTreeFactory)
from raocp_tpu_torch.core.elements import (Node, Nonleaf, Leaf, NodeKind,
                                           Dynamics, Quadratic, AVaR,
                                           TotalVariation,
                                           MeanUpperSemideviation,
                                           Wasserstein, L2Ball,
                                           ConicRisk, ConicForm)
from raocp_tpu_torch.core.constraints import (
    Ball,
    Constraint,
    No,
    Polyhedral,
    Rectangle,
    Real,
    Zero,
    NonnegativeOrthant,
    SecondOrderCone,
    Cartesian,
)
from raocp_tpu_torch.core.spec import RAOCP
from raocp_tpu_torch.solver import Solver, SolverResult
from raocp_tpu_torch.mpc import RiskAverseMPC, ClosedLoopResult

__version__ = "0.1.0"

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
    "Wasserstein",
    "L2Ball",
    "ConicRisk",
    "ConicForm",
    "Constraint",
    "Ball",
    "No",
    "Polyhedral",
    "Rectangle",
    "Real",
    "Zero",
    "NonnegativeOrthant",
    "SecondOrderCone",
    "Cartesian",
    "RAOCP",
    "Solver",
    "SolverResult",
    "RiskAverseMPC",
    "ClosedLoopResult",
]
