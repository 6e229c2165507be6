from raocp_tpu_torch.core.constraints.sets import (Ball, Constraint, No,
                                              Polyhedral, Rectangle)
from raocp_tpu_torch.core.constraints.cones import (
    Real,
    Zero,
    NonnegativeOrthant,
    SecondOrderCone,
    Cartesian,
)

__all__ = [
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
]
