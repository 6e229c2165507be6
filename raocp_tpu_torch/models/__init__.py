from raocp_tpu_torch.models.examples import (
    demo_problem,
    lqr_binary_problem,
    mass_spring_problem,
    random_network_problem,
    soc_network_problem,
)

__all__ = [
    "demo_problem",
    "lqr_binary_problem",
    "mass_spring_problem",
    "random_network_problem",
    "soc_network_problem",
]
