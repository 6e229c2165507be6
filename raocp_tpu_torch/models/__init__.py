from raocp_tpu_torch.models.examples import (
    demo_mpc_controller,
    demo_problem,
    lqr_binary_problem,
    mass_spring_problem,
    network_mpc_controller,
    random_network_problem,
    soc_network_problem,
)

__all__ = [
    "demo_problem",
    "lqr_binary_problem",
    "mass_spring_problem",
    "random_network_problem",
    "soc_network_problem",
    "demo_mpc_controller",
    "network_mpc_controller",
]
