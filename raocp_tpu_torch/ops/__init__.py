from raocp_tpu_torch.ops import cones, operator, prox, sweep  # noqa: F401
