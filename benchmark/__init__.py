"""The benchmark of raocp_tpu_torch (see run.py)."""
