"""Drivers of the port: the BASELINE-config runner, the per-component
profile and the CP step's profile (counterparts of the JAX package's
``scripts/``)."""
