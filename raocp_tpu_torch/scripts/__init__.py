"""Drivers of the port (counterparts of the JAX package's ``scripts/``): the
BASELINE-config runner, the per-component profile and the CP step's
profile; the scale runs (10^5 and 10^6 nodes), the over-relaxation and
accelerator sweeps, and the batch and partition-scaling harnesses."""
