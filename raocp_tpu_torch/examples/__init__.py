"""The port's examples (counterparts of the JAX package's ``examples/``):
the demo solve (``main``), the closed-loop MPC demo
(``closed_loop_mpc``) and the spectrum of risk measures
(``risk_spectrum``). Each runs on the card unless ``--device cpu`` is
given, and its ``main`` returns what it prints."""
