"""The plain reference that decides ``correct``: plain PyTorch and NumPy.

Nothing here imports the port (``mcmcpp_tpu_torch``), the JAX package or
JAX. Each module is a frozen copy of a rule the port implements, written
again from its definition, so a later change to the port cannot move the
yardstick:

- ``philox``: Philox4x32-10 and the map from 32 random bits to the stretch
  move's uniforms u and ue;
- ``noise``: the half-steps' partner shifts and Philox keys, drawn again
  from the run's seed by generators seeded as the sampler seeds its own;
- ``stretch``: the Goodman–Weare stretch half-step in any float dtype;
- ``gaussian``: the Gaussian log-density −½‖x L‖² and exact draws;
- ``store``: the rows a reduced-precision chain must hold.
"""
