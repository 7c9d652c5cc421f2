"""PyTorch and CUDA port of the GRiD rigid-body dynamics and iLQR stack.

A second package beside ``gridcodegenerator_tpu`` (the JAX reference): the
same module names, batch on the trailing axis, plain PyTorch ops, and
hand-written CUDA kernels for Hopper under ``csrc/`` that are built at first
use. Importing this package imports neither jax nor the JAX package.
"""

from .api import GRiD, init_robot

__all__ = ["GRiD", "init_robot"]
