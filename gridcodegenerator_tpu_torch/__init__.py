"""PyTorch and CUDA port of the GRiD rigid-body dynamics and iLQR stack.

A second package beside ``gridcodegenerator_tpu`` (the JAX reference): the
same module names, batch on the trailing axis, plain PyTorch ops, and
hand-written CUDA kernels for Hopper under ``csrc/`` that are built at first
use. Importing this package imports neither jax nor the JAX package.
"""

from .api import GRiD, init_robot
from .models.model import RobotModel, build_model
from .models.zoo import list_robots, load_robot, robot_urdf
from .topology.robot import RobotTopology
from .topology.urdf import parse_urdf

__version__ = "0.1.0"

__all__ = [
    "GRiD",
    "RobotModel",
    "RobotTopology",
    "build_model",
    "init_robot",
    "list_robots",
    "load_robot",
    "parse_urdf",
    "robot_urdf",
    "__version__",
]
