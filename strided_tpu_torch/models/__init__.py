from .base import Model, rk4_step, linearize  # noqa: F401
from .quadrotor import quadrotor, hover_state, hover_input  # noqa: F401
