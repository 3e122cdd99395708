from .base import Model, rk4_step, linearize  # noqa: F401
from .pendulum import simple_pendulum, double_pendulum  # noqa: F401
from .cartpole import cartpole  # noqa: F401
from .quadrotor import quadrotor, hover_state, hover_input  # noqa: F401
from .vehicles import unicycle, bicycle  # noqa: F401
