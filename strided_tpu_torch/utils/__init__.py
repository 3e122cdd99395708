from .checkpoint import save_pytree, load_pytree  # noqa: F401
from .profiling import trace, annotate, Timer  # noqa: F401
