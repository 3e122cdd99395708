from .profiling import trace, annotate, Timer  # noqa: F401


def __getattr__(name):
    # the checkpoints load the MPC stack, whose modules open profiling's
    # spans: imported at first use, so that importing ``profiling`` from
    # inside the stack makes no import cycle
    if name in ("save_pytree", "load_pytree"):
        from . import checkpoint

        return getattr(checkpoint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
