"""The plain reference that decides ``correct``: f64 PyTorch, importing
nothing of ``strided_tpu_torch``. It is handed the same seeded inputs as
the port and works out again whatever the port derived in its set-up."""
