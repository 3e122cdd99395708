"""The benchmark of ``strided_tpu_torch`` on NVIDIA H100 cards.

``python3 -m portbench.run --workload <config>.<traffic> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``. The
pieces are found by name: ``configs/<config>.json`` (sizes, the
generator that runs the configuration, the limits of its correctness checks),
``traffic/<traffic>.json`` (the mix's parameters), ``metrics/<metric>.py``
(a per-layer metric's reader) and ``generators/<generator>.py`` (the
generator that turns a configuration and a mix into calls of the port).
``reference/`` holds the plain f64 reference that decides ``correct``; it
imports nothing of the port.
"""
