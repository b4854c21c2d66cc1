"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed number of seconds on the card:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one traffic mix or one
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` and, for the program's entry that a configuration
names, ``entries/<entry>.py``. The yardstick (the traffic generator, the
plain reference and its comparison, the peaks and byte counts, the trace
reduction) lives here too, and imports neither JAX nor the JAX package.
"""
