"""portbench — the benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell of ``BENCHMARK.json`` once on one machine::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); the
mix names its driver (``drivers/<kind>.py``); every metric is a reader of
its own (``metrics/<name>.py``); the limits that decide ``correct`` for a
cell are ``limits/<cell>.json``.  The yardstick (weights and inputs from
the seed, the plain reference, the operation counts, the peaks and the
trace reduction) lives here and imports nothing of the port.
"""
