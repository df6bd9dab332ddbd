"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line. Everything that belongs to one configuration, traffic mix,
mode or metric is a file of its own, found by the name
``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``traffic/<traffic>.json`` (which names its mode), ``modes/<mode>.py``,
``metrics/<metric>.py`` and ``limits/<cell>.json``. The yardstick lives
here too and imports nothing of the program: the traffic generator
(``stream.py``, ``traffic.py``), the weights (``weights.py``), the plain
reference (``reference.py``), the model-FLOP and kernel-bound arithmetic
(``flops.py``), the reading of the profiler's trace (``trace.py``) and the
comparison that decides ``correct`` (``check.py``).
"""
