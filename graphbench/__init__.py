"""The benchmark of the PyTorch/CUDA graph engine (``src/repro_torch``).

``python graphbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once. Everything that belongs to one
configuration (``configs/<name>.json``), one traffic mix
(``traffic/<name>.json``), one graph generator (``generators/<name>.py``),
one query kind (``queries/<name>.py``) or one metric (``metrics/<name>.py``)
is a file of its own, found by its name. ``control.py`` reads a cell's
lower-precision control on the card. The CPU tests:
``python -m pytest graphbench/tests``; on the card add ``-m cuda``.
"""
