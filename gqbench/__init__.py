"""gqbench: the benchmark of the PyTorch and CUDA port ``repro_torch``.

``run.py`` runs one cell of ``BENCHMARK.json``; ``harness.py`` finds the
cell's files by name and runs it; ``loop.py`` is the traffic generator and
the closed loop; ``gen.py`` the generators' pieces; ``reference/`` the plain
reference; ``compare.py`` the number that decides ``correct``;
``devtrace.py`` reads the profiler's trace; ``metrics/`` one reader a
metric; ``control.py`` reads the comparison's control.
"""
