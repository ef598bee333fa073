"""The general part of the benchmark of ``scat_tpu_torch``: where the
checkout's caches live, how a cell's configuration, traffic mix, driver
and per-layer metrics are found by the names ``BENCHMARK.json`` gives
them, the seeded weights and inputs, the reading of a profiler trace,
the comparison numbers and the result line.  Nothing here imports the
port at import time; nothing here imports JAX or the JAX package."""
