"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

One run of one cell:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the repository root names the cells, the end-to-end
and the per-layer metrics.  Everything that belongs to one configuration,
one traffic mix or one metric is a file of its own, found by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``metrics/<metric>.py``
(a quantity split by what it moves, ``<quantity>.<split>``, may share the
reader ``metrics/<quantity>.<kind>.py`` of its cell's kind of traffic) and
``checks/<workload>.json`` (the limits of the comparison that decides
``correct``).  The yardstick lives here too: the seeded weights and inputs
(``weights.py``), the FLOP and byte bounds (``bounds.py``), the profiler
arithmetic (``trace.py``), the plain fp32 reference (``reference/``) and the
comparison (``check.py``).  Nothing here imports ``jax`` or the JAX package.
"""
