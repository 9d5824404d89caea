"""The paper's benchmark suite on PyTorch: the apps, the UM sweep engine
(workload, variants, schedule, platforms, harness, cellcache, journal) and
its analyses.  The engine is NumPy on the host, as the reference's is."""
