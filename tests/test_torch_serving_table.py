"""The port's serving sweep on intel-volta-pcie against the committed
``BENCH_umbench.json``: all 108 clean cells of that platform (3 traffic
patterns x 12 variants x 3 KV regimes), each row equal to the artifact's at
its rounding (``total_s``, the latency percentiles and goodput at 4
decimals, ``completed``, ``faults``, ``evictions`` and the GB moved), and
N/A exactly where the artifact has N/A.  The sweep's other platform is in
tests/test_torch_serving_table_p9.py, so that the two halves run side by side.
"""
import pytest

from _torch_serving_table import check_platform_regime

PLATFORM = "intel-volta-pcie"


@pytest.mark.parametrize("regime", ("kv_100", "kv_150", "kv_200"))
def test_serving_cells_equal_committed_artifact(regime):
    check_platform_regime(PLATFORM, regime)
