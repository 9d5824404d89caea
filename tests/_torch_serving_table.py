"""Shared check of tests/test_torch_serving_table*.py: the port's serving
sweep, one platform and regime at a time, against the committed
``BENCH_umbench.json`` (the JAX package's artifact, read as data only)."""
import json
from pathlib import Path

from repro_torch.bench import paper_tables
from repro_torch.umbench.serving import (
    SERVING_REGIMES,
    run_serving_specs,
    serving_specs,
)

REPO = Path(__file__).resolve().parent.parent
KEY = ("app", "platform", "variant", "regime", "granularity")


def artifact_serving_rows() -> dict:
    cells = json.loads((REPO / "BENCH_umbench.json").read_text())["cells"]
    return {tuple(c[f] for f in KEY): c for c in cells
            if c["app"].startswith("serve_")}


def check_platform_regime(platform: str, regime: str) -> None:
    """Every clean serving cell of ``paper_tables.serving_cells`` on
    ``platform`` at ``regime``: its ``row()`` (the artifact's rounding)
    equals the committed row, N/A included."""
    assert platform in paper_tables.SERVING_PLATFORMS
    assert regime in SERVING_REGIMES
    want = artifact_serving_rows()
    assert len(want) == 216
    specs = serving_specs(paper_tables.SERVING_PATTERNS, (platform,), (regime,))
    assert len(specs) == 36
    for cell in run_serving_specs(specs, workers=1):
        row = cell.row()
        key = tuple(row[f] for f in KEY)
        assert cell.error is None, key
        assert row == want[key], (key, row, want[key])
