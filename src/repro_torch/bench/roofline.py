"""Roofline table: the counterpart of ``benchmarks/roofline.py``.  It reads
the port's dry-run records (artifacts/torch_dryrun/*.json, written by
``repro_torch.launch.dryrun``) and renders the per-cell three-term
analysis.  The terms are roofline estimates at an H100's constants
(``launch/analysis.py``), not measurements."""
from __future__ import annotations

import json
import pathlib

from repro_torch.launch.dryrun import DEFAULT_OUT

ARTIFACTS = DEFAULT_OUT


def load_records(mesh: str | None = "16x16", artifacts: pathlib.Path | None = None) -> list[dict]:
    root = pathlib.Path(artifacts or ARTIFACTS)
    recs = []
    if not root.exists():
        return recs
    for p in sorted(root.glob("*.json")):
        r = json.loads(p.read_text())
        if mesh is not None and r.get("mesh") != mesh:
            continue
        recs.append(r)
    return recs


def roofline_rows(mesh: str = "16x16", artifacts: pathlib.Path | None = None) -> list[str]:
    rows = [
        "table,arch,shape,mesh,status,compute_s,memory_s,collective_s,"
        "bound,model_tflops,useful_ratio,mfu_roofline,perdev_gb"
    ]
    for r in load_records(mesh, artifacts):
        if r["status"] == "skipped":
            rows.append(
                f"roofline,{r['arch']},{r['shape']},{r['mesh']},skipped,"
                f"-,-,-,-,-,-,-,-")
            continue
        if r["status"] != "ok" or "roofline" not in r:
            rows.append(
                f"roofline,{r['arch']},{r['shape']},{r['mesh']},"
                f"{r['status']},-,-,-,-,-,-,-,-")
            continue
        ro = r["roofline"]
        mem = r.get("memory_analysis", {})
        perdev = mem.get("peak_extra_gb", 0) + mem.get("argument_gb", 0)
        rows.append(
            f"roofline,{r['arch']},{r['shape']},{r['mesh']},ok,"
            f"{ro['compute_s']:.3f},{ro['memory_s']:.3f},"
            f"{ro['collective_s']:.3f},{ro['bound']},"
            f"{ro['model_flops_total'] / 1e12:.1f},"
            f"{ro['useful_flops_ratio']:.3f},{ro['mfu_at_roofline']:.4f},"
            f"{perdev:.2f}"
        )
    return rows


def dryrun_rows(artifacts: pathlib.Path | None = None) -> list[str]:
    """Dry-run summary: trace status + per-device bytes, both meshes."""
    rows = ["table,arch,shape,mesh,status,perdev_gb,compile_s,collective_ops"]
    for r in load_records(mesh=None, artifacts=artifacts):
        mem = r.get("memory_analysis", {})
        perdev = mem.get("peak_extra_gb", 0) + mem.get("argument_gb", 0)
        colls = r.get("collectives_raw", {}).get("counts", {})
        rows.append(
            f"dryrun,{r['arch']},{r['shape']},{r['mesh']},{r['status']},"
            f"{perdev:.2f},{r.get('compile_s', '-')},"
            f"{sum(colls.values()) if colls else '-'}"
        )
    return rows


if __name__ == "__main__":
    print("\n".join(roofline_rows() + dryrun_rows()))
