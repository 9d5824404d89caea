"""Crash-safe sweep checkpointing (DESIGN.md §12): the port's copy of
``repro.umbench.journal``.

A :class:`SweepJournal` is an append-only JSONL file: one line per
completed matrix cell, written with flush+fsync so a SIGKILL'd (or
SIGTERM'd, or power-cut) sweep loses at most the line being written — and
a torn final line is detected and skipped on load, never propagated.
A sweep handed a journal (``run_specs(journal=...)``) replays completed
cells from disk on a restart and re-runs only the incomplete ones;
``reused``/``ran`` counters make "completed cells were not re-run"
assertable (tests/test_torch_umbench.py).

Cells are keyed on (app, platform, variant, regime, granularity, faults)
— the full identity run_cell accepts.  Reports are serialized at full
precision (``SimReport.to_json_dict``), so a journal-replayed cell is
bit-identical to the run that produced it.  Failure records (cells that
timed out, crashed, or raised) are journaled too, but are treated as
*incomplete* on load: a resume retries them rather than pinning a
transient crash into the artifact.
"""
from __future__ import annotations

import json
import os

from repro_torch.core.simulator import SimReport

__all__ = ["SweepJournal", "cell_key", "decode_cell", "encode_cell"]


def cell_key(cell) -> tuple:
    """Journal identity of a CellResult (or anything with its fields)."""
    return (cell.app, cell.platform, cell.variant, cell.regime,
            cell.granularity, getattr(cell, "faults", None))


def encode_cell(cell) -> dict:
    """One cell as a JSON-able record — the journal's line format, shared
    with the content-addressed cell cache (``umbench.cellcache``) so a
    cache-replayed cell is reconstructed by exactly the code path the
    crash-resume journal already proves bit-identical."""
    rec = {
        "key": list(cell_key(cell)),
        "report": (None if cell.report is None
                   else cell.report.to_json_dict()),
        "error": getattr(cell, "error", None),
    }
    error_kind = getattr(cell, "error_kind", None)
    if error_kind is not None:
        rec["error_kind"] = error_kind  # "lint"/"audit" analysis tag
    #                                     (failures are retried on load,
    #                                     so this is a diagnostic field)
    kind = getattr(cell, "journal_kind", "cell")
    if kind != "cell":
        rec["kind"] = kind  # e.g. "serving": reconstructed as its own
    #                         cell family on load; absent = matrix cell,
    #                         so pre-existing journals load unchanged
    return rec


def decode_cell(rec: dict):
    """Reconstruct a clean cell from :func:`encode_cell`'s record shape.
    Only clean records are decodable by design: failure records are
    *incomplete* (journal loads skip them; the cache never stores them)."""
    from repro_torch.umbench.harness import CellResult
    rep = rec.get("report")
    if rec.get("kind") == "serving":
        from repro_torch.umbench.serving.metrics import ServingReport
        from repro_torch.umbench.serving.sweep import ServingCellResult
        return ServingCellResult(
            app=rec["key"][0], platform=rec["key"][1],
            variant=rec["key"][2], regime=rec["key"][3],
            report=(None if rep is None
                    else ServingReport.from_json_dict(rep)),
            granularity=rec["key"][4], faults=rec["key"][5],
        )
    return CellResult(
        app=rec["key"][0], platform=rec["key"][1],
        variant=rec["key"][2], regime=rec["key"][3],
        report=(None if rep is None else SimReport.from_json_dict(rep)),
        granularity=rec["key"][4], faults=rec["key"][5],
    )


class SweepJournal:
    """Append-only per-cell checkpoint for one sweep.

    ``completed`` maps :func:`cell_key` tuples to reconstructed
    CellResults loaded from a previous (interrupted) run.  ``record``
    appends one cell durably.  ``reused`` counts cells a sweep answered
    from the journal instead of re-running; ``ran`` counts fresh runs.
    """

    def __init__(self, path: str, *, resume: bool = True):
        self.path = str(path)
        self.completed: dict[tuple, object] = {}
        self.reused = 0
        self.ran = 0
        if resume:
            self._load()
        elif os.path.exists(self.path):
            os.unlink(self.path)    # fresh run: a stale journal must not
        #                             suppress re-runs of changed code
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a")

    # -- load ------------------------------------------------------------------
    def _load(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue        # torn final line from the crash: skip
                if not isinstance(rec, dict) or "key" not in rec:
                    continue
                if rec.get("error") is not None:
                    continue        # failures are incomplete: retry them
                self.completed[tuple(rec["key"])] = decode_cell(rec)

    # -- append ----------------------------------------------------------------
    def record(self, cell) -> None:
        """Durably append one completed (or failed) cell."""
        self._fh.write(json.dumps(encode_cell(cell)) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def lookup(self, key: tuple):
        """The journaled cell for ``key`` (bumping ``reused``), or None."""
        cell = self.completed.get(tuple(key))
        if cell is not None:
            self.reused += 1
        return cell

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "SweepJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
