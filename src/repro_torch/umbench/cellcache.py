"""Content-addressed cell cache (DESIGN.md §15).

A matrix cell is a pure function of its inputs: the workload trace, the
strategy's configuration, the platform/regime/granularity axes, the fault
scenario, and the engine code that lowers them.  This module makes that
purity operational — each completed cell is persisted under a blake2s
*identity* hash (which cell) carrying a blake2s *input* hash (what went in)
and a *code-rev* digest over ``src/repro_torch/core`` +
``src/repro_torch/umbench`` (what ran it), so a sweep given a cache re-runs
only cells whose inputs or engine actually changed and replays the rest
bit-identically from disk.  The port's copy of ``repro.umbench.cellcache``.

Invalidation is by comparison, never by trust:

==============  ============================================================
miss reason     fires when
==============  ============================================================
``new-cell``    no record exists for the identity (or the record is
                corrupt/undecodable — a torn or poisoned file re-runs, it
                never replays)
``code-rev``    any ``.py`` file under ``src/repro_torch/core`` or
                ``src/repro_torch/umbench`` changed since the record was
                written
``input-change``the workload trace bytes, strategy name/params, or any
                other identity axis hashed into the input fingerprint
                changed
==============  ============================================================

Records are written atomically (temp file + ``os.replace``) next to the
sweep journals' directory, and unlike the journals they *persist* across
successful runs — the journal is crash-resume state for one sweep, the
cache is memoization across sweeps.  Serialization is shared with
:mod:`repro_torch.umbench.journal` (``encode_cell``/``decode_cell``), so a
cache-replayed cell takes exactly the reconstruction path the resume
machinery already proves bit-identical.  Failure records (timeouts,
crashes, lint/audit refusals) are never cached: a transient failure must
not be pinned into future artifacts.
"""
from __future__ import annotations

import hashlib
import json
import os

__all__ = [
    "CellCache",
    "MISS_CODE_REV",
    "MISS_INPUT_CHANGE",
    "MISS_NEW_CELL",
    "code_rev",
    "serving_spec_fingerprint",
    "spec_fingerprint",
]

MISS_NEW_CELL = "new-cell"
MISS_CODE_REV = "code-rev"
MISS_INPUT_CHANGE = "input-change"
MISS_REASONS = (MISS_NEW_CELL, MISS_CODE_REV, MISS_INPUT_CHANGE)

_CODE_REV: str | None = None
# (app, platform, regime) -> workload trace digest; trace construction is
# pure and cheap, but a warm 1152-cell sweep asks for each (app, platform,
# regime) combination several times across variants
_TRACE_MEMO: dict[tuple, str] = {}


def code_rev() -> str:
    """blake2s digest over every ``.py`` file under ``src/repro_torch/core``
    and ``src/repro_torch/umbench`` (sorted relative paths + contents), memoized per
    process: the cache key's "what ran it" component.  Touching any engine
    or harness file — even a comment — invalidates every cached cell, which
    is exactly the conservative direction (a stale hit silently corrupts
    BENCH; a spurious re-run only costs time)."""
    global _CODE_REV
    if _CODE_REV is None:
        import repro_torch.core
        import repro_torch.umbench
        h = hashlib.blake2s()
        # __path__, not __file__: the package's directory, whatever its
        # __init__ holds
        for pkg in (repro_torch.core, repro_torch.umbench):
            root = os.path.abspath(next(iter(pkg.__path__)))
            h.update(os.path.basename(root).encode() + b"\0")
            for dirpath, dirnames, filenames in os.walk(root):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__")
                for fn in sorted(filenames):
                    if not fn.endswith(".py"):
                        continue
                    path = os.path.join(dirpath, fn)
                    h.update(os.path.relpath(path, root).encode() + b"\0")
                    with open(path, "rb") as f:
                        h.update(f.read())
                    h.update(b"\0")
        _CODE_REV = h.hexdigest()
    return _CODE_REV


def _reset_code_rev() -> None:
    """Drop the memoized digest (tests re-hash after touching files)."""
    global _CODE_REV
    _CODE_REV = None


def _strategy_fingerprint(strategy) -> str:
    """A strategy's identity: class, registry name, and every instance
    attribute (policies/thresholds/lookahead are dataclasses or scalars with
    deterministic reprs) — renaming or re-tuning a param changes it."""
    if isinstance(strategy, str):
        from repro_torch.umbench import variants as var
        strategy = var.get_strategy(strategy)
    state = sorted(vars(strategy).items())
    return f"{type(strategy).__name__}:{strategy.name}:{state!r}"


def _digest(*parts: str) -> str:
    h = hashlib.blake2s()
    for part in parts:
        h.update(part.encode())
        h.update(b"\0")
    return h.hexdigest()


def spec_fingerprint(spec: tuple) -> str:
    """Input hash for a harness matrix spec: the exact workload trace bytes
    ``run_cell`` would lower (the builders are pure, so building it here is
    the trace the worker sees), the resolved strategy's configuration, and
    the platform/regime/granularity/faults axes."""
    from repro_torch.core.simulator import GB
    from repro_torch.umbench import harness
    from repro_torch.umbench import platforms as plat
    app, pname, vname, regime, granularity, fname, _ = \
        harness._spec_fields(spec)
    memo_key = (app, pname, regime)
    trace = _TRACE_MEMO.get(memo_key)
    if trace is None:
        p = plat.PLATFORMS[pname]
        total = harness.REGIMES[regime] * p.device_mem_gb * GB
        trace = _digest(repr(harness.WORKLOADS[app](total)))
        _TRACE_MEMO[memo_key] = trace
    return _digest(trace, _strategy_fingerprint(spec[2]), pname, regime,
                   granularity, str(fname))


def serving_spec_fingerprint(spec: tuple) -> str:
    """Input hash for a serving spec: the cell-salted request trace the
    scheduler will serve, the scheduler config, the KV budget fraction, and
    the same strategy/axis components as :func:`spec_fingerprint`."""
    from repro_torch.umbench import harness
    from repro_torch.umbench.serving.scheduler import ServingConfig
    from repro_torch.umbench.serving.sweep import SERVING_REGIMES
    from repro_torch.umbench.serving.traffic import get_pattern
    app, pname, vname, regime, granularity, fname, _ = \
        harness._spec_fields(spec)
    pat = get_pattern(app[len("serve_"):])
    salt = f"{app}:{pname}:{vname}:{regime}:{granularity}"
    requests = pat.generate(salt=salt)
    return _digest(repr(requests), repr(ServingConfig()),
                   repr(SERVING_REGIMES[regime]),
                   _strategy_fingerprint(spec[2]), pname, regime,
                   granularity, str(fname))


class CellCache:
    """One sweep's view of the on-disk cell cache.

    ``lookup`` resolves a cell identity + input hash to a reconstructed
    cell (bumping ``hits`` and remembering the key in ``hit_keys``) or
    records the keyed miss reason; ``record`` persists a clean cell
    atomically.  Several sweeps may share a directory — identities are
    globally unique, and instances are cheap per-sweep stat scopes.
    """

    def __init__(self, directory: str, rev: str | None = None):
        self.dir = str(directory)
        os.makedirs(self.dir, exist_ok=True)
        self.rev = code_rev() if rev is None else rev
        self.hits = 0
        self.misses: dict[str, int] = {}
        self.hit_keys: set[tuple] = set()

    def _path(self, key: tuple) -> str:
        ident = hashlib.blake2s(repr(tuple(key)).encode()).hexdigest()
        return os.path.join(self.dir, f"{ident}.json")

    def _miss(self, reason: str) -> None:
        self.misses[reason] = self.misses.get(reason, 0) + 1

    def lookup(self, key: tuple, input_hash: str):
        """The cached cell for ``key``, or None with the miss reason
        tallied.  A hit requires the record to decode AND both the code-rev
        digest and the input hash to match — corruption or divergence on
        any component re-runs the cell."""
        from repro_torch.umbench.journal import decode_cell
        try:
            with open(self._path(key)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            self._miss(MISS_NEW_CELL)       # absent, torn, or poisoned
            return None
        if not isinstance(rec, dict) or rec.get("key") != list(key):
            self._miss(MISS_NEW_CELL)       # foreign/corrupt record
            return None
        if rec.get("code_rev") != self.rev:
            self._miss(MISS_CODE_REV)
            return None
        if rec.get("input_hash") != input_hash:
            self._miss(MISS_INPUT_CHANGE)
            return None
        try:
            cell = decode_cell(rec)
        except Exception:  # noqa: BLE001 — undecodable = poisoned: re-run
            self._miss(MISS_NEW_CELL)
            return None
        self.hits += 1
        self.hit_keys.add(tuple(key))
        return cell

    def record(self, cell, input_hash: str) -> None:
        """Persist one clean cell atomically (temp + rename: a crash can
        leave a stale record, never a torn one).  Failure records are
        dropped — a timeout/crash must not be replayed as a result."""
        if getattr(cell, "error", None) is not None:
            return
        from repro_torch.umbench.journal import encode_cell
        rec = encode_cell(cell)
        rec["code_rev"] = self.rev
        rec["input_hash"] = input_hash
        path = self._path(tuple(rec["key"]))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f)
        os.replace(tmp, path)

    def stats(self) -> dict:
        """``{"hits": n, "misses": {reason: n, ...}}`` for this sweep."""
        return {"hits": self.hits, "misses": dict(self.misses)}
