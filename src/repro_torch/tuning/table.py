"""Persistent measured-latency table: the autotuner's build-once cache.

A copy of the reference's ``repro.tuning.table``.  One JSON file holds
every latency the tuner has established for one backend: entries are
keyed by the full candidate identity (kernel implementation, op shape
context, dtype, quant mode, mesh axes, candidate blocks; ``make_key``,
byte-equal to the reference's keys), and the FILE is stamped with a
schema version and a backend fingerprint, so that a table measured on one
machine is never trusted on another.

The fingerprint is the port's own (``backend_fingerprint``): ``cpu:plain``
for the plain versions on the CPU, ``cuda:<card name>:sm_<major><minor>``
on a card.  A table scored on the CPU, or written by the reference (whose
fingerprints are JAX backends, ``cpu:interpret`` / ``tpu:compiled``),
loads on the card as an empty table with a ``table-backend`` warning, and
the reverse holds too.

Contract (DESIGN.md §16), as the reference's:

  * **build-once / reuse**: the first engine start measures (or, on the
    CPU, analytically scores) every lint-legal candidate and writes the
    table; every later start resolves its plan from the file with zero
    measurements.
  * **atomic writes**: ``save`` writes a temp file in the same directory
    and ``os.replace``s it over the target: a concurrent reader (or a
    crash mid-write) sees the old table or the new one, never a torn file.
  * **graceful fallback**: a missing, corrupt, schema-mismatched or
    wrong-backend file degrades to an EMPTY table plus a warning
    ``Diagnostic`` (pass ``tuning``); the tuner then scores candidates
    again.  It never raises out of the serving path.
  * **frozen mode**: ``frozen=True`` forbids fills and saves, the
    reproducibility mode: a frozen table yields bit-identical plans on
    every resolution.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ..analysis.diagnostics import Diagnostic
from ..kernels.common import DeviceLike, resolve_device

SCHEMA_VERSION = 1


def backend_fingerprint(device: DeviceLike = None) -> str:
    """Identity of the machine the measurements describe: ``cpu:plain``
    for the plain versions (their wall-clock says nothing about the card),
    ``cuda:<name>:sm_<major><minor>`` for a card.  ``device`` None means
    the card, which raises where there is none."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "cpu:plain"
    if dev.type != "cuda":
        raise ValueError(f"no tune-table backend for device {dev}")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device available for {dev}; pass "
                           "device='cpu' to tune the plain versions")
    major, minor = torch.cuda.get_device_capability(dev)
    return f"cuda:{torch.cuda.get_device_name(dev)}:sm_{major}{minor}"


@dataclass(frozen=True)
class TuneEntry:
    """One cached candidate latency."""
    latency_s: float
    source: str = "analytic"    # "measured" | "analytic"
    samples: int = 1


def make_key(kernel: str, *, shape: Iterable[Tuple[str, int]],
             dtype: str, quant: str,
             mesh_axes: Iterable[Tuple[str, int]],
             blocks: Iterable[Tuple[str, int]]) -> str:
    """Canonical entry key.  Every field that changes the measured kernel
    program is part of the key; field ORDER inside each group is sorted
    so logically-equal candidates collide."""
    def fmt(pairs) -> str:
        return ",".join(f"{k}={int(v)}" for k, v in sorted(pairs))

    return (f"{kernel}|shape[{fmt(shape)}]|dtype={dtype}|quant={quant}"
            f"|mesh[{fmt(mesh_axes)}]|blocks[{fmt(blocks)}]")


@dataclass
class TuneTable:
    """In-memory view of one on-disk measured-latency table.  ``backend``
    defaults to the card's fingerprint (``backend_fingerprint()``); a table
    for the CPU takes ``backend_fingerprint("cpu")``."""

    path: Optional[str] = None
    backend: str = field(default_factory=backend_fingerprint)
    entries: Dict[str, TuneEntry] = field(default_factory=dict)
    frozen: bool = False
    # Load-time problems (corrupt file, version/backend mismatch): the
    # tuner forwards these as plan diagnostics so the fallback is visible.
    diagnostics: List[Diagnostic] = field(default_factory=list)
    hits: int = 0
    misses: int = 0
    dirty: bool = False

    # ----------------------------------------------------------- access
    def get(self, key: str) -> Optional[TuneEntry]:
        e = self.entries.get(key)
        if e is None:
            self.misses += 1
        else:
            self.hits += 1
        return e

    def put(self, key: str, entry: TuneEntry) -> None:
        if self.frozen:
            raise RuntimeError("frozen TuneTable refuses writes "
                               "(reproducibility mode)")
        self.entries[key] = entry
        self.dirty = True

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------ persistence
    @classmethod
    def load(cls, path: str, *, frozen: bool = False,
             device: DeviceLike = None) -> "TuneTable":
        """Read a table file for ``device`` (None: the card); any defect
        degrades to an empty table with a warning diagnostic instead of
        raising (the serving path must never die on a stale cache)."""
        table = cls(path=path, backend=backend_fingerprint(device),
                    frozen=frozen)
        if not os.path.exists(path):
            return table
        try:
            with open(path) as fh:
                raw = json.load(fh)
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            table.diagnostics.append(Diagnostic(
                "warning", "tuning", "table", "table-corrupt",
                f"tune table {path!r} is unreadable ({e}); falling back "
                "to the analytic cost model",
                "delete the file (it will be rebuilt on the next "
                "autotuned start)"))
            return table
        if not isinstance(raw, dict) or raw.get("version") != SCHEMA_VERSION:
            table.diagnostics.append(Diagnostic(
                "warning", "tuning", "table", "table-version",
                f"tune table {path!r} has schema version "
                f"{raw.get('version') if isinstance(raw, dict) else '?'} "
                f"(expected {SCHEMA_VERSION}); falling back to the "
                "analytic cost model",
                "delete the file or re-tune to regenerate it"))
            return table
        if raw.get("backend") != table.backend:
            table.diagnostics.append(Diagnostic(
                "warning", "tuning", "table", "table-backend",
                f"tune table {path!r} was measured on backend "
                f"{raw.get('backend')!r} but this process runs "
                f"{table.backend!r}; its latencies do not transfer",
                "re-tune on this backend (the file will be replaced)"))
            return table
        try:
            for key, e in raw.get("entries", {}).items():
                table.entries[str(key)] = TuneEntry(
                    latency_s=float(e["latency_s"]),
                    source=str(e["source"]),
                    samples=int(e.get("samples", 1)))
        except (KeyError, TypeError, ValueError) as e:
            table.entries.clear()
            table.diagnostics.append(Diagnostic(
                "warning", "tuning", "table", "table-corrupt",
                f"tune table {path!r} carries malformed entries ({e}); "
                "falling back to the analytic cost model",
                "delete the file and re-tune"))
        return table

    def save(self, path: Optional[str] = None) -> str:
        """Atomic write: temp file in the destination directory, then
        ``os.replace``; concurrent writers last-write-win, and a reader
        never observes a torn file."""
        if self.frozen:
            raise RuntimeError("frozen TuneTable refuses saves")
        path = path or self.path
        if path is None:
            raise ValueError("TuneTable has no path to save to")
        payload = {
            "version": SCHEMA_VERSION,
            "backend": self.backend,
            "entries": {k: {"latency_s": e.latency_s, "source": e.source,
                            "samples": e.samples}
                        for k, e in sorted(self.entries.items())},
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".tune-", suffix=".json", dir=d)
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.path = path
        self.dirty = False
        return path
