"""Typed metrics: Counter / Gauge / Info / Histogram + the registry.

Port of ``repro.obs.metrics``, kept as its own copy.  The registry
replaces a plain ``metrics`` dict whose keys had mixed lifetimes (some
accumulated across ``generate()`` calls, some were refreshed per call,
and the derived rates conflated the two), and makes the lifetime of
every number explicit:

  * **Counter** — monotone, accumulates across the engine's whole life
    (``generated``, ``prefills``, ``rejected``, ``prefill_traces``, ...).
  * **Gauge** — point-in-time value, last write wins (``sched_budget``,
    ``decode_block_last``, ``kv_bytes_peak``, derived rates).
  * **Info** — configuration constants and provenance strings
    (``quant``, ``plan_source``, ``tune_table``); excluded from numeric
    aggregation, exported as a single labeled info sample.
  * **Histogram** — log-spaced buckets with p50/p90/p99 read-out
    (``ttft_s``, ``tpot_s``, ``queue_wait_s``, ``chunk_latency_s``, ...).

Two snapshot views resolve the lifetime ambiguity (DESIGN.md §17):
``"lifetime"`` reports totals since construction; ``"last_generate"``
reports the window since the most recent ``Registry.mark()`` (the engine
marks at the top of every ``generate()``).  Counters subtract their
marked value; histograms subtract their marked bucket counts, so
percentiles are computable PER WINDOW from the same storage; gauges and
infos are point-in-time in both views.

``MetricsView`` is a live read-only ``Mapping`` over the lifetime view —
the backwards-compatible ``engine.metrics``: every pre-existing key
resolves to the same number as before, ``dict(engine.metrics)`` still
snapshots, and histogram families additionally expand to
``<name>_count`` / ``<name>_mean`` / ``<name>_p50`` / ``_p90`` / ``_p99``.
"""

from __future__ import annotations

import math
from bisect import bisect_left
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

VIEWS = ("lifetime", "last_generate")

_PCTS = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99))


def _check_view(view: str) -> None:
    if view not in VIEWS:
        raise ValueError(f"unknown view {view!r} (lifetime | last_generate)")


class Counter:
    """Monotone accumulator.  ``lifetime`` = total since construction;
    ``last_generate`` = delta since the registry's last ``mark()``."""

    kind = "counter"
    __slots__ = ("name", "help", "_value", "_marked")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._marked = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative inc {v}")
        self._value += v

    def mark(self) -> None:
        self._marked = self._value

    def value(self, view: str = "lifetime") -> float:
        return (self._value if view == "lifetime"
                else self._value - self._marked)


class Gauge:
    """Point-in-time value; identical in both views."""

    kind = "gauge"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = "", value: float = 0.0):
        self.name = name
        self.help = help
        self._value = value

    def set(self, v: float) -> None:
        self._value = v

    def max(self, v: float) -> None:
        """Monotone-max update (peak trackers)."""
        if v > self._value:
            self._value = v

    def mark(self) -> None:
        pass

    def value(self, view: str = "lifetime") -> float:
        return self._value


class Info:
    """Configuration / provenance value of any scalar type (str, int,
    float).  Settable (plan provenance changes after tuning) but outside
    the numeric aggregation paths."""

    kind = "info"
    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = "", value: Any = None):
        self.name = name
        self.help = help
        self._value = value

    def set(self, v: Any) -> None:
        self._value = v

    def mark(self) -> None:
        pass

    def value(self, view: str = "lifetime") -> Any:
        return self._value


def log_buckets(lo: float, hi: float, per_decade: int) -> Tuple[float, ...]:
    """Log-spaced upper bounds ``lo * 10**(i/per_decade)`` covering
    ``[lo, hi]`` inclusive (the last bound is >= hi)."""
    if not (lo > 0 and hi > lo and per_decade > 0):
        raise ValueError(f"bad bucket spec lo={lo} hi={hi} "
                         f"per_decade={per_decade}")
    n = math.ceil(per_decade * math.log10(hi / lo))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


class Histogram:
    """Log-spaced-bucket histogram with percentile read-out.

    Buckets are upper bounds ``le``: observation ``v`` lands in the
    first bucket whose bound is >= v; values above the last bound land
    in the overflow bucket.  Percentiles interpolate GEOMETRICALLY
    inside the selected bucket (log-spaced grid, so the log-linear
    assumption matches the bucket shape) and clamp to the observed
    min/max — p50 <= p90 <= p99 by construction (one cumulative scan,
    monotone ranks).  Marked bucket counts make window percentiles as
    cheap as lifetime ones.
    """

    kind = "histogram"
    __slots__ = ("name", "help", "unit", "bounds", "_counts", "_marked",
                 "_count", "_sum", "_min", "_max",
                 "_m_count", "_m_sum")

    def __init__(self, name: str, help: str = "", *, lo: float = 1e-5,
                 hi: float = 100.0, per_decade: int = 4, unit: str = "s"):
        self.name = name
        self.help = help
        self.unit = unit
        self.bounds = log_buckets(lo, hi, per_decade)
        self._counts = [0] * (len(self.bounds) + 1)
        self._marked = [0] * (len(self.bounds) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._m_count = 0
        self._m_sum = 0.0

    def observe(self, v: float) -> None:
        if not math.isfinite(v):
            return                       # nan ttft (rejected) never lands
        self._counts[bisect_left(self.bounds, v)] += 1
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    def mark(self) -> None:
        self._marked = list(self._counts)
        self._m_count = self._count
        self._m_sum = self._sum

    # ------------------------------------------------------------ reads
    def counts(self, view: str = "lifetime") -> List[int]:
        if view == "lifetime":
            return list(self._counts)
        return [c - m for c, m in zip(self._counts, self._marked)]

    def count(self, view: str = "lifetime") -> int:
        return (self._count if view == "lifetime"
                else self._count - self._m_count)

    def sum(self, view: str = "lifetime") -> float:
        return (self._sum if view == "lifetime"
                else self._sum - self._m_sum)

    def mean(self, view: str = "lifetime") -> float:
        n = self.count(view)
        return self.sum(view) / n if n else math.nan

    def percentile(self, q: float, view: str = "lifetime") -> float:
        """Rank-``q`` estimate from bucket counts (nan when empty)."""
        if not (0.0 < q <= 1.0):
            raise ValueError(f"quantile {q} outside (0, 1]")
        counts = self.counts(view)
        total = sum(counts)
        if total == 0:
            return math.nan
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                frac = (target - cum) / c
                if i >= len(self.bounds):          # overflow bucket
                    est = self._max
                else:
                    upper = self.bounds[i]
                    lower = (self.bounds[i - 1] if i > 0
                             else upper / (self.bounds[1] / self.bounds[0]))
                    est = lower * (upper / lower) ** frac
                return min(max(est, self._min), self._max)
            cum += c
        return self._max                            # q == 1.0 fallthrough


class Registry:
    """Ordered collection of typed metrics with get-or-create accessors
    and the two snapshot views.  Re-declaring a name with a different
    type raises — the registry is the single source of truth for what
    each number IS."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    # ----------------------------------------------------- declarations
    def _declare(self, cls, name: str, help: str, **kw):
        got = self._metrics.get(name)
        if got is not None:
            if not isinstance(got, cls):
                raise TypeError(f"metric {name!r} already declared as "
                                f"{got.kind}, not {cls.kind}")
            return got
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "",
              value: float = 0.0) -> Gauge:
        return self._declare(Gauge, name, help, value=value)

    def info(self, name: str, help: str = "", value: Any = None) -> Info:
        return self._declare(Info, name, help, value=value)

    def histogram(self, name: str, help: str = "", *, lo: float = 1e-5,
                  hi: float = 100.0, per_decade: int = 4,
                  unit: str = "s") -> Histogram:
        return self._declare(Histogram, name, help, lo=lo, hi=hi,
                             per_decade=per_decade, unit=unit)

    # ----------------------------------------------------------- access
    def __getitem__(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def metrics(self) -> List[Any]:
        return list(self._metrics.values())

    # ------------------------------------------------------------ views
    def mark(self) -> None:
        """Open a new ``last_generate`` window (the engine calls this at
        the top of every ``generate()``)."""
        for m in self._metrics.values():
            m.mark()

    def snapshot(self, view: str = "lifetime") -> Dict[str, Any]:
        """Flat materialized dict: counters/gauges/infos by name,
        histograms expanded to ``_count``/``_mean``/``_p50``/``_p90``/
        ``_p99``."""
        _check_view(view)
        out: Dict[str, Any] = {}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                out[m.name + "_count"] = m.count(view)
                out[m.name + "_mean"] = m.mean(view)
                for tag, q in _PCTS:
                    out[f"{m.name}_{tag}"] = m.percentile(q, view)
            else:
                out[m.name] = m.value(view)
        return out


class MetricsView(Mapping):
    """Live read-only ``Mapping`` over a registry view — the engine's
    backwards-compatible ``metrics`` attribute.  ``dict(view)``,
    ``view["generated"]``, iteration, and ``len`` all work; writes go
    through the registry's typed handles, never through this view."""

    __slots__ = ("_reg", "_view")

    def __init__(self, registry: Registry, view: str = "lifetime"):
        _check_view(view)
        self._reg = registry
        self._view = view

    def _keys(self) -> List[str]:
        out: List[str] = []
        for m in self._reg.metrics():
            if isinstance(m, Histogram):
                out.extend(f"{m.name}_{suffix}" for suffix in
                           ("count", "mean", "p50", "p90", "p99"))
            else:
                out.append(m.name)
        return out

    def __getitem__(self, key: str) -> Any:
        m = self._reg._metrics.get(key)
        if m is not None and not isinstance(m, Histogram):
            return m.value(self._view)
        base, _, suffix = key.rpartition("_")
        h = self._reg._metrics.get(base)
        if isinstance(h, Histogram):
            if suffix == "count":
                return h.count(self._view)
            if suffix == "mean":
                return h.mean(self._view)
            for tag, q in _PCTS:
                if suffix == tag:
                    return h.percentile(q, self._view)
        raise KeyError(key)

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys())

    def __len__(self) -> int:
        return len(self._keys())

    def __repr__(self) -> str:
        return f"MetricsView({self._view}, {dict(self)!r})"
