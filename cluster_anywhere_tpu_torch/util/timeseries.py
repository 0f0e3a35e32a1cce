"""Head-side time-series retention for cluster metrics (the metrics plane's
history half; analogue of the reference's reliance on an external Prometheus
for rates — here a bounded in-head store so dashboards and `ca top` get
rates and sparklines with zero extra processes).

A `TimeSeriesStore` keeps one ring buffer per (metric name, tags) series per
resolution tier.  The default tiers are 10 s x 360 (one hour at scrape
resolution) and 120 s x 360 (twelve hours coarse); tier-1 samples are taken
from the tier-0 stream, so one `record()` call per sampling tick feeds both.
Values are stored as sampled *cumulative* levels; counter→rate derivation
happens at query time (successive diffs / dt, negative diffs — a process
restart resetting a counter — clamp to zero).  Everything is bounded: series
count (`max_series`, oldest-name drop with a counter), ring length, and the
memory estimate is first-class (`memory_bytes()`) because the store lives on
the head's loop and must never become the thing the metrics plane exists to
diagnose.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_TIERS: Tuple[Tuple[float, int], ...] = ((10.0, 360), (120.0, 360))


class Series:
    """One (name, tags) series: a ring per tier of (ts, value) samples."""

    __slots__ = ("kind", "rings", "_tier_last_ts")

    def __init__(self, kind: str, tiers: Sequence[Tuple[float, int]]):
        self.kind = kind  # "counter" | "gauge"
        self.rings: List[deque] = [deque(maxlen=n) for _, n in tiers]
        self._tier_last_ts: List[float] = [0.0] * len(tiers)

    def add(self, ts: float, value: float, tiers: Sequence[Tuple[float, int]]):
        for i, (interval, _) in enumerate(tiers):
            # tier 0 takes every sample (the caller's tick IS the tier-0
            # cadence); coarser tiers keep one sample per interval
            if i == 0 or ts - self._tier_last_ts[i] >= interval:
                self.rings[i].append((ts, value))
                self._tier_last_ts[i] = ts

    def points(self, tier: int) -> List[Tuple[float, float]]:
        return list(self.rings[tier])

    def rates(self, tier: int) -> List[Tuple[float, float]]:
        """Per-second rate between successive samples (counter semantics:
        negative diffs are a reset, clamped to 0).  Gauges pass through."""
        pts = self.rings[tier]
        if self.kind != "counter":
            return list(pts)
        out: List[Tuple[float, float]] = []
        prev = None
        for ts, v in pts:
            if prev is not None:
                dt = ts - prev[0]
                if dt > 0:
                    out.append((ts, max(v - prev[1], 0.0) / dt))
            prev = (ts, v)
        return out


class TimeSeriesStore:
    def __init__(
        self,
        tiers: Sequence[Tuple[float, int]] = DEFAULT_TIERS,
        max_series: int = 1024,
    ):
        self.tiers = tuple((float(i), int(n)) for i, n in tiers)
        self.max_series = max_series
        self._series: Dict[Tuple[str, str], Series] = {}
        self.series_dropped = 0  # capacity rejections (visible, not silent)
        self.samples_taken = 0

    # ------------------------------------------------------------- recording
    def record(self, name: str, tags_key: str, value: float, kind: str, ts: float):
        key = (name, tags_key)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                # at capacity, REJECT the newcomer (Prometheus-style bounded
                # cardinality).  Evicting the oldest instead would thrash
                # once live series exceed the cap: every tick recreates each
                # series with ~1 sample and ALL history dies, which is worse
                # than missing the newest tag combination.
                self.series_dropped += 1
                return
            s = self._series[key] = Series(kind, self.tiers)
        s.add(ts, float(value), self.tiers)

    def sample_metrics(self, table: Dict[str, dict], ts: float) -> None:
        """Sample an aggregated metrics table (the head's `self.metrics`
        shape: name -> {type, data{tags_key: value|hist}}).  Counters and
        gauges record their level; histograms record their `_count` and
        `_sum` as counter series (rate(_count) = events/s, and
        rate(_sum)/rate(_count) = mean latency over any window — the two
        series every latency dashboard derives from)."""
        for name, rec in table.items():
            t = rec.get("type")
            data = rec.get("data") or {}
            if t in ("counter", "gauge"):
                for tk, v in data.items():
                    self.record(name, tk, float(v), t, ts)
            elif t == "histogram":
                for tk, v in data.items():
                    self.record(name + "_count", tk, float(v["count"]), "counter", ts)
                    self.record(name + "_sum", tk, float(v["sum"]), "counter", ts)
        self.samples_taken += 1

    # --------------------------------------------------------------- queries
    def query(
        self,
        names: Optional[Sequence[str]] = None,
        prefix: Optional[str] = None,
        tier: int = 0,
        rate: bool = False,
    ) -> Dict[str, Dict[str, Any]]:
        """Series as {name: {tags_key: {"kind", "points": [[ts, v], ...]}}}.
        `names` filters exactly (an EMPTY list means no series — meta-only
        callers rely on that), `prefix` by name prefix; names=None = all."""
        tier = max(0, min(tier, len(self.tiers) - 1))
        want = set(names) if names is not None else None
        out: Dict[str, Dict[str, Any]] = {}
        for (name, tk), s in self._series.items():
            if want is not None and name not in want:
                continue
            if prefix and not name.startswith(prefix):
                continue
            pts = s.rates(tier) if rate else s.points(tier)
            out.setdefault(name, {})[tk] = {
                "kind": s.kind,
                "points": [[t, v] for t, v in pts],
            }
        return out

    def latest_rate(self, name: str, tags_key: str = "[]", tier: int = 0) -> float:
        """Most recent per-second rate of one series (0.0 when unknown or
        not enough samples) — what `ca top` renders."""
        s = self._series.get((name, tags_key))
        if s is None:
            return 0.0
        r = s.rates(tier)
        return r[-1][1] if r else 0.0

    # ------------------------------------------------------------------ meta
    def memory_bytes(self) -> int:
        """Rough retained-sample footprint: each sample is a (float, float)
        tuple (~88 B with the tuple header on CPython); ring + dict overhead
        folded into a conservative per-sample constant."""
        n_samples = sum(
            len(ring) for s in self._series.values() for ring in s.rings
        )
        return n_samples * 96 + len(self._series) * 200

    def meta(self) -> Dict[str, Any]:
        return {
            "tiers": [list(t) for t in self.tiers],
            "n_series": len(self._series),
            "series_dropped": self.series_dropped,
            "samples_taken": self.samples_taken,
            "memory_bytes": self.memory_bytes(),
        }
