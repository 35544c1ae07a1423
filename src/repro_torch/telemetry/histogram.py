"""Fixed-bucket latency histogram behind the tracer's per-span-name
durations and the serving tier's latency percentiles
(:mod:`repro_torch.serving.metrics` imports it from here).

Geometric buckets of 0.1 ms x 1.35^i, 48 of them (~0.1 ms to ~180 s) plus
an overflow bucket, so a long-lived traced process or service aggregates
without per-sample storage. A reported percentile is the upper bound of
its bucket.
"""
from __future__ import annotations

from typing import Dict, List

__all__ = ["LatencyHistogram"]

_BUCKET_BASE_S = 1e-4
_BUCKET_RATIO = 1.35
_N_BUCKETS = 48


def _bucket_bounds() -> List[float]:
    bounds = []
    b = _BUCKET_BASE_S
    for _ in range(_N_BUCKETS):
        bounds.append(b)
        b *= _BUCKET_RATIO
    return bounds


_BOUNDS = _bucket_bounds()


class LatencyHistogram:
    """Fixed-bucket latency histogram with percentile readout.

    Not thread-safe on its own; the tracer and ``ServeMetrics`` serialize
    access.
    """

    def __init__(self) -> None:
        self.counts = [0] * (_N_BUCKETS + 1)  # +1 overflow bucket
        self.total = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def record(self, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        lo, hi = 0, _N_BUCKETS
        while lo < hi:  # first bucket whose upper bound >= seconds
            mid = (lo + hi) // 2
            if _BOUNDS[mid] >= seconds:
                hi = mid
            else:
                lo = mid + 1
        self.counts[lo] += 1
        self.total += 1
        self.sum_s += seconds
        self.max_s = max(self.max_s, seconds)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold ``other`` into this histogram in place (and return self);
        the bucket bounds are module constants, so the sum is exact."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.total += other.total
        self.sum_s += other.sum_s
        self.max_s = max(self.max_s, other.max_s)
        return self

    def percentile(self, q: float) -> float:
        """Upper bound (seconds) of the bucket holding the q-th percentile."""
        if not self.total:
            return 0.0
        rank = max(1, int(q / 100.0 * self.total + 0.9999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return _BOUNDS[i] if i < _N_BUCKETS else self.max_s
        return self.max_s  # pragma: no cover - rank <= total by construction

    def snapshot(self) -> Dict[str, float]:
        mean = self.sum_s / self.total if self.total else 0.0
        return {
            "count": self.total,
            "mean_ms": round(mean * 1e3, 3),
            "p50_ms": round(self.percentile(50) * 1e3, 3),
            "p90_ms": round(self.percentile(90) * 1e3, 3),
            "p99_ms": round(self.percentile(99) * 1e3, 3),
            "max_ms": round(self.max_s * 1e3, 3),
        }
