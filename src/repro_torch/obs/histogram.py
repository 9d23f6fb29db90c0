"""Fixed-bucket log2 latency histograms.

Buckets are log2 octaves subdivided into ``SUBS`` linear sub-buckets
(the HdrHistogram scheme): values below ``SUBS`` get an exact bucket
each, and every larger value lands in bucket

    octave = bit_length(v) - SUB_BITS          (>= 1)
    sub    = (v >> (octave - 1)) - SUBS        (0 .. SUBS-1)

so the worst-case relative width of a bucket is ``1/SUBS`` (~3.1% at
SUB_BITS=5) while the bucket count stays fixed and tiny — an int64
counts array, mergeable across shards by plain addition.

Percentiles use the nearest-rank definition (numpy's ``inverted_cdf``
method): ``percentile(q)`` returns the upper bound of the bucket that
holds the ⌈q·n/100⌉-th smallest recorded value.  Because bucketing is
monotone, that is *exactly* the bucket of
``np.percentile(samples, q, method="inverted_cdf")`` — the oracle
equality tests/test_obs.py asserts.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

SUB_BITS = 5
SUBS = 1 << SUB_BITS  # linear sub-buckets per octave
# values are clamped non-negative int64: octaves 1..(63-SUB_BITS+1)
N_BUCKETS = (65 - SUB_BITS) * SUBS


def bucket_index(v: int) -> int:
    """Bucket of a non-negative value (values < SUBS are exact)."""
    v = int(v)
    if v < 0:
        v = 0
    if v < SUBS:
        return v
    octave = v.bit_length() - SUB_BITS
    return octave * SUBS + ((v >> (octave - 1)) - SUBS)


def bucket_upper(idx: int) -> int:
    """Largest value that lands in bucket ``idx`` (the bucket's
    representative: percentiles never under-report)."""
    idx = int(idx)
    if idx < SUBS:
        return idx
    octave, sub = divmod(idx, SUBS)
    return ((SUBS + sub + 1) << (octave - 1)) - 1


class Histogram:
    """A mergeable log2 latency histogram (values in any one unit —
    the recorder uses nanoseconds)."""

    __slots__ = ("name", "counts", "n", "total")

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.counts = np.zeros(N_BUCKETS, np.int64)
        self.n = 0
        self.total = 0

    def record(self, v: int) -> None:
        self.counts[bucket_index(v)] += 1
        self.n += 1
        self.total += int(v)

    def record_many(self, values: Iterable[int]) -> None:
        vals = np.asarray(list(values) if not isinstance(values, np.ndarray)
                          else values).ravel()
        if vals.size == 0:
            return
        idx = np.fromiter((bucket_index(int(v)) for v in vals),
                          np.int64, vals.size)
        self.counts += np.bincount(idx, minlength=N_BUCKETS)
        self.n += int(vals.size)
        self.total += int(vals.sum())

    def record_batch(self, total: int, n: int) -> None:
        """Amortized recording for batched dispatches: ``n`` ops that
        together took ``total`` — each is booked at the mean cost (the
        honest per-op latency a batch driver can attribute)."""
        if n <= 0:
            return
        self.counts[bucket_index(int(total) // n)] += n
        self.n += n
        self.total += int(total)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q: float) -> int:
        """Nearest-rank percentile: the upper bound of the bucket
        holding the ⌈q·n/100⌉-th smallest recorded value.  The rank is
        computed with the same float operations numpy's
        ``inverted_cdf`` method uses (q/100 first, then ·n), so the
        oracle equality in tests/test_obs.py holds bit-for-bit."""
        if self.n == 0:
            return 0
        virtual = (q / 100.0) * self.n - 1.0
        prev = np.floor(virtual)
        idx0 = int(prev) + (1 if virtual - prev > 0 else 0)
        rank = min(max(idx0 + 1, 1), self.n)
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank, side="left"))
        return bucket_upper(idx)

    def percentiles(self, qs: Sequence[float]) -> list:
        return [self.percentile(q) for q in qs]

    def merge(self, other: "Histogram") -> "Histogram":
        self.counts += other.counts
        self.n += other.n
        self.total += other.total
        return self

    def summary(self, scale: float = 1.0) -> dict:
        """{count, mean, p50, p95, p99}, each value multiplied by
        ``scale`` (e.g. 1e-3 for ns -> us)."""
        return {"count": self.n,
                "mean": self.mean * scale,
                "p50": self.percentile(50) * scale,
                "p95": self.percentile(95) * scale,
                "p99": self.percentile(99) * scale}

    def __repr__(self) -> str:
        return (f"Histogram(name={self.name!r}, n={self.n}, "
                f"p50={self.percentile(50)}, p99={self.percentile(99)})")


__all__ = ["Histogram", "N_BUCKETS", "SUBS", "SUB_BITS", "bucket_index",
           "bucket_upper"]
