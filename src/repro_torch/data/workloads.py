"""Adversarial workload matrix — PiBench-style generators (paper-eval
hardening; see "Evaluating Persistent Memory Range Indexes: Part Two"
in PAPERS.md and docs/WORKLOADS.md).

Ported from ``repro.data.workloads``, whole: every sampler draws the
same numpy RNG streams in the same order, so a seed gives the
reference's op lists bit for bit, and ``replay`` is the same oracle.

Every YCSB mix in ``core.ycsb`` draws its targets uniformly, which is
the regime where batched engines look best.  This module produces the
distributions that stress them instead, as ``core.ycsb.Workload``
objects so the whole Plan/Session surface (PhaseExecutor, StreamDriver,
ShardedIndex) drives them unchanged:

* **Zipfian skew** — rank ``r`` (0-based, over the scrambled loaded
  keyspace) is drawn with probability proportional to ``(r+1)^-theta``.
  The sampler is a vectorized inverse-CDF (``np.cumsum`` of the weight
  vector + ``searchsorted``): ``np.cumsum`` accumulates sequentially,
  so a scalar float64 loop reproduces every partial sum exactly.
  ``theta=0`` degenerates to the uniform mix.
* **Hot-set contention** — a pinned fraction ``hot_frac`` of the
  keyspace receives ``hot_op_frac`` of all target draws.  Driven
  through ``StreamDriver``, cross-stream writes to the pinned set make
  the admission check defer plans — ``stats["deferred_plans"]`` is the
  contention metric the matrix reports.
* **Variable-length string keys** — 1..7-byte NUL-free strings packed
  into an order-preserving int64 (``encode_str``): the bytes sit
  big-endian in bits [58..3] and the length in bits [2..0], so integer
  order equals bytewise lexicographic order, every kernel (probe,
  scan lower-bound, conflict, partition) consumes them unchanged, and
  ``decode_str`` round-trips.  ``string_keys`` builds a shared-prefix
  clustered keyspace (a prefix pool + random suffixes) — the worst
  case for tries/B+ trees, which stop discriminating until the suffix
  bytes.  Encoded keys occupy < 2^59, so plain ``prefix`` shard
  routing (bits [62..]) would send *every* string key to shard 0;
  route them with ``hash`` or the ``prefix@58`` scheme instead.

``replay`` is the dict/sorted-dict oracle every index's counts and
final state are compared against.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.ycsb import (SCAN_MAX, WORKLOADS, Op, Workload, update_value,
                         value_of)

# ---------------------------------------------------------------------------
# Zipfian sampler (inverse CDF over explicit rank weights)
# ---------------------------------------------------------------------------


def zipf_weights(n_items: int, theta: float) -> np.ndarray:
    """Unnormalized Zipf(theta) rank weights: ``(r+1) ** -theta`` for
    rank r in [0, n_items).  ``theta=0`` gives the uniform vector."""
    assert n_items >= 1 and theta >= 0.0
    return np.arange(1, n_items + 1, dtype=np.float64) ** np.float64(-theta)


def zipf_cdf(n_items: int, theta: float) -> np.ndarray:
    """Sequential partial sums of the weight vector (``np.cumsum``
    accumulates left-to-right, so a scalar float64 loop over
    ``zipf_weights`` reproduces this array bit-exactly)."""
    return np.cumsum(zipf_weights(n_items, theta))


def zipf_ranks(n_items: int, theta: float, size: int,
               rng: np.random.Generator) -> np.ndarray:
    """``size`` Zipf(theta) ranks in [0, n_items) (int64): draw
    ``u = rng.random(size) * cdf[-1]`` and binary-search the CDF
    (``side='right'`` — rank r is chosen iff
    ``cdf[r-1] <= u < cdf[r]``, the bracket the oracle rejects on)."""
    cdf = zipf_cdf(n_items, theta)
    u = rng.random(size) * cdf[-1]
    ranks = np.searchsorted(cdf, u, side="right")
    # u == cdf[-1] is impossible up to rounding of the product; clamp so
    # a last-ulp round-up can never index past the keyspace
    return np.minimum(ranks, n_items - 1).astype(np.int64)


# ---------------------------------------------------------------------------
# hot-set sampler (pinned hot-key fraction)
# ---------------------------------------------------------------------------


def hotset_ranks(n_items: int, hot_frac: float, hot_op_frac: float,
                 size: int, rng: np.random.Generator) -> np.ndarray:
    """``size`` ranks in [0, n_items): the *pinned* hot set is ranks
    [0, n_hot) with ``n_hot = max(1, round(n_items * hot_frac))``, and
    each draw targets it with probability ``hot_op_frac``.  Exactly
    three vectorized draws in fixed order (coin, hot index, cold
    index) so an oracle consuming the same stream recombines them
    scalar-wise bit-exactly."""
    assert 0.0 < hot_frac <= 1.0 and 0.0 <= hot_op_frac <= 1.0
    n_hot = max(1, int(round(n_items * hot_frac)))
    n_cold = max(n_items - n_hot, 1)
    coin = rng.random(size)
    hot = rng.integers(0, n_hot, size=size)
    cold = rng.integers(0, n_cold, size=size)
    if n_hot >= n_items:
        return hot.astype(np.int64)
    return np.where(coin < hot_op_frac, hot, n_hot + cold).astype(np.int64)


# ---------------------------------------------------------------------------
# order-preserving string keys
# ---------------------------------------------------------------------------

MAX_STR_LEN = 7  # bytes; 7*8 = 56 payload bits + 3 length bits < 2^59
_STR_KEY_CEIL = 1 << 59


def encode_str(s: Union[str, bytes]) -> int:
    """Pack a 1..7-byte NUL-free string into an int64 key whose integer
    order equals bytewise lexicographic order: the bytes sit big-endian,
    left-aligned in bits [58..3]; the length lives in bits [2..0].
    Left-alignment zero-pads short strings low, and NUL-freedom makes
    the pad byte strictly smaller than any real byte — so a proper
    prefix sorts immediately before its extensions, and equal packed
    bits imply equal strings.  The result is positive and < 2^59:
    every kernel key path (probe/scan/conflict/partition) takes it
    unchanged."""
    b = s.encode("utf-8") if isinstance(s, str) else bytes(s)
    if not 1 <= len(b) <= MAX_STR_LEN:
        raise ValueError(f"string key must be 1..{MAX_STR_LEN} bytes, "
                         f"got {len(b)}")
    if 0 in b:
        raise ValueError("string keys must be NUL-free (NUL is the pad)")
    packed = int.from_bytes(b.ljust(MAX_STR_LEN, b"\0"), "big")
    return (packed << 3) | len(b)


def decode_str(key: int) -> bytes:
    """Inverse of ``encode_str`` (returns the raw bytes)."""
    key = int(key)
    if not 0 < key < _STR_KEY_CEIL:
        raise ValueError(f"not an encoded string key: {key}")
    length = key & 0b111
    if not 1 <= length <= MAX_STR_LEN:
        raise ValueError(f"bad length field {length} in key {key}")
    return (key >> 3).to_bytes(MAX_STR_LEN, "big")[:length]


_ALPHA = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def string_keys(n: int, *, n_prefixes: int = 16, prefix_len: int = 3,
                seed: int = 0) -> List[int]:
    """``n`` unique encoded string keys with shared-prefix clustering:
    a pool of ``n_prefixes`` random lowercase prefixes of
    ``prefix_len`` bytes, each key a pool prefix + a random lowercase
    suffix filling out to ``MAX_STR_LEN`` bytes.  Clustered prefixes
    are the adversarial case for byte-discriminating indexes (ART/HOT
    descend ``prefix_len`` levels before telling keys apart; B+-tree
    separators crowd)."""
    assert 1 <= prefix_len < MAX_STR_LEN
    rng = np.random.default_rng(seed)
    prefixes = {
        bytes(_ALPHA[rng.integers(0, 26, size=prefix_len)])
        for _ in range(n_prefixes)}
    prefixes = sorted(prefixes)
    suffix_len = MAX_STR_LEN - prefix_len
    out: Dict[int, bytes] = {}
    while len(out) < n:
        p = prefixes[int(rng.integers(0, len(prefixes)))]
        s = bytes(_ALPHA[rng.integers(0, 26, size=suffix_len)])
        k = encode_str(p + s)
        out.setdefault(k, p + s)
    return list(out)[:n]


# ---------------------------------------------------------------------------
# matrix mix schedules (core.ycsb.Workload objects)
# ---------------------------------------------------------------------------

DISTRIBUTIONS = ("uniform", "zipfian", "hotset")


def matrix_workload(mix: str, n_load: int, n_run: int, *,
                    dist: str = "uniform", theta: float = 0.9,
                    hot_frac: float = 0.01, hot_op_frac: float = 0.9,
                    keyspace: str = "int", seed: int = 0,
                    scan_max: int = SCAN_MAX) -> Workload:
    """An adversarial variant of ``core.ycsb.generate``: the same mix
    vocabulary (A/B/C/D/E/E0/F — reads/inserts/updates/scans and D's
    read-latest window), but every *target* draw (reads, updates,
    scan start keys, D's window offset) comes from ``dist``:

    * ``uniform`` — the baseline (matches classic YCSB in law, not
      bit-for-bit with ``generate``);
    * ``zipfian`` — ``zipf_ranks(theta)`` over a scrambled permutation
      of the loaded keyspace (rank 0 = the hottest key);
    * ``hotset`` — ``hotset_ranks(hot_frac, hot_op_frac)``, the pinned
      contention workload.

    ``keyspace='string'`` loads shared-prefix clustered string keys
    (``string_keys``) and feeds inserts from the same clustered pool,
    so the run phase keeps stressing prefix discrimination; the
    default ``'int'`` keyspace matches ``generate``'s ranges (loads in
    [1, 2^60), fresh inserts in [2^60, 2^61)).  Fixed ``seed`` makes
    the whole schedule deterministic.  The workload's knobs are kept
    on ``Workload.meta`` for benchmark row labeling."""
    mix_spec = WORKLOADS[mix]
    if dist not in DISTRIBUTIONS:
        raise ValueError(f"unknown distribution {dist!r}; "
                         f"choose from {DISTRIBUTIONS}")
    rng = np.random.default_rng(seed)
    if keyspace == "string":
        pool = string_keys(n_load + n_run, seed=seed)
        load_keys = np.asarray(pool[:n_load], np.int64)
        rng.shuffle(load_keys)
        fresh_pool = iter(pool[n_load:])
    elif keyspace == "int":
        load_keys = np.unique(rng.integers(1, 1 << 60, size=n_load))
        rng.shuffle(load_keys)
        fresh_pool = iter(np.unique(
            rng.integers(1 << 60, 1 << 61, size=max(n_run, 1))))
    else:
        raise ValueError(f"unknown keyspace {keyspace!r}")
    load_ops: List[Op] = [("insert", int(k), value_of(int(k)))
                          for k in load_keys]
    n_items = len(load_keys)
    # rank r of the distribution targets scrambled[r]: the hot ranks
    # land on an arbitrary (but deterministic) subset of the keyspace
    scrambled = load_keys[rng.permutation(n_items)]
    reads = mix_spec.get("reads", 0.0)
    inserts = mix_spec.get("inserts", 0.0)
    updates = mix_spec.get("updates", 0.0)
    latest = bool(mix_spec.get("latest", False))
    r = rng.random(n_run)
    if dist == "zipfian":
        ranks = zipf_ranks(n_items, theta, n_run, rng)
    elif dist == "hotset":
        ranks = hotset_ranks(n_items, hot_frac, hot_op_frac, n_run, rng)
    else:
        ranks = rng.integers(0, n_items, size=n_run).astype(np.int64)
    scan_counts = rng.integers(1, scan_max + 1, size=n_run)
    run_ops: List[Op] = []
    scan_lengths: List[int] = []
    recent: List[int] = [int(k) for k in load_keys]
    for i in range(n_run):
        rank = int(ranks[i])
        if r[i] < reads:
            if latest:
                window = max(1, len(recent) // 10)
                k = recent[len(recent) - 1 - (rank % window)]
            else:
                k = int(scrambled[rank])
            run_ops.append(("lookup", k, 0))
        elif r[i] < reads + inserts:
            k = int(next(fresh_pool))
            run_ops.append(("insert", k, value_of(k)))
            recent.append(k)
        elif r[i] < reads + inserts + updates:
            k = int(scrambled[rank])
            run_ops.append(("update", k, update_value(k, i)))
        else:
            k = int(scrambled[rank])
            n = int(scan_counts[i])
            run_ops.append(("scan", k, n))
            scan_lengths.append(n)
    wl = Workload(name=f"{mix}:{dist}", load_ops=load_ops,
                  run_ops=run_ops, scan_lengths=scan_lengths)
    wl.meta.update(mix=mix, dist=dist, theta=theta, hot_frac=hot_frac,
                   hot_op_frac=hot_op_frac, keyspace=keyspace, seed=seed)
    return wl


# ---------------------------------------------------------------------------
# dict / sorted-dict replay oracle
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ReplayResult:
    found: int = 0
    acked: int = 0
    scanned: int = 0
    model: Dict[int, int] = dataclasses.field(default_factory=dict)

    def counts(self) -> Tuple[int, int, int]:
        return self.found, self.acked, self.scanned


def replay(load_ops: Sequence[Op], run_ops: Sequence[Op] = (),
           model: Optional[Dict[int, int]] = None) -> ReplayResult:
    """Sequential dict/sorted-dict oracle for a matrix op stream, with
    the index semantics the plan contract guarantees: insert is
    set-if-absent (acked iff it inserted), update is set-else-insert
    (always acked), delete is acked iff the key was live, scan returns
    the first ``aux`` live entries with key >= start in sorted order.
    Plan execution preserves per-key program order and scan/write
    ordering, so its found/acked/scanned counts — on ANY plan-surface
    index, batched or scalar, sharded or not — must equal this
    replay's (asserted per index by the tests and on every matrix
    phase of ``chip_smoke.py``)."""
    res = ReplayResult(model={} if model is None else dict(model))
    m = res.model
    for kind, key, aux in load_ops:
        _apply_one(res, m, kind, key, aux, count=False)
    for kind, key, aux in run_ops:
        _apply_one(res, m, kind, key, aux, count=True)
    return res


def _apply_one(res: ReplayResult, m: Dict[int, int], kind: str, key: int,
               aux: int, *, count: bool) -> None:
    if kind == "lookup":
        if count and key in m:
            res.found += 1
    elif kind == "insert":
        if key not in m:
            m[key] = aux
            if count:
                res.acked += 1
    elif kind == "update":
        m[key] = aux
        if count:
            res.acked += 1
    elif kind == "delete":
        if key in m:
            del m[key]
            if count:
                res.acked += 1
    elif kind == "scan":
        if count:
            res.scanned += len(
                [k for k in sorted(k for k in m if k >= key)[:aux]])
    else:
        raise ValueError(f"unknown op kind {kind!r}")


__all__ = ["DISTRIBUTIONS", "MAX_STR_LEN", "ReplayResult", "decode_str",
           "encode_str", "hotset_ranks", "matrix_workload", "replay",
           "string_keys", "zipf_cdf", "zipf_ranks", "zipf_weights"]
