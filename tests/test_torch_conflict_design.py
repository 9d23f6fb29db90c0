"""The conflict-admission kernel's design (``csrc/conflict_any.cu``), on
the CPU: the set-and-scalar decomposition and the hash table it is built
on, held to the numpy oracle ``conflict_any_ref``, the plain version
``conflict_any_plain`` and the JAX package's Pallas kernel in interpret
mode.

Reduced over the reference set B, with W = PUT | UPDATE | DELETE, a
candidate conflicts iff: a GET, its key is among B's write keys; a W,
its key is among B's GET keys, or B has a SCAN and its key is >= B's
least SCAN key (signed order), or with ``writes_conflict`` its key is
among B's write keys; a SCAN, B has a write and its key is <= B's
greatest write key; any other kind, never.  ``Table`` below follows the
source: 2^lg slots in buckets of 8, the home bucket the top lg - 3 bits
of key * phi (mod 2^64); each GET or write of B, duplicates too, takes
the slot its bucket's count gives it (atomicAdd), or goes on to the next
bucket when that count is 8 or more; a lookup reads a bucket a round,
ORs the classes of the filled slots that hold its key, and goes on while
the count is above 8.  The scalars are unsigned words in signed order
with a "has" bit each, so no key value stands for "none", and no key
value marks an empty slot either: key 0 is a key like any other.

The constants (the load rule, the bucket, the least table, the hash
multiplier, the class bits) are read from the source.
Keys come from small pools so that they repeat, with 0, -1, 2^63
(INT64_MIN, negative as int64) and 2^63 - 1 among them.  No tolerance:
every output is a boolean.
"""

import math
import pathlib
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.conflict import conflict_any as jax_conflict_any
from repro_torch.kernels import conflict as tconf

SRC = (pathlib.Path(tconf.kernel.__file__).parents[2] / "csrc"
       / "conflict_any.cu").read_text()
HIGH = -(1 << 63)
TOP = (1 << 63) - 1
EDGES = [0, -1, HIGH, TOP, 1]
M64 = (1 << 64) - 1
SIGN = 1 << 63
GET, PUT, UPDATE, DELETE, SCAN = 0, 1, 2, 3, 4


def constant(name: str) -> int:
    m = re.search(rf"constexpr (?:int|unsigned|unsigned long long) "
                  rf"(?:[^;]*?\b){name} = ([0-9xA-Fa-f]+)u?l?l?[,;]", SRC)
    assert m, f"{name} is not defined in csrc/conflict_any.cu"
    return int(m.group(1), 0)


LOAD = constant("kLoadNum"), constant("kLoadDen")
BUCKET_LOG = constant("kBucketLog")
BUCKET = 1 << BUCKET_LOG
MIN_LOG = constant("kMinLog")
PHI = constant("kPhi")
WRITE_BIT, GET_BIT = constant("kWriteBit"), constant("kGetBit")
HAS_SCAN, HAS_WRITE = constant("kHasScan"), constant("kHasWrite")
SCAN_CLASS = constant("kScanClass")


def log_slots_for(n_b: int) -> int:
    """The source's table size: the least power of two >= n_b * 8 / 3,
    and at least 2^kMinLog."""
    num, den = LOAD
    want = -(-n_b * den // num)
    lg = MIN_LOG
    while (1 << lg) < want:
        lg += 1
    return lg


def op_class(kind: int) -> int:
    """The source's class of an op: its flag bit, the SCAN class, or 0
    for a kind that conflicts with nothing."""
    return (WRITE_BIT if kind in (PUT, UPDATE, DELETE) else GET_BIT
            if kind == GET else SCAN_CLASS if kind == SCAN else 0)


class Table:
    """The kernel's table and scalars; counts the buckets each lookup
    reads and the lookups each candidate makes."""

    def __init__(self, lg: int):
        self.lg = lg
        self.counts = [0] * (1 << (lg - BUCKET_LOG))
        self.keys = [None] * (1 << lg)  # never read where not filled
        self.cls = [None] * (1 << lg)
        self.meta = 0
        self.max_w = 0
        self.max_ns = 0
        self.wrapped = 0
        self.lookups = 0
        self.rounds = 0

    def home(self, k: int) -> int:
        return ((k * PHI) & M64) >> (64 - (self.lg - BUCKET_LOG))

    def next_bucket(self, b: int) -> int:
        nxt = (b + 1) & ((1 << (self.lg - BUCKET_LOG)) - 1)
        self.wrapped += nxt == 0
        return nxt

    def insert(self, kind: int, key: int) -> None:
        k = key & M64
        ordk = k ^ SIGN
        c = op_class(kind)
        if c == SCAN_CLASS:
            self.meta |= HAS_SCAN
            self.max_ns = max(self.max_ns, ~ordk & M64)
            return
        if not c:
            return
        if c == WRITE_BIT:
            self.meta |= HAS_WRITE
            self.max_w = max(self.max_w, ordk)
        b = self.home(k)
        while True:  # atomicAdd(&counts[b], 1)
            at = self.counts[b]
            self.counts[b] += 1
            if at < BUCKET:
                break
            b = self.next_bucket(b)
        self.keys[b * BUCKET + at] = k
        self.cls[b * BUCKET + at] = c

    def lookup(self, key: int) -> int:
        self.lookups += 1
        k = key & M64
        b = self.home(k)
        found = 0
        for _ in range(1 << (self.lg - BUCKET_LOG)):
            self.rounds += 1
            n = self.counts[b]
            for j in range(min(n, BUCKET)):
                if self.keys[b * BUCKET + j] == k:
                    found |= self.cls[b * BUCKET + j]
            if n <= BUCKET:
                return found
            b = self.next_bucket(b)
        raise AssertionError("the table is full: a probe did not end")

    def conflicts(self, kind: int, key: int, writes_conflict: bool) -> bool:
        ordk = (key & M64) ^ SIGN
        c = op_class(kind)
        if c == GET_BIT:
            return bool(self.lookup(key) & WRITE_BIT)
        if c == SCAN_CLASS:
            return bool(self.meta & HAS_WRITE) and ordk <= self.max_w
        if c != WRITE_BIT:
            return False
        if self.meta & HAS_SCAN and ordk >= (~self.max_ns & M64):
            return True
        f = self.lookup(key)
        return bool(f & GET_BIT) or (writes_conflict and bool(f & WRITE_BIT))


def model(ka, xa, kb, xb, writes_conflict, lg=None, order=None):
    """conflict_any by the kernel's design: B into a table (in ``order``,
    as any interleaving of the atomics may enter it), then one decision
    a candidate.  Returns (out [A] bool, the table)."""
    t = Table(log_slots_for(len(kb)) if lg is None else lg)
    for j in (range(len(kb)) if order is None else order):
        t.insert(int(kb[j]), int(xb[j]))
    out = np.zeros(len(ka), bool)
    for i in range(len(ka)):
        before = t.lookups
        out[i] = t.conflicts(int(ka[i]), int(xa[i]), writes_conflict)
        assert t.lookups - before <= 1  # one lookup at most, whatever B
    return out, t


def references(ka, xa, kb, xb, writes_conflict):
    """The numpy oracle and the plain version, which agree."""
    ref = tconf.conflict_any_ref(ka, xa, kb, xb,
                                 writes_conflict=writes_conflict)
    plain = tconf.conflict_any_plain(
        *(torch.from_numpy(np.asarray(a, dt)) for a, dt in (
            (ka, np.int32), (xa, np.int64), (kb, np.int32), (xb, np.int64))),
        writes_conflict=writes_conflict).numpy()
    np.testing.assert_array_equal(ref, plain)
    return ref


def op_sets(seed, n_a, n_b, kinds_b=(0, 1, 2, 3, 4, 5)):
    rng = np.random.default_rng(seed)
    pool = np.concatenate([EDGES, rng.integers(HIGH, TOP, size=max(
        8, n_b // 3))]).astype(np.int64)
    ka = rng.integers(0, 6, size=n_a).astype(np.int32)
    kb = rng.choice(np.array(kinds_b, np.int32), size=n_b)
    return ka, rng.choice(pool, n_a), kb, rng.choice(pool, n_b)


def test_source_constants():
    """Load 0.375 at most, buckets of 8 slots, at least 4 buckets, and
    three class codes distinct from the header's two flags."""
    assert LOAD == (3, 8)
    assert BUCKET == 8 and MIN_LOG == 5
    assert PHI == 0x9E3779B97F4A7C15
    assert len({WRITE_BIT, GET_BIT, HAS_SCAN, HAS_WRITE}) == 4
    assert SCAN_CLASS == WRITE_BIT | GET_BIT


@pytest.mark.parametrize("n_b", [1, 2, 7, 31, 32, 33, 4096, 12288, 65536,
                                 65537, 100000])
def test_table_size_rule(n_b):
    lg = log_slots_for(n_b)
    num, den = LOAD
    assert n_b <= (1 << lg) * num / den
    assert lg == MIN_LOG or n_b > (1 << (lg - 1)) * num / den


@settings(max_examples=300, deadline=None)
@given(st.integers(0, 2 ** 32 - 1), st.integers(0, 40), st.integers(0, 40),
       st.booleans(), st.integers(1, 12))
def test_model_matches_oracle_on_small_pools(seed, n_a, n_b, wc, pool):
    """Kinds 0-5, keys from a pool of ``pool`` keys that starts with 0,
    -1, INT64_MIN, INT64_MAX and 1: keys repeat within and across the
    two sets, and a key is a GET and a write of B at once."""
    rng = np.random.default_rng(seed)
    keys = np.concatenate([EDGES, rng.integers(HIGH, TOP, size=8)])[:pool]
    ka = rng.integers(0, 6, size=n_a).astype(np.int32)
    kb = rng.integers(0, 6, size=n_b).astype(np.int32)
    xa, xb = rng.choice(keys, n_a), rng.choice(keys, n_b)
    got, _ = model(ka, xa, kb, xb, wc)
    np.testing.assert_array_equal(got, references(ka, xa, kb, xb, wc))
    shuffled, _ = model(ka, xa, kb, xb, wc, order=rng.permutation(n_b))
    np.testing.assert_array_equal(shuffled, got)


@pytest.mark.parametrize("writes_conflict", [False, True])
@pytest.mark.parametrize("case", ["mixed", "no-scan", "no-write", "gets-only",
                                  "scans-only", "edges", "duplicates"])
def test_model_matches_jax_kernel(case, writes_conflict):
    """The model against the Pallas kernel in interpret mode and the
    oracle, on sets with no SCAN, with no write, with only GETs, with
    only SCANs, of the edge keys alone, and of one key many times."""
    kinds_b = {"no-scan": (0, 1, 2, 3, 5), "no-write": (0, 4, 5),
               "gets-only": (0,), "scans-only": (4,)}.get(
                   case, (0, 1, 2, 3, 4, 5))
    ka, xa, kb, xb = op_sets(len(case) * 31 + writes_conflict, 160, 96,
                             kinds_b)
    if case == "edges":
        xa = np.resize(np.array(EDGES, np.int64), xa.size)
        xb = np.resize(np.array(EDGES, np.int64), xb.size)
    if case == "duplicates":
        xb[:] = xa[3]
    got, _ = model(ka, xa, kb, xb, writes_conflict)
    want = references(ka, xa, kb, xb, writes_conflict)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_conflict_any(
        ka, xa, kb, xb, writes_conflict=writes_conflict, use_kernel=True,
        interpret=True))
    t = model(ka, xa, kb, xb, writes_conflict)[1]
    if case in ("no-scan", "gets-only"):
        # no SCAN: the flag is clear, no write candidate conflicts by
        # window
        assert not t.meta & HAS_SCAN
    if case in ("no-write", "gets-only"):
        # no write: no SCAN or GET candidate conflicts
        assert not t.meta & HAS_WRITE
        assert not got[(ka == SCAN) | (ka == GET)].any()


def test_scalar_identities_are_flags_not_keys():
    """A SCAN candidate at INT64_MAX conflicts with no empty write set,
    and a write at INT64_MAX with no empty SCAN set, although INT64_MAX
    is >= every key and an identity word would compare as a key; and a
    write or SCAN key of INT64_MIN still counts."""
    ka = np.array([SCAN, PUT, SCAN, PUT], np.int32)
    xa = np.array([TOP, TOP, HIGH, HIGH], np.int64)
    for kb, xb in ((np.array([GET], np.int32), np.array([TOP], np.int64)),
                   (np.array([PUT, SCAN], np.int32),
                    np.array([HIGH, HIGH], np.int64)),
                   (np.array([DELETE, SCAN], np.int32),
                    np.array([TOP, TOP], np.int64))):
        for wc in (False, True):
            got, _ = model(ka, xa, kb, xb, wc)
            np.testing.assert_array_equal(got, references(ka, xa, kb, xb,
                                                          wc))


@pytest.mark.parametrize("writes_conflict", [False, True])
def test_tiny_table_overflows_and_wraps(writes_conflict):
    """A table of 4 buckets (32 slots) holding 28 GETs and writes over 10
    keys, key 0 among them: duplicates take slots of their own, buckets
    overflow into the next and past the last, a lookup ORs the classes
    of every slot its key holds, and the answers stand."""
    rng = np.random.default_rng(3)
    wraps = overflows = 0
    for trial in range(60):
        keys = np.concatenate([[0], rng.integers(HIGH, TOP, size=9)])
        kb = rng.integers(0, 4, size=28).astype(np.int32)
        xb = rng.choice(keys, 28)
        ka = rng.integers(0, 6, size=80).astype(np.int32)
        xa = np.concatenate([rng.choice(keys, 60),
                             rng.integers(HIGH, TOP, size=20)])
        got, t = model(ka, xa, kb, xb, writes_conflict, lg=MIN_LOG)
        wraps += t.wrapped
        overflows += max(t.counts) > BUCKET
        np.testing.assert_array_equal(got, references(ka, xa, kb, xb,
                                                      writes_conflict))
    assert wraps > 0 and overflows > 0


@pytest.mark.parametrize("n_b", [12288, 65536])
def test_model_at_the_path_sizes(n_b):
    """The stream phase's reference sets: 4096 candidates against 12288
    and 65536 ops, keys mostly fresh, as the StreamDriver's writes are;
    probes stay short."""
    rng = np.random.default_rng(n_b)
    xb = rng.integers(1 << 61, 1 << 62, size=n_b)
    xb[: n_b // 4] = xb[n_b // 4: n_b // 2]  # plans overlapping by half
    kb = rng.choice(np.array([GET, PUT, UPDATE, SCAN], np.int32), n_b,
                    p=[0.5, 0.3, 0.199, 0.001])
    xa = np.concatenate([rng.choice(xb, 512), rng.integers(
        1 << 61, 1 << 62, size=3584)])
    ka = rng.choice(np.array([GET, PUT, UPDATE, SCAN], np.int32), 4096)
    got, t = model(ka, xa, kb, xb, True)
    np.testing.assert_array_equal(got, references(ka, xa, kb, xb, True))
    used = sum(min(n, BUCKET) for n in t.counts)
    num, den = LOAD
    assert used / len(t.keys) <= num / den
    # a lookup reads its home bucket, and on where buckets overflowed
    assert t.rounds / t.lookups < 1.5
    assert t.lg == log_slots_for(n_b) and math.log2(len(t.keys)) == t.lg
