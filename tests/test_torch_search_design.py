"""The sorted-run search kernel's design (``csrc/scan_window.cu``), on the
CPU: the 33-way warp search and the window copy, held to
``np.searchsorted`` and to the plain versions the kernel is compared
with on the card (``scan_window_plain``, ``scan_window_rows_plain``).

A warp searches a range of ``len`` entries in rounds: while ``len`` >
32, lane j reads the pivot ``lo + (j + 1) * len // 33``, and because the
run is sorted, the ballot of ``key < q`` is a prefix mask whose popcount
c keeps the entries between pivots c - 1 and c; the last <= 32 entries
are read one a lane and the popcount of their ballot is the lower bound.
``warp_lower_bound`` below follows the source lane by lane (ballot,
popcount, shuffles); ``ref.ways_lower_bound`` is the vectorized model
``chip_smoke.py`` counts rounds with.  Each sub-range holds at most
floor(len / 33) entries, so a query makes at most ceil(log33(len + 1))
rounds, against ceil(log2(len + 1)) for a binary search.

The constants (the warp width, the ways) are read from the source.
Keys and queries are drawn with numpy from a seed; nothing here has a
tolerance, every value is an integer.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import scan as kscan
from repro_torch.kernels.scan import ref as scan_ref

SRC = (pathlib.Path(kscan.kernel.__file__).parents[2] / "csrc"
       / "scan_window.cu").read_text()
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern
TOP = (1 << 63) - 1


def constant(name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", SRC)
    assert m, f"{name} is not defined in csrc/scan_window.cu"
    return m.group(1)


WARP = int(constant("kWarp"))


def ceil_log33(m: int) -> int:
    """The least r with 33^r >= m."""
    r = 0
    while 33 ** r < m:
        r += 1
    return r


def warp_lower_bound(keys: np.ndarray, q: int, lo: int, hi: int):
    """The source's lower_bound, one lane at a time: (lb, rounds)."""
    rounds = 0
    while hi - lo > WARP:
        p = [lo + (lane + 1) * (hi - lo) // (WARP + 1)
             for lane in range(WARP)]
        ballot = sum(1 << lane for lane in range(WARP)
                     if int(keys[p[lane]]) < q)
        # sorted keys: the ballot is a prefix mask
        assert ballot & (ballot + 1) == 0
        c = bin(ballot).count("1")
        below = p[c - 1 if c > 0 else 0]  # __shfl_sync(p, c - 1)
        above = p[c if c < WARP else 0]   # __shfl_sync(p, c)
        if c > 0:
            lo = below + 1
        if c < WARP:
            hi = above
        rounds += 1
    if hi > lo:
        ballot = sum(1 << lane for lane in range(WARP)
                     if lane < hi - lo and int(keys[lo + lane]) < q)
        lo += bin(ballot).count("1")
        rounds += 1
    return lo, rounds


def sorted_run(seed: int, n: int) -> np.ndarray:
    """n distinct keys, ascending, half of them negative."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(-(1 << 62), 1 << 62, size=n + n // 8 + 8))
    return np.sort(rng.choice(keys, n, replace=False)).astype(np.int64)


def starts_for(keys: np.ndarray, rng, n_q: int) -> np.ndarray:
    """Resident keys, keys between residents, below the first and past
    the last, key 0, -1 and keys of 2^63 and above."""
    q = rng.integers(HIGH, TOP, size=n_q)
    if keys.size:
        q[: n_q // 3] = rng.choice(keys, n_q // 3)
        q[n_q // 3: n_q // 2] = rng.choice(keys, n_q // 2 - n_q // 3) + 1
        q[-4:] = [keys[0] - 1, keys[0], keys[-1], keys[-1] + 1]
    q[:5] = [0, -1, HIGH, HIGH + 1, TOP]
    return q.astype(np.int64)


def test_source_constants():
    """One pivot a lane: a round splits into kWarp + 1 sub-ranges; below
    the source's bound a pivot's product (j + 1) * len fits 32 bits, so
    its 32-bit arithmetic gives the model's pivots."""
    assert WARP == 32
    assert constant("kWays") == "kWarp + 1"
    assert scan_ref.WAYS == WARP + 1
    m = re.search(r"len < \(1ll << (\d+)\)", SRC)
    assert m, "the 32-bit pivot bound is not in csrc/scan_window.cu"
    assert WARP * ((1 << int(m.group(1))) - 1) < 1 << 32


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 34, 1089, 1090, 1 << 18])
def test_warp_search_is_the_lower_bound(n):
    """The lane-by-lane search and the vectorized model both give
    np.searchsorted's lower bound in the same rounds, at most
    ceil(log33(n + 1)) of them."""
    keys = sorted_run(n, n)
    rng = np.random.default_rng(n + 1)
    q = starts_for(keys, rng, 96 if n > 4096 else 300)
    want = np.searchsorted(keys, q, side="left")
    lb, rounds = scan_ref.ways_lower_bound(keys, q)
    np.testing.assert_array_equal(lb, want)
    for i in range(q.size):
        assert warp_lower_bound(keys, int(q[i]), 0, n) == (lb[i], rounds[i])
    bound = ceil_log33(n + 1)
    assert rounds.max() <= bound
    if n >= 1089:  # past 33^2 - 1 entries some query needs the third
        assert rounds.max() == bound
    assert np.ceil(np.log2(n + 1)) >= rounds.max()


def test_round_count_is_log33_at_every_length():
    """Every length up to 3000 and past 33^2: the slowest query makes
    exactly ceil(log33(n + 1)) rounds when its start sits where the
    sub-ranges are widest."""
    rng = np.random.default_rng(5)
    for n in list(range(0, 70)) + [1087, 1088, 1089, 1090, 2999, 35936]:
        keys = np.arange(n, dtype=np.int64) * 2
        q = np.concatenate([np.arange(-1, 2 * n + 2), rng.integers(
            -4, 2 * n + 4, size=64)]).astype(np.int64)
        lb, rounds = scan_ref.ways_lower_bound(keys, q)
        np.testing.assert_array_equal(lb, np.searchsorted(keys, q))
        assert rounds.max() == ceil_log33(n + 1), n


@pytest.mark.parametrize("width", [1, 2, 33, 128])
@pytest.mark.parametrize("n", [0, 1, 32, 33, 1090, 1 << 18])
def test_window_from_the_search_equals_plain_version(n, width):
    """Windows built from the model's lower bound as the kernel builds
    them (valid = j < count and lb + j < n, key and value there, else 0)
    equal scan_window_plain's, counts of 0 included."""
    keys = sorted_run(n + 3, n)
    rng = np.random.default_rng(n + width)
    vals = rng.integers(1, 1 << 62, size=n)
    q = starts_for(keys, rng, 257)
    counts = rng.integers(0, width + 1, size=q.size).astype(np.int32)
    counts[::5] = 0
    lb, _ = scan_ref.ways_lower_bound(keys, q)
    j = np.arange(width)
    pos = lb[:, None] + j
    ok = (j < counts[:, None]) & (pos < n)
    safe = np.minimum(pos, max(n - 1, 0))
    okeys = np.where(ok, keys[safe] if n else 0, 0)
    ovals = np.where(ok, vals[safe] if n else 0, 0)
    plain = kscan.scan_window_plain(
        *(torch.from_numpy(a) for a in (q, counts, keys, vals)),
        max_count=width)
    for got, p in zip((ok, okeys, ovals), plain):
        np.testing.assert_array_equal(got, p.numpy())


@pytest.mark.parametrize("width", [1, 128])
def test_rows_search_and_window_equal_plain_version(width):
    """The shard axis: each row searches its own run of a stacked array
    (runs of 0, 1, 31, 32, 33, 1090 and 2^15 entries); the lower bound
    is np.searchsorted within the run, the rounds at most
    ceil(log33(len + 1)) for its own run, and the window stops at the
    run's end, as scan_window_rows_plain gives."""
    rng = np.random.default_rng(width + 17)
    runs = [sorted_run(10 + n, n) for n in (0, 1, 31, 32, 33, 1090,
                                            1 << 15)]
    offsets = np.concatenate([[0], np.cumsum([r.size for r in runs])])
    keys = np.concatenate(runs)
    vals = rng.integers(1, 1 << 62, size=keys.size)
    shard = rng.integers(0, len(runs), size=700)
    pools = [starts_for(run, rng, 64) for run in runs]
    q = np.array([rng.choice(pools[s]) for s in shard], np.int64)
    counts = rng.integers(0, 101, size=q.size).astype(np.int32)
    counts[::7] = 0
    base = offsets[:-1][shard]
    length = offsets[1:][shard] - base
    lb, rounds = scan_ref.ways_lower_bound(keys, q, base, length)
    for s, run in enumerate(runs):
        rows = shard == s
        np.testing.assert_array_equal(
            lb[rows] - offsets[s], np.searchsorted(run, q[rows]))
        if rows.any():
            assert rounds[rows].max() <= ceil_log33(run.size + 1)
    for i in range(0, q.size, 7):
        assert warp_lower_bound(keys, int(q[i]), int(base[i]),
                                int(base[i] + length[i])) == (lb[i],
                                                              rounds[i])
    j = np.arange(width)
    pos = lb[:, None] + j
    ok = (j < counts[:, None]) & (pos < (base + length)[:, None])
    safe = np.minimum(pos, keys.size - 1)
    plain = kscan.scan_window_rows_plain(
        *(torch.from_numpy(a) for a in (q, counts, base, length, keys,
                                        vals)), max_count=width)
    for got, p in zip((ok, np.where(ok, keys[safe], 0),
                       np.where(ok, vals[safe], 0)), plain):
        np.testing.assert_array_equal(got, p.numpy())


def test_search_rounds_at_the_masstree_run():
    """At P-Masstree's run length (2^18) every query makes 4 rounds,
    against a binary search's 19."""
    n = 1 << 18
    keys = sorted_run(1, n)
    q = starts_for(keys, np.random.default_rng(2), 4096)
    lb, rounds = scan_ref.ways_lower_bound(keys, q)
    np.testing.assert_array_equal(lb, np.searchsorted(keys, q))
    assert set(np.unique(rounds)) == {4}
    assert n.bit_length() == 19
