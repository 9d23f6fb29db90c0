"""The tag probe's design (``csrc/clht_probe.cu`` ``tag_probe``), on the
CPU: one thread a query walks its chain row by row and stops at the
first hit, with no window built.

``thread_walk`` below follows the kernel's thread: the 32-bit hash in
uint32 arithmetic, at most kChainDepth rows from the bucket, each row
read in one round (its kSlots keys and values and its next row), its
keys compared into a hit mask whose lowest bit is the first hit, and when no live row hits (the chain ended at a dead row, -1, or ran
past kChainDepth rows), found exactly when the query is 0, value 0: the
lanes of a dead row and the window's padding past kChainDepth * kSlots
lanes are key 0, value 0.  The constants are read from the source.  It
is held to the JAX package's ``tag_lookup`` (its gather and the Pallas
kernel in interpret mode), to ``tag_lookup_np`` and to the port's
``tag_lookup`` and ``tag_probe`` on the CPU (``tag_probe_plain``:
``tag_windows``, then ``probe_plain``), over tables with chains of 1 to
more than kChainDepth rows, dead rows, query 0 with and without a stored
tag 0, colliding tags, and next-row links that form cycles.

Tables and queries are drawn with numpy from a seed; every output is an
integer or a bool, so nothing has a tolerance.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.clht_probe import tag_lookup as jax_tag_lookup
from repro_torch.kernels import clht_probe as ktag
from repro_torch.kernels.clht_probe import ref as tag_ref

SRC = (pathlib.Path(ktag.kernel.__file__).parents[2] / "csrc"
       / "clht_probe.cu").read_text()
I32 = (-(1 << 31), 1 << 31)


def constant(name: str) -> int:
    m = re.search(rf"constexpr (?:int|unsigned) {name} = (\w+);", SRC)
    assert m, f"{name} is not defined in csrc/clht_probe.cu"
    return int(m.group(1).rstrip("u"), 0)


SLOTS = constant("kSlots")
DEPTH = constant("kChainDepth")
HASH_MUL = constant("kHashMul")


def thread_walk(q: int, keys: np.ndarray, vals: np.ndarray,
                nxt: np.ndarray, n_buckets: int):
    """One thread of tag_probe over the table: (found, value, rows
    read)."""
    z = (q & 0xFFFFFFFF) * HASH_MUL & 0xFFFFFFFF
    z ^= z >> 16
    row, read = z % n_buckets, 0
    for _ in range(DEPTH):
        if row < 0:
            break
        k, v, nx = keys[row], vals[row], int(nxt[row])  # one round
        read += 1
        mask = sum(1 << s for s in range(SLOTS) if int(k[s]) == q)
        if mask:
            hit = (mask & -mask).bit_length() - 1  # __ffs(mask) - 1
            return True, int(v[hit]), read
        row = nx
    return q == 0, 0, read


def walk_all(q, keys, vals, nxt, n_buckets):
    out = [thread_walk(int(x), keys, vals, nxt, n_buckets) for x in q]
    return (np.array([o[0] for o in out], bool),
            np.array([o[1] for o in out], np.int32),
            np.array([o[2] for o in out]))


def test_source_constants():
    """The source's chain depth, slots and hash are the reference's,
    and the window has padding past the chain (so a query of 0 that no
    live lane matches is found with value 0)."""
    assert (SLOTS, DEPTH, HASH_MUL) == (tag_ref.SLOTS, tag_ref.CHAIN_DEPTH,
                                        tag_ref.HASH_MUL)
    assert tag_ref.WINDOW > DEPTH * SLOTS


def chained_table(seed: int, n_buckets: int, n_keys: int, zero_tag: bool):
    """``tag_table_np`` of random tags (a quarter stored twice, under
    other values) and queries: stored tags, misses, query 0 and the
    int32 extremes.  With ``zero_tag`` the tag 0 is stored (value 77)."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(*I32, size=n_keys).astype(np.int32)
    tags[tags == 0] = 5
    tags[-(n_keys // 4):] = tags[:n_keys // 4]
    values = rng.integers(1, 1 << 31, size=n_keys).astype(np.int32)
    if zero_tag:
        tags[n_keys // 3], values[n_keys // 3] = 0, 77
    keys, vals, nxt = ktag.tag_table_np(tags, values, n_buckets)
    q = np.concatenate([tags[rng.integers(0, n_keys, size=200)],
                        rng.integers(*I32, size=48).astype(np.int32),
                        np.array([0, 0, I32[0], I32[1] - 1, -1, 1, 2, 3],
                                 np.int32)])
    return q.astype(np.int32), keys, vals, nxt, tags, values


def jax_and_numpy(q, keys, vals, nxt, n_buckets):
    jf, jv = jax_tag_lookup(*(jnp.asarray(a) for a in (q, keys, vals, nxt)),
                            n_buckets=n_buckets)
    nf, nv = ktag.tag_lookup_np(q, keys, vals, nxt, n_buckets)
    np.testing.assert_array_equal(np.asarray(jf), nf)
    np.testing.assert_array_equal(np.asarray(jv), nv)
    return nf, nv


@pytest.mark.parametrize("zero_tag", [False, True])
@pytest.mark.parametrize("n_buckets,n_keys", [(4096, 900), (512, 1200),
                                              (64, 700), (8, 256), (1, 40)])
def test_thread_walk_matches_jax_and_numpy(n_buckets, n_keys, zero_tag):
    """Chains of one row (sparse buckets) up to many more than
    kChainDepth rows (8 buckets of about 32 tags: 11 rows each; one
    bucket of 40 tags: a single chain of 14 rows)."""
    q, keys, vals, nxt, tags, values = chained_table(
        n_buckets + n_keys, n_buckets, n_keys, zero_tag)
    assert q.shape[0] % 256 == 0  # the Pallas kernel's tile
    nf, nv = jax_and_numpy(q, keys, vals, nxt, n_buckets)
    found, got, read = walk_all(q, keys, vals, nxt, n_buckets)
    np.testing.assert_array_equal(found, nf)
    np.testing.assert_array_equal(got, nv)
    tf, tv = ktag.tag_lookup(*(torch.from_numpy(a) for a in
                               (q, keys, vals, nxt)), n_buckets=n_buckets)
    np.testing.assert_array_equal(tf.numpy(), nf)
    np.testing.assert_array_equal(tv.numpy(), nv)
    zero = q == 0
    assert found[zero].all()
    if n_buckets >= 512:  # tag 0 sits in its chain's first rows
        assert (got[zero] == (77 if zero_tag else 0)).all()
    if n_buckets <= 8:  # every chain runs past kChainDepth rows
        assert int((nxt >= 0).sum()) > n_buckets * DEPTH
        assert read.max() == DEPTH and not found.all()
    if n_buckets == 4096:
        assert read.max() <= 2


def test_dead_rows_cycles_and_empty_slots():
    """A hand-made table: random next-row links (a third of them -1, so
    chains end after one to four rows, and one row that links to itself),
    a bucket row of empty slots, and key-0 lanes, one of them with a
    value: the walks read one, two and kChainDepth rows."""
    rng = np.random.default_rng(8)
    n_buckets, rows = 256, 400
    keys = rng.integers(1, 1 << 20, size=(rows, SLOTS)).astype(np.int32)
    vals = rng.integers(*I32, size=(rows, SLOTS)).astype(np.int32)
    nxt = rng.integers(-1, rows, size=rows).astype(np.int32)
    nxt[::3] = -1
    nxt[300] = 300                       # a row that links to itself
    keys[10] = 0                         # an empty bucket row
    keys[301, 1] = 0
    keys[302, 2] = 0
    vals[302, 2] = 99                    # tag 0 stored with a value
    q = np.concatenate([keys[rng.integers(0, rows, size=300)].ravel(),
                        rng.integers(*I32, size=50),
                        np.zeros(4), np.arange(1, 7)])[:1024]
    q = np.resize(q, 1024).astype(np.int32)
    nf, nv = jax_and_numpy(q, keys, vals, nxt, n_buckets)
    found, got, read = walk_all(q, keys, vals, nxt, n_buckets)
    np.testing.assert_array_equal(found, nf)
    np.testing.assert_array_equal(got, nv)
    tf, tv = ktag.tag_probe(*(torch.from_numpy(a) for a in
                              (q, keys, vals, nxt)), n_buckets=n_buckets)
    np.testing.assert_array_equal(tf.numpy(), nf)
    np.testing.assert_array_equal(tv.numpy(), nv)
    assert found[q == 0].all() and set(read.tolist()) >= {1, 2, DEPTH}


def test_wrapper_on_the_cpu_counts_no_launch_and_checks_its_inputs():
    q, keys, vals, nxt, _, _ = chained_table(3, 64, 300, True)
    args = [torch.from_numpy(a) for a in (q, keys, vals, nxt)]
    before = dict(ktag.LAUNCHES)
    found, got = ktag.tag_probe(*args, n_buckets=64)
    pf, pv = ktag.tag_probe_plain(*args, n_buckets=64)
    assert torch.equal(found, pf) and torch.equal(got, pv)
    assert found.dtype == torch.bool and got.dtype == torch.int32
    assert ktag.LAUNCHES == before
    with pytest.raises(ValueError, match="n_buckets"):
        ktag.tag_probe(*args, n_buckets=keys.shape[0] + 1)
    with pytest.raises(ValueError, match="n_buckets"):
        ktag.tag_probe(*args, n_buckets=0)
    with pytest.raises(TypeError, match="int32"):
        ktag.tag_probe(args[0], args[1].long(), args[2], args[3],
                       n_buckets=64)
    with pytest.raises(ValueError, match="nxt"):
        ktag.tag_probe(*args[:3], args[3][:-1], n_buckets=64)

