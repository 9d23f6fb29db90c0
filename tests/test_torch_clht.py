"""P-CLHT on the port (repro_torch.core.clht, device="cpu") against the
JAX package's P-CLHT, bit for bit: the same op stream gives the same
results, exports, PMem counters and probe_stats; a table carried over
with ``convert.pmem_from_arrays`` answers identically; powerfail with
adversarial eviction leaves identical images.  No tolerance: every
compared value is an integer."""

import dataclasses

import numpy as np
import pytest

from repro.core import PCLHT as JPCLHT, PMem as JPMem
from repro.core.pmem import CrashPoint as JCrashPoint
from repro_torch.convert import pmem_from_arrays
from repro_torch.core import PCLHT as TPCLHT, PMem as TPMem
from repro_torch.core.pmem import CrashPoint as TCrashPoint


def pair(seed=0, n_buckets=16):
    j = JPCLHT(JPMem(seed=seed), n_buckets=n_buckets)
    t = TPCLHT(TPMem(seed=seed), n_buckets=n_buckets, device="cpu")
    return j, t


def regions(pmem):
    return [{"rid": r.rid, "name": r.name, "cache": r.cache, "pm": r.pm,
             "stores": r.stores} for r in pmem.regions.values()]


def assert_same_pmem(jp, tp):
    assert dataclasses.asdict(jp.counters) == dataclasses.asdict(tp.counters)
    assert list(jp.regions) == list(tp.regions)
    for rid, jr in jp.regions.items():
        tr = tp.regions[rid]
        assert (jr.name, jr.n_words, jr.stores) == (tr.name, tr.n_words,
                                                    tr.stores)
        np.testing.assert_array_equal(jr.cache, tr.cache)
        np.testing.assert_array_equal(jr.pm, tr.pm)
        assert jr.dirty == tr.dirty and jr.pending == tr.pending


def assert_same_index(j, t):
    je, te = j.export_arrays(), t.export_arrays()
    assert je[3] == te[3]
    for a, b in zip(je[:3] + je[4:], te[:3] + te[4:]):
        np.testing.assert_array_equal(a, b)
    assert j.probe_stats == t.probe_stats
    assert j.shard_stats == t.shard_stats
    assert j._epoch_key() == t._epoch_key()
    assert_same_pmem(j.pmem, t.pmem)


def write_ops(rng, keys, n):
    """Mixed insert/update/delete ops over ``keys`` plus fresh keys."""
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            k = int(rng.integers(1, 1 << 62))
            ops.append(("insert", k, int(rng.integers(1, 1 << 62))))
        elif r < 0.8:
            ops.append(("update", int(rng.choice(keys)),
                        int(rng.integers(1 << 32, 1 << 62))))
        else:
            ops.append(("delete", int(rng.choice(keys)), 0))
    return ops


def both(j, t, fn):
    rj, rt = fn(j), fn(t)
    assert rj == rt
    return rj


def test_same_op_stream_same_exports_counters_and_probe_stats():
    rng = np.random.default_rng(1)
    j, t = pair()
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=600)]
    for k in keys[:300]:  # scalar inserts, through several rehashes
        both(j, t, lambda ix: ix.insert(k, k ^ (1 << 40)))
    assert_same_index(j, t)
    for _ in range(3):
        ops = write_ops(rng, keys[:300], 200)
        both(j, t, lambda ix: ix._write_batch(ops))
        assert_same_index(j, t)
        probes = keys[:400] + [0, 1, 2]  # misses and key 0 included
        for fps in (True, False):
            j.fingerprints = t.fingerprints = fps
            both(j, t, lambda ix: ix._lookup_batch(probes, force_kernel=True))
            assert_same_index(j, t)
        # stale snapshot: small batches take the scalar or refined path
        both(j, t, lambda ix: ix.delete(keys[5]))
        both(j, t, lambda ix: ix._lookup_batch(keys[:40]))
        assert_same_index(j, t)
    assert j.probe_stats["fp_false_positives"] > 0


def test_carried_over_table_answers_identically():
    rng = np.random.default_rng(2)
    src = JPCLHT(JPMem(seed=3), n_buckets=32)
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=500)]
    for k in keys:
        src.insert(k, k % 977 + (1 << 33))
    src._write_batch(write_ops(rng, keys, 150))
    jp = src.pmem
    tp = pmem_from_arrays(regions(jp), jp._next_rid,
                          counters=dataclasses.asdict(jp.counters), seed=3)
    # both packages re-attach to the same image through the restart path
    j = JPCLHT(jp, name="clht")
    t = TPCLHT(tp, name="clht", device="cpu")
    assert_same_pmem(jp, tp)
    # the lines-touched scratch set is per-op measurement state, not
    # part of the image: open a fresh op window on both
    jp.begin_op()
    tp.begin_op()
    probes = keys + [int(k) for k in rng.integers(1, 1 << 62, size=50)]
    assert [j.lookup(k) for k in probes] == [t.lookup(k) for k in probes]
    both(j, t, lambda ix: ix._lookup_batch(probes, force_kernel=True))
    ops = write_ops(rng, keys, 300)
    both(j, t, lambda ix: ix._write_batch(ops))
    both(j, t, lambda ix: ix._lookup_batch(probes))
    assert_same_index(j, t)
    with pytest.raises(ValueError):
        pmem_from_arrays(regions(jp), 1)


@pytest.mark.parametrize("group_commit", [True, False])
@pytest.mark.parametrize("after_stores", [3, 170, 400])
def test_powerfail_with_eviction_gives_identical_images(after_stores,
                                                        group_commit):
    rng = np.random.default_rng(4)
    j, t = pair(seed=11)
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=300)]
    for k in keys[:150]:
        both(j, t, lambda ix: ix.insert(k, k + 1))
    # a write wave, cut at a store count (inside a group-commit epoch,
    # many lines are dirty); the crash evicts a random half of the
    # dirty and pending lines to PM
    ops = write_ops(rng, keys[:150], 250)
    j.pmem.arm_crash(after_stores=after_stores)
    t.pmem.arm_crash(after_stores=after_stores)
    with pytest.raises(JCrashPoint):
        j._write_batch(ops, group_commit=group_commit)
    with pytest.raises(TCrashPoint):
        t._write_batch(ops, group_commit=group_commit)
    assert len(j.pmem.unpersisted_lines()) > 1 or not group_commit
    assert_same_pmem(j.pmem, t.pmem)
    j.pmem.crash(mode="powerfail", evict_probability=0.5)
    t.pmem.crash(mode="powerfail", evict_probability=0.5)
    j.recover()
    t.recover()
    assert_same_pmem(j.pmem, t.pmem)
    both(j, t, lambda ix: ix._lookup_batch(keys, force_kernel=True))
    both(j, t, lambda ix: [ix.lookup(k) for k in keys])
    assert_same_index(j, t)
