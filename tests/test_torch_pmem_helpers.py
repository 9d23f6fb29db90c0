"""``measure_op`` and ``count_stores`` on the port
(``repro_torch.core``) against the JAX package's, over P-CLHT inserts,
lookups and deletes on the same seed: each op's counters (stores,
loads, clwb, fence, lines_touched), its result and each store count
equal, and the paper's Table-4 shape that ``tests/test_clht.py`` checks
of the JAX package's (a common-case insert 2 clwb and 2 fences, a
lookup none, a delete one of each) holds in the port.  No tolerance:
every compared value is an integer."""

import dataclasses

import numpy as np
import pytest

from repro.core import PCLHT as JPCLHT, PMem as JPMem
from repro.core import measure_op as j_measure_op
from repro.core.pmem import count_stores as j_count_stores
from repro_torch.core import PCLHT as TPCLHT, PMem as TPMem
from repro_torch.core import count_stores as t_count_stores
from repro_torch.core import measure_op as t_measure_op

COUNTERS = ("stores", "loads", "clwb", "fence", "lines_touched")


def pair(seed, n_buckets, grow=True):
    jp, tp = JPMem(seed=seed), TPMem(seed=seed)
    return (jp, JPCLHT(jp, n_buckets=n_buckets, grow=grow),
            tp, TPCLHT(tp, n_buckets=n_buckets, grow=grow, device="cpu"))


def ops(seed, n):
    """Inserts of n keys, lookups of them and of absent keys, then
    deletes of half of them, in a seeded shuffle within each phase."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(np.arange(1, 1 << 20), size=n, replace=False)
    absent = rng.choice(np.arange(1 << 20, 1 << 21), size=n // 4,
                        replace=False)
    out = [("insert", int(k), int(k) * 7 + 1) for k in keys]
    look = [("lookup", int(k)) for k in np.concatenate([keys, absent])]
    rng.shuffle(look)
    out += look
    out += [("delete", int(k)) for k in rng.permutation(keys)[:n // 2]]
    out += [("lookup", int(k)) for k in keys[:n // 4]]
    return out


def call(ht, op):
    return lambda: getattr(ht, op[0])(*op[1:])


@pytest.mark.parametrize("seed,n_buckets,n", [(0, 1024, 200), (1, 2, 300),
                                              (7, 16, 500)])
def test_measure_op_counters_equal_the_jax_package(seed, n_buckets, n):
    jp, jh, tp, th = pair(seed, n_buckets)
    for op in ops(seed, n):
        jr, jc = j_measure_op(jp, call(jh, op))
        tr, tc = t_measure_op(tp, call(th, op))
        assert jr == tr, op
        assert {f: getattr(jc, f) for f in COUNTERS} == \
            {f: getattr(tc, f) for f in COUNTERS}, op
    assert dataclasses.asdict(jp.counters) == dataclasses.asdict(tp.counters)


@pytest.mark.parametrize("seed,n_buckets,n", [(0, 1024, 200), (3, 4, 300)])
def test_count_stores_equals_the_jax_package(seed, n_buckets, n):
    jp, jh, tp, th = pair(seed, n_buckets)
    for op in ops(seed, n):
        want = j_count_stores(jp, call(jh, op))
        assert t_count_stores(tp, call(th, op)) == want, op
        if op[0] == "lookup":
            assert want == 0
    assert dataclasses.asdict(jp.counters) == dataclasses.asdict(tp.counters)


def test_counters_match_paper_shape():
    """A common-case insert: 2 clwb + 2 fences (paper Table 4), a lookup
    none, a delete 1 + 1, in both packages."""
    jp, jh, tp, th = pair(0, 1024, grow=False)
    for pmem, ht, measure in ((jp, jh, j_measure_op), (tp, th, t_measure_op)):
        _, c = measure(pmem, lambda: ht.insert(12345, 99))
        assert (c.clwb, c.fence) == (2, 2)
        res, c = measure(pmem, lambda: ht.lookup(12345))
        assert res == 99 and (c.clwb, c.fence, c.stores) == (0, 0, 0)
        _, c = measure(pmem, lambda: ht.delete(12345))
        assert (c.clwb, c.fence) == (1, 1)
