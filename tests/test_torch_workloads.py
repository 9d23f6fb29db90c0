"""The port's workload layer (``repro_torch.data.workloads`` and
``repro_torch.core.ycsb``'s ``string_keyspace``, buffered engine and
``run_workload``) against the JAX package's, on the CPU, bit for bit:

* the samplers (``zipf_weights``, ``zipf_cdf``, ``zipf_ranks``,
  ``hotset_ranks``), ``string_keys``, ``encode_str``/``decode_str`` and
  ``string_keyspace`` on the same seeds;
* ``matrix_workload`` for every mix, distribution and keyspace: the
  same op lists, scan lengths, names and knobs;
* ``replay``: the same counts and model;
* ``run_workload`` on all eight index kinds, through plans and through
  the buffered engine: the same ``done`` dicts, PMem counters, probe
  statistics and final items as the JAX run, and the counts and items
  of ``replay``.

No tolerance: every compared value is an integer or a float computed by
the same numpy calls.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import PART as JPART
from repro.core import PBwTree as JPBwTree
from repro.core import PCLHT as JPCLHT
from repro.core import PHOT as JPHOT
from repro.core import PMasstree as JPMasstree
from repro.core import PMem as JPMem
from repro.core.baselines import CCEH as JCCEH
from repro.core.baselines import FastFair as JFastFair
from repro.core.baselines import LevelHashing as JLevelHashing
from repro.core.ycsb import WORKLOADS as JWORKLOADS
from repro.core.ycsb import run_workload as jax_run_workload
from repro.core.ycsb import string_keyspace as jax_string_keyspace
from repro.data import workloads as jwl
from repro_torch.core import PART, PBwTree, PCLHT, PHOT, PMasstree, PMem
from repro_torch.core.baselines import CCEH, FastFair, LevelHashing
from repro_torch.core.ycsb import WORKLOADS, run_workload, string_keyspace
from repro_torch.data import workloads as twl

CPU = torch.device("cpu")

# (JAX factory, port factory) per kind, as the JAX package's
# tests/test_workloads.py builds them (Level hashing added)
KINDS = {
    "FAST&FAIR": (lambda p: JFastFair(p, fixed=True),
                  lambda p: FastFair(p, fixed=True, device=CPU)),
    "P-BwTree": (JPBwTree, lambda p: PBwTree(p, device=CPU)),
    "P-Masstree": (JPMasstree, lambda p: PMasstree(p, device=CPU)),
    "P-ART": (JPART, lambda p: PART(p, device=CPU)),
    "P-HOT": (JPHOT, lambda p: PHOT(p, device=CPU)),
    "CCEH": (lambda p: JCCEH(p, depth=2, fixed=True),
             lambda p: CCEH(p, depth=2, fixed=True, device=CPU)),
    "P-CLHT": (lambda p: JPCLHT(p, n_buckets=64),
               lambda p: PCLHT(p, n_buckets=64, device=CPU)),
    "Level": (JLevelHashing, lambda p: LevelHashing(p, device=CPU)),
}
ORDERED = ("FAST&FAIR", "P-BwTree", "P-Masstree", "P-ART", "P-HOT")

# tests/test_workloads.py's matrix mixes
MIXES = [
    dict(mix="F", dist="zipfian", theta=1.2),
    dict(mix="A", dist="hotset", hot_frac=0.02, hot_op_frac=0.9),
    dict(mix="D", dist="zipfian", theta=0.9),
    dict(mix="A", dist="zipfian", theta=0.9, keyspace="string"),
]
SCAN_MIXES = [
    dict(mix="E", dist="zipfian", theta=0.9),
    dict(mix="E", dist="zipfian", theta=0.9, keyspace="string"),
]


def same_workload(t, j):
    assert (t.name, t.load_ops, t.run_ops, t.scan_lengths, t.meta) == \
        (j.name, j.load_ops, j.run_ops, j.scan_lengths, j.meta)


# -- generators -----------------------------------------------------------

@pytest.mark.parametrize("n_items,theta", [(1, 0.0), (7, 0.5), (1000, 0.99),
                                           (4096, 1.2), (300, 0.0)])
def test_zipf_sampler_matches_jax(n_items, theta):
    tw, jw = twl.zipf_weights(n_items, theta), jwl.zipf_weights(n_items,
                                                                theta)
    assert tw.dtype == jw.dtype and np.array_equal(tw, jw)
    assert np.array_equal(twl.zipf_cdf(n_items, theta),
                          jwl.zipf_cdf(n_items, theta))
    for seed in range(3):
        tr = twl.zipf_ranks(n_items, theta, 2000,
                            np.random.default_rng(seed))
        jr = jwl.zipf_ranks(n_items, theta, 2000,
                            np.random.default_rng(seed))
        assert tr.dtype == jr.dtype == np.int64 and np.array_equal(tr, jr)


@pytest.mark.parametrize("n_items,hot_frac,hot_op_frac", [
    (1000, 0.01, 0.9), (10, 0.5, 0.0), (10, 1.0, 0.5), (1, 0.01, 1.0),
    (2 ** 17, 0.01, 0.9)])
def test_hotset_sampler_matches_jax(n_items, hot_frac, hot_op_frac):
    for seed in range(3):
        tr = twl.hotset_ranks(n_items, hot_frac, hot_op_frac, 3000,
                              np.random.default_rng(seed))
        jr = jwl.hotset_ranks(n_items, hot_frac, hot_op_frac, 3000,
                              np.random.default_rng(seed))
        assert tr.dtype == jr.dtype == np.int64 and np.array_equal(tr, jr)


@pytest.mark.parametrize("n,n_prefixes,prefix_len,seed", [
    (1, 16, 3, 0), (500, 16, 3, 5), (2000, 4, 1, 1), (300, 64, 6, 2)])
def test_string_keys_and_codec_match_jax(n, n_prefixes, prefix_len, seed):
    tk = twl.string_keys(n, n_prefixes=n_prefixes, prefix_len=prefix_len,
                         seed=seed)
    jk = jwl.string_keys(n, n_prefixes=n_prefixes, prefix_len=prefix_len,
                         seed=seed)
    assert tk == jk
    for k in tk:
        assert twl.decode_str(k) == jwl.decode_str(k)
        assert twl.encode_str(twl.decode_str(k)) == k
    assert twl.MAX_STR_LEN == jwl.MAX_STR_LEN
    for s in ("a", "zz", "abcdefg", b"\x01\xff", "é"):
        assert twl.encode_str(s) == jwl.encode_str(s)
    for bad in ("", "abcdefgh", "a\0b"):
        with pytest.raises(ValueError):
            jwl.encode_str(bad)
        with pytest.raises(ValueError):
            twl.encode_str(bad)
    for bad in (0, -1, 1 << 59, 8, (5 << 3) | 0):
        with pytest.raises(ValueError):
            jwl.decode_str(bad)
        with pytest.raises(ValueError):
            twl.decode_str(bad)
    keys = np.random.default_rng(seed).integers(1, 1 << 62, size=n)
    assert string_keyspace(keys) == jax_string_keyspace(keys)


@pytest.mark.parametrize("keyspace", ["int", "string"])
@pytest.mark.parametrize("dist", ["uniform", "zipfian", "hotset"])
@pytest.mark.parametrize("mix", sorted(WORKLOADS))
def test_matrix_workload_matches_jax(mix, dist, keyspace):
    assert sorted(WORKLOADS) == sorted(JWORKLOADS)
    assert twl.DISTRIBUTIONS == jwl.DISTRIBUTIONS
    kw = dict(dist=dist, theta=0.99, hot_frac=0.02, hot_op_frac=0.8,
              keyspace=keyspace, seed=7, scan_max=40)
    same_workload(twl.matrix_workload(mix, 300, 400, **kw),
                  jwl.matrix_workload(mix, 300, 400, **kw))


def test_matrix_workload_rejects_the_same_knobs_as_jax():
    for kw in (dict(dist="pareto"), dict(keyspace="tuple")):
        for gen in (twl.matrix_workload, jwl.matrix_workload):
            with pytest.raises(ValueError):
                gen("A", 10, 10, **kw)


@pytest.mark.parametrize("knobs", MIXES + SCAN_MIXES + [
    dict(mix="E0", dist="hotset", keyspace="string"),
    dict(mix="LoadA", dist="uniform")], ids=lambda k: "-".join(
        str(v) for v in k.values()))
def test_replay_matches_jax(knobs):
    wl = twl.matrix_workload(n_load=400, n_run=600, seed=3, **knobs)
    tr = twl.replay(wl.load_ops, wl.run_ops)
    jr = jwl.replay(wl.load_ops, wl.run_ops)
    assert tr.counts() == jr.counts()
    assert tr.model == jr.model
    # a model carried in, and the load phase counting nothing
    base = {k: 1 for _, k, _ in wl.load_ops[:50]}
    assert twl.replay(wl.run_ops, model=base) == \
        twl.ReplayResult(**dataclasses.asdict(jwl.replay(wl.run_ops,
                                                         model=base)))
    assert twl.replay(wl.load_ops).counts() == (0, 0, 0)
    with pytest.raises(ValueError):
        twl.replay([], [("frobnicate", 1, 0)])


# -- run_workload on every kind -------------------------------------------

@pytest.mark.parametrize("buffered", [False, True], ids=["plans",
                                                         "buffered"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_run_workload_matches_jax(kind, buffered):
    """The JAX package's tests/test_workloads.py mixes at n_load = n_run
    = 250 in plans of 64: the port's ``done`` dicts, PMem counters,
    probe statistics and final items equal the JAX run's, and the counts
    and items equal ``replay``'s."""
    jf, tf = KINDS[kind]
    mixes = MIXES + (SCAN_MIXES if kind in ORDERED else [])
    for knobs in mixes:
        wl = twl.matrix_workload(n_load=250, n_run=250, seed=13, **knobs)
        jw = jwl.matrix_workload(n_load=250, n_run=250, seed=13, **knobs)
        same_workload(wl, jw)
        ji, ti = jf(JPMem()), tf(PMem())
        for phase in ("load", "run"):
            kw = dict(phase=phase, batch_lookups=True, buffered=buffered,
                      max_batch=64 if phase == "run" else 4096)
            jd = jax_run_workload(ji, jw, **kw)
            td = run_workload(ti, wl, **kw)
            assert td == jd, (kind, knobs, phase)
        assert dataclasses.asdict(ti.pmem.counters) == \
            dataclasses.asdict(ji.pmem.counters), (kind, knobs)
        assert getattr(ti, "probe_stats", None) == \
            getattr(ji, "probe_stats", None), (kind, knobs)
        items = list(ti.items())
        assert items == list(ji.items()), (kind, knobs)
        want = twl.replay(wl.load_ops, wl.run_ops)
        assert (td["found"], td["acked"], td["scanned"]) == want.counts()
        assert dict(items) == want.model
