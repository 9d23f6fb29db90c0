"""The port's per-store crash sweep (``run_crash_sweep``) and durability
audit (``audit_durability``) against the JAX package's, on the CPU
(``device="cpu"``), on the indexes and workloads of the JAX package's
own tests (tests/test_indexes_common.py and tests/test_baselines.py):

* with ``post_threads=1`` every ``CrashReport`` is equal field for
  field, failure lists included, for the five converted indexes in
  powerfail and interrupt mode, FAST&FAIR and CCEH in fixed mode, and
  buggy FAST&FAIR (``fixed=False``), whose report fails on both sides;
* with ``post_threads=4`` the reports are ``ok``;
* ``audit_durability`` gives the same (empty) lists on all eight kinds,
  and the same non-empty lists when ``clwb`` is made a no-op on both
  sides.

No tolerance: every compared value is an integer or a string.
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
from repro.core import audit_durability as jax_audit_durability
from repro.core import run_crash_sweep as jax_run_crash_sweep
from repro.core.baselines import CCEH as JCCEH
from repro.core.baselines import FastFair as JFastFair
from repro.core.baselines import LevelHashing as JLevelHashing
from repro_torch.core import (PART, PBwTree, PCLHT, PHOT, PMasstree, PMem,
                              audit_durability, run_crash_sweep)
from repro_torch.core.baselines import CCEH, FastFair, LevelHashing

CPU = torch.device("cpu")

# (JAX factory, port factory): tests/test_indexes_common.py's FACTORIES
# and tests/test_baselines.py's fixed-mode factories
CONVERTED = {
    "P-CLHT": (lambda p: JPCLHT(p, n_buckets=8),
               lambda p: PCLHT(p, n_buckets=8, device=CPU)),
    "P-HOT": (JPHOT, lambda p: PHOT(p, device=CPU)),
    "P-BwTree": (JPBwTree, lambda p: PBwTree(p, device=CPU)),
    "P-ART": (JPART, lambda p: PART(p, device=CPU)),
    "P-Masstree": (JPMasstree, lambda p: PMasstree(p, device=CPU)),
}
BASELINES = {
    "fastfair": (lambda p: JFastFair(p, fixed=True),
                 lambda p: FastFair(p, fixed=True, device=CPU)),
    "cceh": (lambda p: JCCEH(p, fixed=True),
             lambda p: CCEH(p, fixed=True, device=CPU)),
    "cceh-depth1": (lambda p: JCCEH(p, depth=1, fixed=True),
                    lambda p: CCEH(p, depth=1, fixed=True, device=CPU)),
    "level": (JLevelHashing, lambda p: LevelHashing(p, device=CPU)),
}
ALL = {**CONVERTED, **BASELINES}


def keys_for(seed, n):
    rng = np.random.default_rng(seed)
    return [int(k) for k in np.unique(rng.integers(1, 1 << 60, size=n))]


def powerfail_ops():
    """tests/test_indexes_common.py::test_crash_sweep's workload:
    sequential keys force tree/leaf splits, random ones hash."""
    keys = keys_for(4, 40)
    keys += list(range(0x0F00000000000000, 0x0F00000000000000 + 30))
    ops = [("insert", k, k ^ 0xAB) for k in dict.fromkeys(keys)]
    return ops + [("delete", k, 0) for k in keys[:8]]


def interrupt_ops():
    return [("insert", k, k + 3) for k in keys_for(5, 30)]


def baseline_ops(seed=1, n=50):
    return [("insert", k, k + 1) for k in keys_for(seed, n)]


def buggy_ops():
    """tests/test_baselines.py's split-persist bug: a sorted fill."""
    return [("insert", k, k + 1) for k in sorted(keys_for(2, 40))]


def audit_ops():
    """The two audits of the JAX tests, one after the other."""
    keys = keys_for(3, 150)
    ops = [("insert", k, k + 9) for k in keys]
    ops += [("delete", k, 0) for k in keys[:40]]
    ops += [("lookup", k, 0) for k in keys[40:80]]
    return ops + [("insert", k, k + 1) for k in keys_for(5, 120)]


def both(factories, ops, **kw):
    jf, tf = factories
    return (jax_run_crash_sweep(jf, ops, **kw),
            run_crash_sweep(tf, ops, **kw))


def same_report(jr, tr):
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.summary() == jr.summary() and tr.ok == jr.ok


# the sweeps of the JAX tests, as (factories, ops, keyword arguments)
SWEEPS = {
    **{f"{n}-powerfail": (CONVERTED[n], powerfail_ops,
                          dict(mode="powerfail", post_writes=6,
                               max_states=4000)) for n in CONVERTED},
    **{f"{n}-interrupt": (CONVERTED[n], interrupt_ops,
                          dict(mode="interrupt", post_writes=4,
                               max_states=1500)) for n in CONVERTED},
    "fastfair-powerfail": (BASELINES["fastfair"], baseline_ops,
                           dict(mode="powerfail", post_writes=4,
                                max_states=2500)),
    "cceh-powerfail": (BASELINES["cceh"], baseline_ops,
                       dict(mode="powerfail", post_writes=4,
                            max_states=2500)),
    "cceh-depth1-powerfail": (BASELINES["cceh-depth1"],
                              lambda: baseline_ops(4, 60),
                              dict(mode="powerfail", post_writes=4,
                                   max_states=2500)),
}


@pytest.mark.parametrize("name", list(SWEEPS))
def test_crash_sweep_matches_jax(name):
    factories, ops, kw = SWEEPS[name]
    jr, tr = both(factories, ops(), **kw)
    same_report(jr, tr)
    assert tr.ok, tr.summary()
    if name.split("-")[0] in CONVERTED and "powerfail" in name:
        assert tr.n_crash_states > 50, tr.summary()


def test_buggy_fastfair_fails_as_in_jax():
    """The paper's §7.5 FAST&FAIR split bug: both sweeps lose keys, with
    the same failure lists."""
    jr, tr = both((lambda p: JFastFair(p, fixed=False),
                   lambda p: FastFair(p, fixed=False, device=CPU)),
                  buggy_ops(), mode="powerfail", post_writes=2,
                  max_states=2500)
    same_report(jr, tr)
    assert not tr.ok and tr.consistency_failures, tr.summary()


@pytest.mark.parametrize("name,mode", [("P-CLHT", "powerfail"),
                                       ("P-ART", "powerfail"),
                                       ("P-BwTree", "interrupt"),
                                       ("cceh", "powerfail")])
def test_crash_sweep_with_four_post_crash_threads_is_ok(name, mode):
    """§7.5's post-crash phase from several threads: the interleaving is
    the scheduler's, so only the verdict is held, not the report."""
    report = run_crash_sweep(ALL[name][1], interrupt_ops(), mode=mode,
                             post_writes=8, post_threads=4, max_states=400)
    assert report.ok, report.summary()
    assert report.n_crash_states > 0


def test_crash_sweep_evicts_and_crashes_only_listed_ops_like_jax():
    """``crash_ops`` and ``evict_probability`` reach the same states."""
    jr, tr = both(CONVERTED["P-Masstree"], powerfail_ops(),
                  crash_ops=range(0, 78, 5), mode="powerfail",
                  evict_probability=0.5, post_writes=3, seed=3)
    same_report(jr, tr)
    assert tr.ok and tr.n_ops_tested == 16, tr.summary()


@pytest.mark.parametrize("name", list(ALL))
def test_audit_durability_matches_jax(name):
    jf, tf = ALL[name]
    ops = audit_ops()
    jr, tr = jax_audit_durability(jf, ops), audit_durability(tf, ops)
    assert tr == jr == []


@pytest.mark.parametrize("name", ["P-CLHT", "P-Masstree", "fastfair"])
def test_audit_durability_reports_the_same_lines_without_clwb(name,
                                                              monkeypatch):
    """With ``clwb`` a no-op on both sides nothing is written back, so
    the audit reports unpersisted lines after the ops: the same ops and
    the same lines."""
    monkeypatch.setattr(JPMem, "clwb", lambda self, region, idx: None)
    monkeypatch.setattr(PMem, "clwb", lambda self, region, idx: None)
    jf, tf = ALL[name]
    ops = audit_ops()[:60]
    jr, tr = jax_audit_durability(jf, ops), audit_durability(tf, ops)
    assert jr and tr == jr
