"""YCSB plans over P-CLHT through the port's facade
(``repro_torch.api.open_index("clht", device="cpu")``) against the JAX
package's (``repro.api.open_index("clht")``), bit for bit: results,
wave kinds and widths, found/acked tallies, probe-stat deltas and PMem
counters, plan by plan.  Also the mid-plan crash prefix property and
the group-commit crash sweep on the port.  No tolerance: every
compared value is an integer."""

import dataclasses

import numpy as np
import pytest

from repro.api import open_index as jax_open_index
from repro.core import PCLHT as JPCLHT
from repro.core.crash_testing import plan_crash_sweep as jax_plan_crash_sweep
from repro.core.plan import Plan as JPlan
from repro.core.plan import schedule_waves as jax_schedule_waves
from repro.core.ycsb import PhaseExecutor as JPhaseExecutor
from repro.core.ycsb import generate as jax_generate
from repro.kernels.conflict import wave_levels_ref as jax_levels_ref
from repro_torch.api import Plan, open_index
from repro_torch.core import PCLHT, PMem, PMSnapshot, plan_crash_sweep
from repro_torch.core.plan import _levels_no_scan, schedule_waves
from repro_torch.core.pmem import CrashPoint
from repro_torch.core.ycsb import PhaseExecutor, generate
from repro_torch.kernels.conflict import wave_levels_ref

N = 2000
PLAN_OPS = 1000


def run_both(js, ts, ops):
    """One plan per PLAN_OPS ops on both sessions; every PlanResult
    field must agree."""
    for lo in range(0, len(ops), PLAN_OPS):
        chunk = ops[lo:lo + PLAN_OPS]
        jr = js.execute(JPlan.from_ops(chunk))
        tr = ts.execute(Plan.from_ops(chunk))
        assert tr.results == jr.results
        assert (tr.wave_kinds, tr.wave_widths) == (jr.wave_kinds,
                                                   jr.wave_widths)
        assert (tr.found, tr.acked, tr.scanned) == (jr.found, jr.acked,
                                                    jr.scanned)
        assert tr.probe == jr.probe
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)
    assert dict(ts.stats) == dict(js.stats)


@pytest.mark.parametrize("wl", ["A", "B", "C", "D", "F"])
def test_ycsb_plans_match_jax(wl):
    jw = jax_generate(wl, N, N, seed=5)
    tw = generate(wl, N, N, seed=5)
    assert (tw.load_ops, tw.run_ops) == (jw.load_ops, jw.run_ops)
    js, ts = jax_open_index("clht"), open_index("clht", device="cpu")
    run_both(js, ts, tw.load_ops)
    # one all-GET plan exports the snapshot, so the run phase's read
    # waves probe it (and overlap its write waves optimistically)
    run_both(js, ts, [("lookup", k, 0) for _, k, _ in tw.load_ops])
    run_both(js, ts, tw.run_ops)
    assert ts.index.probe_stats["fp_compares"] > 0
    # the tally-only driver over the same stream
    jd = JPhaseExecutor(js.index, batch_lookups=True,
                        max_batch=PLAN_OPS).run(tw.run_ops)
    td = PhaseExecutor(ts.index, batch_lookups=True,
                       max_batch=PLAN_OPS).run(tw.run_ops)
    assert td == jd
    assert ts.index.probe_stats == js.index.probe_stats


@pytest.mark.parametrize("scans", [False, True])
def test_scheduler_matches_jax_and_peeling_oracle(scans):
    """The port's wave schedule equals the JAX package's, wave for
    wave; its no-scan levels (before push-reads-late) equal the
    port's peeling oracle, which equals the JAX package's."""
    rng = np.random.default_rng(2)
    for _ in range(30):
        n = int(rng.integers(1, 150))
        kinds = rng.integers(0, 5 if scans else 4, size=n).astype(np.int32)
        keys = rng.integers(1, 20, size=n).astype(np.int64)
        got = schedule_waves(kinds, keys)
        ref = jax_schedule_waves(kinds, keys)
        assert [w.kind for w in got] == [w.kind for w in ref]
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.indices, b.indices)
        levels = wave_levels_ref(kinds, keys)
        np.testing.assert_array_equal(levels, jax_levels_ref(kinds, keys))
        if not scans:
            np.testing.assert_array_equal(
                _levels_no_scan(kinds, keys, push_reads_late=False), levels)


@pytest.mark.parametrize("wl", ["A", "F"])
def test_phase_executor_scalar_tallies_equal_plans(wl):
    """The executor's scalar mode (one index call per op) and its plan
    mode give the same op, found and acked tallies on the port."""
    w = generate(wl, N, N, seed=6)
    tallies = []
    for batch in (False, True):
        ts = open_index("clht", device="cpu")
        PhaseExecutor(ts.index, batch_lookups=batch).run(w.load_ops)
        done = PhaseExecutor(ts.index, batch_lookups=batch).run(w.run_ops)
        tallies.append({k: done[k] for k in ("insert", "update", "lookup",
                                             "found", "acked")})
    assert tallies[0] == tallies[1]
    assert tallies[0]["found"] > 0 and tallies[0]["acked"] > 0


def test_mid_wave_crash_prefix_consistent():
    """The port's form of tests/test_plan.py's mid-wave crash test for
    P-CLHT: after powerfail + recovery at sampled store counts inside
    execute(), every key's durable state is a prefix of its op history
    in the plan, and the index accepts new writes."""
    pmem = PMem()
    idx = PCLHT(pmem, n_buckets=64, device="cpu")
    rng = np.random.default_rng(23)
    pre = {int(k): (int(k) % 9973) + 1
           for k in rng.integers(1, 1 << 60, size=60)}
    for k, v in pre.items():
        idx.insert(k, v)
    hot = list(pre)[:4]
    fresh = [int(k) for k in rng.integers(1 << 60, 1 << 61, size=4)]
    plan = Plan()
    for k in hot:
        plan.get(k)
        plan.update(k, 111111)
        plan.get(k)
        plan.update(k, 222222)
    for k in fresh:
        plan.put(k, 7)
        plan.get(k)
        plan.delete(k)
    snap = PMSnapshot(pmem, idx)
    before = pmem.counters.stores
    idx.execute(plan)
    n_stores = pmem.counters.stores - before
    snap.restore(pmem)
    assert n_stores > 0
    for k_at in range(0, n_stores, max(1, n_stores // 7)):
        pmem.arm_crash(after_stores=k_at)
        try:
            idx.execute(plan)
            pmem.disarm_crash()
        except CrashPoint:
            pass
        pmem.crash(mode="powerfail")
        idx.recover()
        for k, v in pre.items():
            got = idx.lookup(k)
            if k in hot:
                assert got in (v, 111111, 222222), (k_at, k, got)
            else:
                assert got == v, (k_at, k, got)
        for k in fresh:
            assert idx.lookup(k) in (None, 7), (k_at, k)
        idx.check_invariants()
        assert idx.insert(31337 + k_at, 1)
        assert idx.lookup(31337 + k_at) == 1
        snap.restore(pmem)


def test_plan_crash_sweep_matches_jax():
    w = generate("A", 1200, 1200, seed=9)
    setup = w.load_ops
    ops = w.run_ops[:1100]
    jr = jax_plan_crash_sweep(lambda pm: JPCLHT(pm, n_buckets=64), ops,
                              setup_ops=setup, max_points=8, seed=2)
    tr = plan_crash_sweep(lambda pm: PCLHT(pm, n_buckets=64, device="cpu"),
                          ops, setup_ops=setup, max_points=8, seed=2)
    assert tr.ok, tr.summary()
    assert (tr.n_crash_states, tr.n_ops_tested, tr.consistency_failures,
            tr.durability_failures, tr.stall_failures) == \
        (jr.n_crash_states, jr.n_ops_tested, jr.consistency_failures,
         jr.durability_failures, jr.stall_failures)
