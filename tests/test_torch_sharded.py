"""The scale-out layer and the PM baselines on the port (repro_torch,
device="cpu") against the JAX package, bit for bit.

On the CPU the port's sharded path runs the plain PyTorch versions of
its three scale-out kernels: ``shard_route`` routes every plan,
``conflict_any`` admits every stream candidate, and the mesh read path
searches every shard's run in one ``scan_window_rows`` call.  The JAX
package routes and admits on the host and runs its mesh lookup as a
vmapped lower bound.  Held against each other on the same plans, made
from a seed with numpy:

* ``mesh_lookup`` over stacked runs of different lengths (one empty),
  holding keys of 2^63 and above;
* ``split_by_shard``;
* ``ShardedIndex`` with 4 shards over P-CLHT, CCEH, FAST&FAIR, Level
  hashing, P-ART and P-Masstree: per-op results, tallies, waves, probe
  deltas, ``stats``, and each shard's PMem counters and probe_stats, on
  mixed plans, the per-shard and the mesh read paths;
* crash isolation inside one shard's group commit, and its replay;
* ``StreamDriver`` ticks, deferrals and per-ticket results;
* the three baselines' YCSB plans, unsharded;
* ``open_index(shards=...)`` for all eight kinds.

No tolerance: every compared value is an integer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import open_index as jax_open_index
from repro.core import PART as JPART
from repro.core import PCLHT as JPCLHT
from repro.core import PMasstree as JPMasstree
from repro.core import PMem as JPMem
from repro.core import CrashPoint as JCrashPoint
from repro.core import Plan as JPlan
from repro.core.baselines import CCEH as JCCEH
from repro.core.baselines import FastFair as JFastFair
from repro.core.baselines import LevelHashing as JLevelHashing
from repro.core.plan import split_by_shard as jax_split_by_shard
from repro.core.ycsb import generate as jax_generate
from repro.distributed import ShardedIndex as JShardedIndex
from repro.distributed import StreamDriver as JStreamDriver
from repro.distributed.mesh import build_stacked as jax_build_stacked
from repro.distributed.mesh import mesh_lookup as jax_mesh_lookup
from repro_torch.api import Plan, open_index
from repro_torch.core import PART, PCLHT, CrashPoint, PMasstree, PMem
from repro_torch.core import split_by_shard
from repro_torch.core.baselines import CCEH, FastFair, LevelHashing
from repro_torch.core.ycsb import generate
from repro_torch.distributed import ShardedIndex, StreamDriver
from repro_torch.distributed import mesh as tmesh
from repro_torch.kernels import scan as tscan

CPU = torch.device("cpu")
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern

# (JAX factory, port factory) per kind, as the JAX package's
# tests/test_sharded.py builds its shards
KINDS = {
    "clht": (lambda p: JPCLHT(p, n_buckets=64),
             lambda p: PCLHT(p, n_buckets=64, device=CPU)),
    "cceh": (lambda p: JCCEH(p, depth=2, fixed=True),
             lambda p: CCEH(p, depth=2, fixed=True, device=CPU)),
    "fastfair": (JFastFair, lambda p: FastFair(p, device=CPU)),
    "level": (JLevelHashing, lambda p: LevelHashing(p, device=CPU)),
    "art": (JPART, lambda p: PART(p, device=CPU)),
    "masstree": (JPMasstree, lambda p: PMasstree(p, device=CPU)),
}


def both(kind, n_shards=4, **kw):
    jf, tf = KINDS[kind]
    return (JShardedIndex(jf, n_shards, **kw),
            ShardedIndex(tf, n_shards, device=CPU, **kw))


def plans(kinds, keys, aux):
    return (JPlan.from_arrays(kinds, keys, aux),
            Plan.from_arrays(kinds, keys, aux))


def random_plan(rng, n, pool, *, scans):
    """Mixed ops over a pool of keys spread over [1, 2^63), so prefix
    routing reaches every shard."""
    kinds = rng.integers(0, 5 if scans else 4, size=n).astype(np.int32)
    keys = rng.choice(pool, n).astype(np.int64)
    aux = rng.integers(1, 50, size=n).astype(np.int64)
    return plans(kinds, keys, aux)


def load(j, t, keys, base=1000):
    n = keys.size
    jp, tp = plans(np.ones(n, np.int32), keys, keys + base)
    assert_same(j.execute(jp, collect_results=False),
                t.execute(tp, collect_results=False), results=False)


def assert_same(jr, tr, *, results=True):
    if results:
        assert tr.results == jr.results
    assert (tr.found, tr.acked, tr.scanned) == (jr.found, jr.acked,
                                                jr.scanned)
    assert (tr.wave_kinds, tr.wave_widths) == (jr.wave_kinds,
                                               jr.wave_widths)
    assert tr.probe == jr.probe
    for name in ("shard_ops", "mesh"):  # a ShardedPlanResult's own
        assert getattr(tr, name, None) == getattr(jr, name, None)


def assert_same_state(j, t):
    assert t.stats == j.stats
    assert t.last_crashed_shard == j.last_crashed_shard
    for jpm, tpm in zip(j.pmems, t.pmems):
        assert dataclasses.asdict(tpm.counters) == \
            dataclasses.asdict(jpm.counters)
    for jsh, tsh in zip(j.shards, t.shards):
        assert tsh.probe_stats == jsh.probe_stats
    assert dataclasses.asdict(t.pmem.counters) == \
        dataclasses.asdict(j.pmem.counters)
    assert list(t.items()) == list(j.items())


# -- the kernels' host-side pieces -----------------------------------------

def test_mesh_lookup_matches_jax_with_keys_at_or_above_2_63():
    rng = np.random.default_rng(1)
    runs, queries = [], []
    for n in (700, 0, 1, 1500):
        keys = np.unique(rng.integers(HIGH, (1 << 63) - 1, size=n))
        if n:
            keys[0] = HIGH  # the lowest key in signed order
            keys = np.unique(keys)
        vals = rng.integers(1, 1 << 62, size=keys.size)
        runs.append((keys, vals) if keys.size else None)
        q = rng.integers(HIGH, (1 << 63) - 1, size=300)
        if keys.size:
            q[:150] = rng.choice(keys, 150)
        q[-4:] = [0, HIGH, -1, (1 << 63) - 1]
        queries.append(q)
    queries[1] = queries[1][:0]  # an empty shard with no queries
    assert any((r[0] < 0).sum() > 10 for r in runs if r is not None)
    got = tmesh.mesh_lookup(tmesh.build_stacked(runs, device=CPU), queries)
    ref = jax_mesh_lookup(jax_build_stacked(runs), queries)
    assert len(got) == len(ref) == 4
    for s, ((gf, gv), (rf, rv)) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(gf, rf)
        np.testing.assert_array_equal(gv, rv)
        if runs[s] is not None:
            want = tscan.lookup_ref(queries[s], *runs[s])
            np.testing.assert_array_equal(gf, want[0])
            np.testing.assert_array_equal(gv, want[1])
    assert got[0][0][:150].all() and got[3][0][-3]  # HIGH is resident
    stacked = tmesh.build_stacked(runs, device=CPU)
    np.testing.assert_array_equal(stacked.n, [700, 0, 1, 1500])
    assert stacked.keys.shape == (2201,)  # no padding
    assert tmesh.mesh_devices(4) is False and tmesh.mesh_devices(1) is False


def test_mesh_lookup_launches_one_sharded_search_per_call(monkeypatch):
    calls = []

    def counted(*args, **kw):
        calls.append(kw["max_count"])
        return tscan.scan_window_rows(*args, **kw)

    monkeypatch.setattr(tmesh, "scan_window_rows", counted)
    runs = [(np.arange(1, 50, dtype=np.int64), np.arange(49,
                                                         dtype=np.int64))]
    runs *= 8
    tmesh.mesh_lookup(tmesh.build_stacked(runs, device=CPU),
                      [np.arange(s, 40, dtype=np.int64) for s in range(8)])
    assert calls == [1]


@pytest.mark.parametrize("scan_suffix", [True, False])
def test_split_by_shard_matches_jax(scan_suffix):
    rng = np.random.default_rng(2)
    for has_scans in (True, False):
        kinds = rng.integers(0, 5 if has_scans else 4, size=300)
        shards = rng.integers(0, 8, size=300).astype(np.int32)
        got = split_by_shard(kinds, shards, 8, scan_suffix=scan_suffix)
        ref = jax_split_by_shard(kinds, shards, 8, scan_suffix=scan_suffix)
        assert len(got) == len(ref) == 8
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


# -- ShardedIndex ------------------------------------------------------------

@pytest.mark.parametrize("kind", list(KINDS))
def test_sharded_plans_match_jax(kind):
    rng = np.random.default_rng(11)
    j, t = both(kind)
    assert t.scheme == j.scheme
    pool = np.unique(rng.integers(1, (1 << 63) - 1, size=400))
    load(j, t, pool[::2])
    routes = t.route(pool)
    np.testing.assert_array_equal(routes, j.route(pool))
    assert np.unique(routes).size == 4
    for _ in range(3):
        jp, tp = random_plan(rng, 200, pool, scans=t.ORDERED)
        assert_same(j.execute(jp), t.execute(tp))
    gets = np.concatenate([pool, rng.integers(1, 1 << 62, size=50)])
    jp, tp = plans(np.zeros(gets.size, np.int32), gets,
                   np.zeros(gets.size, np.int64))
    for kw in ({"mesh": False, "force_kernel": True}, {"mesh": True},
               {"mesh": False}):
        jr, tr = j.execute(jp, **kw), t.execute(tp, **kw)
        assert_same(jr, tr)
        assert tr.mesh == kw["mesh"]
    assert t.stats["mesh_plans"] == 1
    if t.ORDERED:
        assert t.stats["scan_merges"] > 0
    assert_same_state(j, t)
    t.check_invariants()


@pytest.mark.parametrize("kind", list(KINDS))
def test_crash_isolation_and_replay_match_jax(kind):
    """A crash inside one shard's group commit: siblings finish and
    serve the new values with no replay; recovery replays exactly the
    crashed shard's sub-plan; both packages agree throughout."""
    rng = np.random.default_rng(7)
    j, t = both(kind)
    keys = np.unique(rng.integers(1, (1 << 63) - 1, size=300))
    load(j, t, keys)
    routes = t.route(keys)
    victim = int(routes[0])
    jp, tp = plans(np.full(keys.size, 2, np.int32), keys, keys + 5555)
    for idx in (j, t):
        idx.pmems[victim].arm_crash(after_stores=3)
    with pytest.raises(JCrashPoint):
        j.execute(jp, collect_results=False)
    with pytest.raises(CrashPoint):
        t.execute(tp, collect_results=False)
    assert t.last_crashed_shard == j.last_crashed_shard == victim
    assert all(pm.crashes == 0 for s, pm in enumerate(t.pmems)
               if s != victim)
    sib = keys[routes != victim]
    jg, tg = plans(np.zeros(sib.size, np.int32), sib,
                   np.zeros(sib.size, np.int64))
    jr, tr = j.execute(jg), t.execute(tg)
    assert_same(jr, tr)
    assert tr.results == (sib + 5555).tolist()
    assert_same_state(j, t)
    for idx in (j, t):
        idx.crash_shard(victim)
    replayed = t.recover_shard(victim, replay=True)
    assert replayed == j.recover_shard(victim, replay=True) == \
        int((routes == victim).sum())
    assert_same_state(j, t)  # walks both indexes' items() alike
    assert dict(t.items()) == {int(k): int(k) + 5555 for k in keys}
    t.check_invariants()


def test_whole_domain_crash_drops_pending_replay_like_jax():
    j, t = both("clht")
    keys = np.arange(1, 201, dtype=np.int64)
    load(j, t, keys)
    victim = int(t.route(keys)[0])
    jp, tp = plans(np.full(200, 2, np.int32), keys, keys + 7777)
    for idx, plan in ((j, jp), (t, tp)):
        idx.pmems[victim].arm_crash(after_stores=3)
        with pytest.raises(Exception) as err:
            idx.execute(plan, collect_results=False)
        assert type(err.value).__name__ == "CrashPoint"
        idx.pmem.crash()
        idx.recover()
        assert idx.recover_shard(victim) == 0
    jg, tg = plans(np.zeros(200, np.int32), keys, np.zeros(200, np.int64))
    assert_same(j.execute(jg), t.execute(tg))
    assert_same_state(j, t)


def test_sharded_index_rejects_a_shard_on_another_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="shard is on cpu"):
        ShardedIndex(lambda p: PCLHT(p, n_buckets=64, device=CPU), 2,
                     device="cuda")


# -- StreamDriver ------------------------------------------------------------

@pytest.mark.parametrize("kind,n_shards", [("clht", 4), ("masstree", 1)])
def test_stream_driver_matches_jax(kind, n_shards):
    """4 streams submit YCSB-A plans over overlapping key ranges: the
    port's admission (the plain ``conflict_any`` on the CPU) admits
    and defers exactly what the JAX package's StreamDriver admits
    and defers with its host oracle."""
    w = generate("A", 1200, 1600, seed=3)
    assert w.run_ops == jax_generate("A", 1200, 1600, seed=3).run_ops
    if n_shards > 1:
        j, t = both(kind, n_shards)
    else:
        jf, tf = KINDS[kind]
        j, t = jf(JPMem()), tf(PMem())
    load(j, t, np.array([k for _, k, _ in w.load_ops], np.int64))
    drivers = (JStreamDriver(j, 4), StreamDriver(t, 4))
    tickets = ([], [])
    for i in range(12):
        ops = w.run_ops[100 * i:100 * i + 300]  # neighbours overlap
        for d, ts, plan_cls in zip(drivers, tickets, (JPlan, Plan)):
            ts.append(d.streams[i % 4].submit(plan_cls.from_ops(ops)))
    assert drivers[1].run() == drivers[0].run()
    jd, td = drivers
    skip = ("wall_ns", "critical_ns")
    assert {k: v for k, v in td.stats.items() if k not in skip} == \
        {k: v for k, v in jd.stats.items() if k not in skip}
    assert td.stats["deferred_plans"] > 0
    assert td.stats["multi_stream_ticks"] > 0
    for jt, tt in zip(*tickets):
        assert (tt.tick, tt.result) == (jt.tick, jt.result)
    assert sorted(t.items()) == sorted(j.items())


# -- the baselines, unsharded ------------------------------------------------

@pytest.mark.parametrize("kind,wl", [("cceh", "A"), ("cceh", "C"),
                                     ("fastfair", "A"), ("fastfair", "C"),
                                     ("fastfair", "E0"), ("level", "A"),
                                     ("level", "C")])
def test_baseline_ycsb_plans_match_jax(kind, wl):
    n_load = 1200
    n_run = 400 if wl == "E0" else n_load
    jw, tw = jax_generate(wl, n_load, n_run, seed=9), \
        generate(wl, n_load, n_run, seed=9)
    assert (tw.load_ops, tw.run_ops) == (jw.load_ops, jw.run_ops)
    js, ts = jax_open_index(kind), open_index(kind, device=CPU)
    assert ts.ordered == js.ordered
    reads = [("lookup", k, 0) for _, k, _ in tw.load_ops]
    for ops, force in ((tw.load_ops, False), (reads, True),
                       (tw.run_ops, False)):
        for lo in range(0, len(ops), 400):
            chunk = ops[lo:lo + 400]
            jr = js.execute(JPlan.from_ops(chunk), force_kernel=force)
            tr = ts.execute(Plan.from_ops(chunk), force_kernel=force)
            assert tr.results == jr.results
            assert (tr.wave_kinds, tr.wave_widths) == (jr.wave_kinds,
                                                       jr.wave_widths)
            assert (tr.found, tr.acked, tr.scanned) == (jr.found, jr.acked,
                                                        jr.scanned)
            assert tr.probe == jr.probe
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)
    assert dict(ts.stats) == dict(js.stats)
    assert ts.index.probe_stats == js.index.probe_stats
    assert ts.index.probe_stats["fp_compares"] > 0  # the kernel path ran
    assert sorted(ts.items()) == sorted(js.items())


# -- the facade --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["clht", "art", "hot", "masstree",
                                  "bwtree", "cceh", "fastfair", "level"])
def test_open_index_sharded_matches_jax(kind):
    js = jax_open_index(kind, shards=4)
    ts = open_index(kind, shards=4, device=CPU)
    assert (ts.shards, ts.index.scheme, ts.index.device) == \
        (4, js.index.scheme, CPU)
    assert all(sh.device == CPU for sh in ts.index.shards)
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(1, (1 << 63) - 1, size=120)).tolist()
    for s in (js, ts):
        with s.pipeline() as p:
            for k in keys:
                p.put(k, k % 1000 + 1)
    probe = keys + rng.integers(1, 1 << 62, size=20).tolist()
    jr = js.execute(JPlan.from_ops([("lookup", k, 0) for k in probe]))
    tr = ts.execute(Plan.from_ops([("lookup", k, 0) for k in probe]))
    assert tr.results == jr.results
    assert tr.found == len(keys)
    js.crash()
    ts.crash()  # whole-domain powerfail + re-attach
    assert [ts.get(k) for k in keys[:10]] == [js.get(k) for k in keys[:10]]
    assert dict(ts.stats) == dict(js.stats)


def test_open_index_sharded_options(monkeypatch):
    s = open_index("clht", shards=4, device=CPU, scheme="prefix",
                   mesh_reads=True, n_buckets=64)
    assert (s.index.scheme, s.index.mesh_reads) == ("prefix", True)
    assert s.put(5, 7) and s.get(5) == 7
    drv = s.streams(2)
    t = drv.streams[0].submit(Plan.from_ops([("lookup", 5, 0)] * 8))
    drv.run()
    assert t.result == [7] * 8
    assert s.index.stats["mesh_plans"] == 1
    assert s.stats["stream_ticks"] == 1
    with pytest.raises(ValueError):
        open_index("clht", shards=4, pmem=PMem(), device=CPU)
    with pytest.raises(AssertionError):
        open_index("clht", shards=3, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        open_index("clht", shards=4)
