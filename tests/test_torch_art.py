"""P-ART and P-HOT on the port (repro_torch, device="cpu") against the
JAX package, bit for bit.

The radix descent: ``descend_plain`` (what the port's wrapper runs on
CPU tensors) on the packed child entries ``pack_children`` builds,
against the JAX package's Pallas ``art_descend`` in interpret mode on
the export's own pages and its numpy oracle, counts included, on
exported node pages and on random pages whose levels leave the valid
range (the TPU kernel clamps them; the packing bakes the clamp in).  The indexes: the same YCSB plans through both
facades give the same results, wave schedules, tallies, probe-stat
deltas and PMem counters; a plan crash sweep on P-ART agrees; a P-ART
image carried over with ``convert.pmem_from_arrays`` answers lookups
and scans identically.  No tolerance: every compared value is an
integer.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import open_index as jax_open_index
from repro.core import PART as JPART, PHOT as JPHOT, PMem as JPMem
from repro.core.crash_testing import plan_crash_sweep as jax_plan_crash_sweep
from repro.core.plan import Plan as JPlan
from repro.core.ycsb import generate as jax_generate
from repro.kernels.art_probe import art_descend as jax_art_descend
from repro.kernels.art_probe import descend_fp_ref as jax_descend_fp_ref
from repro.kernels.art_probe import key_units as jax_key_units
from repro.kernels.art_probe import leaf_fp_lane as jax_leaf_fp_lane
from repro.kernels.probe import combine64, split64
from repro.kernels.probe.fingerprint import fp_partial as jax_fp_partial
from repro_torch.api import Plan, open_index
from repro_torch.convert import pmem_from_arrays
from repro_torch.core import PART, PHOT, PMem, plan_crash_sweep
from repro_torch.core.ycsb import generate
from repro_torch.kernels import art_probe as tart
from repro_torch.kernels.probe import fp_partial

N = 1500
PLAN_OPS = 500
HIGH = np.int64(-(1 << 63))  # 2^63 as an int64 bit pattern


def loaded(kind_j, kind_t, n, seed):
    """A JAX and a port index over the same ``n`` random keys, a few
    deleted (tombstones the leaf check must reject)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 62, size=n))
    j, t = kind_j(JPMem(seed=seed)), kind_t(PMem(seed=seed), device="cpu")
    for k in keys.tolist():
        assert j.insert(k, k ^ (1 << 40)) == t.insert(k, k ^ (1 << 40))
    for k in keys[::37].tolist():
        assert j.delete(k) == t.delete(k)
    return j, t, keys


def queries_for(keys, rng, n_q):
    """Hits, misses, partial-key near-misses (a fresh key with a
    resident key's low byte), deleted keys, key 0 and keys >= 2^63."""
    q = rng.integers(1, 1 << 62, size=n_q)
    q[: n_q // 2] = rng.choice(keys, n_q // 2)
    near = rng.choice(keys, n_q // 8)
    q[n_q // 2: n_q // 2 + near.size] = (
        rng.integers(1, 1 << 54, size=near.size) << 8) | (near & 0xFF)
    q[-8:-4] = keys[::37][:4]
    q[-4] = 0
    q[-3] = HIGH
    q[-2] = HIGH | np.int64(keys[0])
    q[-1] = -1
    return q.astype(np.int64)


def jax_kernel(q, arrays):
    """The Pallas kernel in interpret mode, as the JAX package's
    ``_descend`` feeds it; outputs as numpy [Q] arrays."""
    unit_bits = int(arrays.get("unit_bits", 8))
    lklo, lkhi = split64(arrays["leaf_key"])
    lvlo, lvhi = split64(arrays["leaf_val"])
    qlo, qhi = split64(q)
    lfp = np.asarray(arrays["leaf_fp"]).astype(np.int32)
    out = jax_art_descend(
        jnp.asarray(jax_key_units(q, unit_bits)), jnp.asarray(qlo),
        jnp.asarray(qhi), jnp.asarray(jax_fp_partial(q).astype(np.int32)),
        jnp.asarray(arrays["children"]),
        jnp.asarray(arrays["level"], jnp.int32),
        jnp.asarray(arrays["is_leaf"], jnp.int32), jnp.asarray(lfp),
        jnp.asarray(lklo), jnp.asarray(lkhi), jnp.asarray(lvlo),
        jnp.asarray(lvhi), interpret=True)
    found, olo, ohi, nenc, nfp, nfalse = (np.asarray(a) for a in out)
    return found, combine64(olo, ohi), nenc, nfp, nfalse


def port_plain(q, arrays):
    pages = tart.ops._prepare(arrays, torch.device("cpu"))
    unit_bits, *t = pages
    out = tart.art_descend(torch.from_numpy(q), *t, unit_bits=unit_bits)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("kinds", [(JPART, PART), (JPHOT, PHOT)],
                         ids=["art-8bit", "hot-4bit"])
def test_descend_plain_matches_jax_kernel_and_oracle(kinds):
    j, t, keys = loaded(*kinds, 3000, seed=1)
    arrays = j.export_arrays()
    port_arrays = t.export_arrays()
    for name in ("children", "level", "is_leaf", "leaf_key", "leaf_val",
                 "leaf_fp"):
        np.testing.assert_array_equal(arrays[name], port_arrays[name])
    assert arrays.get("unit_bits", 8) == port_arrays.get("unit_bits", 8)
    q = queries_for(keys, np.random.default_rng(2), 2048)
    got = port_plain(q, arrays)
    ref = jax_kernel(q, arrays)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    oracle = jax_descend_fp_ref(q, arrays)
    for g, o, r in zip(got, tart.descend_fp_ref(q, arrays), oracle):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(o, r)
    np.testing.assert_array_equal(tart.leaf_fp_lane(port_arrays),
                                  jax_leaf_fp_lane(arrays))
    found, _, nenc, nfp, nfalse = got
    assert found.sum() > 900 and not found[-5:].any()
    assert nfalse.sum() > 0  # near-misses passed the filter
    assert (nfp <= nenc).all() and (nfalse <= nfp).all()


@pytest.mark.parametrize("unit_bits", [8, 4])
def test_descend_plain_clamps_levels_as_the_tpu_kernel(unit_bits):
    """Random node pages with levels outside [0, U) and cycles: the
    lockstep loop must stop after U + 1 steps and clamp every level,
    as the Pallas kernel does."""
    rng = np.random.default_rng(unit_bits)
    n, fan, n_units = 300, 1 << unit_bits, 64 // unit_bits
    children = rng.integers(-1, n, size=(n, fan)).astype(np.int32)
    is_leaf = (rng.random(n) < 0.3).astype(np.uint8)
    is_leaf[0] = 0
    leaf_key = rng.integers(1, 1 << 62, size=n)
    leaf_val = rng.integers(0, 3, size=n) * rng.integers(1, 1 << 62, size=n)
    arrays = {"children": children,
              "level": rng.integers(-3, n_units + 3, size=n).astype(np.int32),
              "is_leaf": is_leaf, "leaf_key": leaf_key,
              "leaf_val": leaf_val,
              "leaf_fp": np.where(is_leaf != 0, fp_partial(leaf_key), 0),
              "unit_bits": unit_bits}
    q = rng.integers(1, 1 << 62, size=1024)
    q[:300] = leaf_key
    q[300] = 0
    q[301] = HIGH
    got = port_plain(q.astype(np.int64), arrays)
    ref = jax_kernel(q.astype(np.int64), arrays)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[2].sum() > 0  # walks reached leaves


def test_fp_partial_and_key_units_match_jax():
    rng = np.random.default_rng(4)
    k = np.concatenate([[0, 1, 256, 255, -1, HIGH],
                        rng.integers(-(1 << 63), 1 << 63, size=4000)])
    np.testing.assert_array_equal(fp_partial(k), jax_fp_partial(k))
    for bits in (8, 4):
        np.testing.assert_array_equal(tart.key_units(k, bits),
                                      jax_key_units(k, bits))
        lvl = torch.from_numpy(rng.integers(0, 64 // bits, size=k.size))
        units = tart.ref.key_unit(torch.from_numpy(k), lvl, bits).numpy()
        np.testing.assert_array_equal(
            units, jax_key_units(k, bits)[np.arange(k.size), lvl.numpy()])


def test_art_descend_cpu_runs_plain_version_and_counts_no_launch():
    j, _, keys = loaded(JPART, PART, 200, seed=5)
    arrays = j.export_arrays()
    before = dict(tart.LAUNCHES)
    q = queries_for(keys, np.random.default_rng(5), 64)
    got = port_plain(q, arrays)
    assert tart.LAUNCHES == before
    stats = {k: 0 for k in ("fp_compares", "candidates", "fp_hits",
                            "fp_false_positives", "pm_load_words")}
    found, vals = tart.batched_lookup(q, arrays, device=torch.device("cpu"),
                                      stats=stats)
    np.testing.assert_array_equal(found, got[0])
    np.testing.assert_array_equal(vals, got[1])
    assert stats["fp_compares"] == int(got[2].sum())
    assert tart.LAUNCHES == before


def test_art_descend_rejects_bad_inputs():
    j, _, _ = loaded(JPART, PART, 100, seed=6)
    unit_bits, *good = tart.ops._prepare(j.export_arrays(),
                                         torch.device("cpu"))
    q = torch.arange(1, 9, dtype=torch.int64)
    with pytest.raises(ValueError):
        tart.art_descend(q, *good, unit_bits=4)  # fan 256, not 16
    with pytest.raises(ValueError):
        tart.art_descend(q, *good, unit_bits=5)
    bad = list(good)
    bad[0] = good[0].to(torch.int64)
    with pytest.raises(TypeError):
        tart.art_descend(q, *bad, unit_bits=8)
    bad = list(good)
    bad[2] = good[2][:-1]
    with pytest.raises(ValueError):
        tart.art_descend(q, *bad, unit_bits=8)
    for root in (-1, 32, 8):  # not a header; a level past U - 1 = 7
        bad = list(good)
        bad[1] = root
        with pytest.raises(ValueError):
            tart.art_descend(q, *bad, unit_bits=8)
    with pytest.raises(ValueError):
        tart.art_descend(q.view(2, 4), *good, unit_bits=8)


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
    assert ts.index.probe_stats == js.index.probe_stats


@pytest.mark.parametrize("wl", ["A", "C", "E0"])
@pytest.mark.parametrize("kind", ["art", "P-HOT"])
def test_ycsb_plans_match_jax(kind, wl):
    n_run = 400 if wl == "E0" else N
    jw = jax_generate(wl, N, n_run, seed=7)
    tw = generate(wl, N, n_run, seed=7)
    assert (tw.load_ops, tw.run_ops) == (jw.load_ops, jw.run_ops)
    js, ts = jax_open_index(kind), open_index(kind, device="cpu")
    run_both(js, ts, tw.load_ops)
    # one all-GET plan exports the snapshot, so the run phase's read
    # waves probe it (and overlap its write waves optimistically)
    run_both(js, ts, [("lookup", k, 0) for _, k, _ in tw.load_ops])
    run_both(js, ts, tw.run_ops)
    assert ts.index.probe_stats["fp_compares"] > 0
    js.index.fingerprints = ts.index.fingerprints = False
    run_both(js, ts, tw.run_ops[:PLAN_OPS])


def test_plan_crash_sweep_matches_jax_on_art():
    w = generate("A", 600, 600, seed=9)
    setup = w.load_ops
    ops = w.run_ops[:500]
    jr = jax_plan_crash_sweep(JPART, ops, setup_ops=setup, max_points=6,
                              seed=2)
    tr = plan_crash_sweep(lambda pm: PART(pm, device="cpu"), ops,
                          setup_ops=setup, max_points=6, seed=2)
    assert tr.ok, tr.summary()
    assert (tr.n_crash_states, tr.n_ops_tested, tr.consistency_failures,
            tr.durability_failures, tr.stall_failures) == \
        (jr.n_crash_states, jr.n_ops_tested, jr.consistency_failures,
         jr.durability_failures, jr.stall_failures)


def regions(pmem):
    return [{"rid": r.rid, "name": r.name, "cache": r.cache, "pm": r.pm,
             "stores": r.stores} for r in pmem.regions.values()]


def test_carried_over_art_answers_lookups_and_scans_identically():
    rng = np.random.default_rng(11)
    src = JPART(JPMem(seed=3), name="art")
    keys = [int(k) for k in rng.integers(1, 1 << 62, size=800)]
    for k in keys:
        src.insert(k, k % 977 + (1 << 33))
    for k in keys[::11]:
        src.delete(k)
    jp = src.pmem
    tp = pmem_from_arrays(regions(jp), jp._next_rid,
                          counters=dataclasses.asdict(jp.counters), seed=3)
    # both packages re-attach to the same image by name; the arena's
    # volatile bump cursor travels beside the image
    j = JPART(jp, name="art")
    t = PART(tp, name="art", device="cpu")
    j.set_volatile_state(src.volatile_state())
    t.set_volatile_state({"cursor": src.arena._cursor,
                          "segments": [tp.regions[r.rid]
                                       for r in src.arena.segments]})
    jp.begin_op()
    tp.begin_op()
    probes = keys + [int(k) for k in rng.integers(1, 1 << 62, size=60)]
    assert [j.lookup(k) for k in probes] == [t.lookup(k) for k in probes]
    assert j._lookup_batch(probes, force_kernel=True) == \
        t._lookup_batch(probes, force_kernel=True)
    starts = probes[::9] + [0, -1]
    counts = [int(c) for c in rng.integers(0, 120, size=len(starts))]
    assert j._scan_batch(starts, counts, force_kernel=True) == \
        t._scan_batch(starts, counts, force_kernel=True)
    assert [j.scan(s, c) for s, c in zip(starts[:20], counts)] == \
        [t.scan(s, c) for s, c in zip(starts[:20], counts)]
    for k in keys[:50]:
        assert j.insert(k ^ 1, 7) == t.insert(k ^ 1, 7)
    assert j._lookup_batch(probes) == t._lookup_batch(probes)
    assert dataclasses.asdict(jp.counters) == dataclasses.asdict(tp.counters)
    assert j.probe_stats == t.probe_stats
    for rid, jr in jp.regions.items():
        np.testing.assert_array_equal(jr.cache, tp.regions[rid].cache)
