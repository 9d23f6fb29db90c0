"""P-Masstree and P-BwTree on the port (repro_torch, device="cpu")
against the JAX package, bit for bit.

The sorted-run search: ``scan_window_plain`` (what the port's wrapper
runs on CPU tensors) against the JAX package's Pallas ``scan_window``
in interpret mode, fed as its ``_run_kernel`` feeds it, and against the
numpy oracles, at C = 1 (lookups) and C = 128 (scans), with start keys
of 2^63 and above (negative as int64: lower bound 0 in the signed order
both packages use) and counts of 0.  The indexes: the same YCSB plans
(C, E0, E) through both facades give the same results, wave schedules,
tallies, probe-stat deltas and PMem counters.  No tolerance: every
compared value is an integer.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.api import open_index as jax_open_index
from repro.core.plan import Plan as JPlan
from repro.core.ycsb import generate as jax_generate
from repro.kernels.scan import lookup_ref, prepare_sorted as jax_prepare
from repro.kernels.scan import scan_ref
from repro.kernels.scan.ops import _run_kernel as jax_run_kernel
from repro_torch.api import Plan, open_index
from repro_torch.core.ycsb import generate
from repro_torch.kernels import scan as tscan

N = 1500
PLAN_OPS = 500
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern


def sorted_run(seed, n):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 62, size=n))
    vals = rng.integers(1, 1 << 62, size=keys.size)
    vals[:3] = [1 << 32, (1 << 62) - 1, 1][:vals.size]
    return keys.astype(np.int64), vals.astype(np.int64)


def starts_for(keys, rng, n_q):
    """Resident keys, keys between residents, below the first and past
    the last, key 0 and keys of 2^63 and above."""
    q = rng.integers(1, 1 << 62, size=n_q)
    q[: n_q // 2] = rng.choice(keys, n_q // 2)
    q[n_q // 2: n_q // 2 + n_q // 8] = rng.choice(keys, n_q // 8) + 1
    q[-8:] = [0, 1, keys[-1], keys[-1] + 1, HIGH, HIGH + 5, -1,
              (1 << 63) - 1]
    return q.astype(np.int64)


def port_window(q, counts, keys, vals, width):
    out = tscan.scan_window(torch.from_numpy(q),
                            torch.from_numpy(counts.astype(np.int32)),
                            torch.from_numpy(keys), torch.from_numpy(vals),
                            max_count=width)
    return [a.numpy() for a in out]


@pytest.mark.parametrize("n", [1, 130, 3000])
@pytest.mark.parametrize("width", [1, 128])
def test_scan_window_plain_matches_jax_kernel(width, n):
    keys, vals = sorted_run(n, n)
    rng = np.random.default_rng(width + n)
    q = starts_for(keys, rng, 1000)
    counts = (np.ones(q.size, np.int64) if width == 1
              else rng.integers(0, 101, size=q.size))
    counts[::17] = 0
    got = port_window(q, counts, keys, vals, width)
    ref = jax_run_kernel(q, counts, jax_prepare(keys, vals), interpret=True,
                         lane_round=width)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    valid, okeys, ovals = got
    # a start of 2^63 or above is below every key in signed order
    for i in np.nonzero(q < 0)[0]:
        assert okeys[i, 0] == (keys[0] if counts[i] else 0)
    rows = [list(zip(k[:m].tolist(), v[:m].tolist()))
            for m, k, v in zip(valid.sum(axis=1), okeys, ovals)]
    ref_rows = scan_ref(q, np.minimum(counts, width), keys, vals)
    assert rows == ref_rows
    assert tscan.scan_ref(q, np.minimum(counts, width), keys, vals) == ref_rows
    if width == 1:
        found = valid[:, 0] & (okeys[:, 0] == q)
        ref_found, ref_vals = lookup_ref(q, keys, vals)
        for a, b in zip(tscan.lookup_ref(q, keys, vals), (ref_found, ref_vals)):
            np.testing.assert_array_equal(a, b)
        ref_found &= counts > 0  # a window of 0 finds nothing
        np.testing.assert_array_equal(found, ref_found)
        np.testing.assert_array_equal(np.where(found, ovals[:, 0], 0),
                                      np.where(ref_found, ref_vals, 0))


def test_sorted_lookup_and_scan_match_oracles_with_accounting():
    keys, vals = sorted_run(5, 2000)
    rng = np.random.default_rng(5)
    q = starts_for(keys, rng, 700)
    prepared = tscan.prepare_sorted(keys, vals, device=torch.device("cpu"))
    stats = {k: 0 for k in ("fp_compares", "candidates", "fp_hits",
                            "fp_false_positives", "pm_load_words")}
    found, got = tscan.sorted_lookup(q, prepared, stats=stats)
    ref_found, ref_vals = lookup_ref(q, keys, vals)
    np.testing.assert_array_equal(found, ref_found)
    np.testing.assert_array_equal(got, ref_vals)
    assert stats["candidates"] == stats["fp_hits"] + \
        stats["fp_false_positives"]
    assert stats["fp_hits"] == int(found.sum())
    counts = rng.integers(0, 300, size=q.size)  # windows of 128 and 256
    assert tscan.sorted_scan(q, counts, prepared) == \
        scan_ref(q, counts, keys, vals)
    empty = tscan.prepare_sorted(keys[:0], vals[:0],
                                 device=torch.device("cpu"))
    assert tscan.sorted_scan(q[:5], counts[:5], empty) == [[]] * 5


def test_scan_window_cpu_runs_plain_version_and_counts_no_launch():
    keys, vals = sorted_run(6, 500)
    q = starts_for(keys, np.random.default_rng(6), 64)
    counts = np.full(q.size, 40)
    before = dict(tscan.LAUNCHES)
    got = port_window(q, counts, keys, vals, 128)
    assert tscan.LAUNCHES == before
    plain = tscan.scan_window_plain(
        torch.from_numpy(q), torch.from_numpy(counts.astype(np.int32)),
        torch.from_numpy(keys), torch.from_numpy(vals), max_count=128)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_scan_window_rejects_bad_inputs():
    keys, vals = (torch.from_numpy(a) for a in sorted_run(7, 100))
    q = keys[:8].clone()
    c = torch.ones(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tscan.scan_window(q, c.to(torch.int64), keys, vals, max_count=1)
    with pytest.raises(ValueError):
        tscan.scan_window(q, c[:-1], keys, vals, max_count=1)
    with pytest.raises(ValueError):
        tscan.scan_window(q, c, keys, vals[:-1], max_count=1)
    with pytest.raises(ValueError):
        tscan.scan_window(q, c, keys, vals, max_count=0)
    with pytest.raises(ValueError):
        tscan.scan_window(q, c, keys.view(-1, 1)[:, 0].as_strided(
            (50,), (2,)), vals[:50], max_count=1)


def run_both(js, ts, ops):
    """One plan per PLAN_OPS ops on both sessions; every PlanResult
    field must agree.  Returns the records scanned."""
    scanned = 0
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
        scanned += tr.scanned
    assert dataclasses.asdict(ts.pmem.counters) == \
        dataclasses.asdict(js.pmem.counters)
    assert dict(ts.stats) == dict(js.stats)
    assert ts.index.probe_stats == js.index.probe_stats
    return scanned


@pytest.mark.parametrize("wl", ["A", "C", "E0", "E"])
@pytest.mark.parametrize("kind", ["masstree", "P-BwTree"])
def test_ycsb_plans_match_jax(kind, wl, monkeypatch):
    widths = []

    def counted(queries, counts, keys, vals, *, max_count):
        widths.append(max_count)
        return tscan.scan_window(queries, counts, keys, vals,
                                 max_count=max_count)

    monkeypatch.setattr(tscan.ops, "scan_window", counted)
    n_load = N if kind == "masstree" else N // 2
    n_run = 600 if wl.startswith("E") else n_load
    jw = jax_generate(wl, n_load, n_run, seed=8)
    tw = generate(wl, n_load, n_run, seed=8)
    assert (tw.load_ops, tw.run_ops) == (jw.load_ops, jw.run_ops)
    js, ts = jax_open_index(kind), open_index(kind, device="cpu")
    run_both(js, ts, tw.load_ops)
    # one all-GET plan exports the snapshot, so the run phase's read
    # and scan waves probe it
    run_both(js, ts, [("lookup", k, 0) for _, k, _ in tw.load_ops])
    assert widths and set(widths) == {1}
    scanned = run_both(js, ts, tw.run_ops)
    assert ts.index.probe_stats["fp_compares"] > 0
    if wl == "E0":  # every scan wave ran the sorted-run search
        assert scanned > 0 and 128 in widths
    js.index.fingerprints = ts.index.fingerprints = False
    run_both(js, ts, [("lookup", k, 0) for _, k, _ in tw.load_ops[:400]])
