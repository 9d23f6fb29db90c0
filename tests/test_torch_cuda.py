"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device, since a CUDA kernel has no CPU form).  Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the kernels are held against their plain
PyTorch versions, which tests/test_torch_{probe,art,scan,partition,
conflict,sharded}.py hold against the JAX package on the CPU.  No tolerance: every output is an
integer.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Plan, open_index
from repro_torch.core.ycsb import generate
from repro_torch.core import PART, PHOT, PMem
from repro_torch.kernels import art_probe as kart
from repro_torch.kernels import conflict as kconf
from repro_torch.kernels import partition as kpart
from repro_torch.kernels import probe as kprobe
from repro_torch.kernels import scan as kscan
from repro_torch.kernels.probe import fp64

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda")


def random_table(rng, n_buckets, depth):
    """Random chained table and each row's chain head."""
    lengths = rng.integers(1, depth + 1, size=n_buckets)
    lengths[0] = depth
    n_rows = int(lengths.sum())
    nxt = np.full(n_rows, -1, np.int64)
    head = np.arange(n_rows)
    free = n_buckets
    for b in range(n_buckets):
        prev = b
        for _ in range(lengths[b] - 1):
            nxt[prev], head[free] = free, b
            prev, free = free, free + 1
    keys = rng.integers(1, 1 << 62, size=(n_rows, 3))
    keys[rng.random(keys.shape) < 0.25] = 0
    vals = rng.integers(1 << 31, 1 << 62, size=(n_rows, 3))
    return keys, vals, fp64(keys), nxt, head


@pytest.mark.parametrize("use_fp", [True, False])
@pytest.mark.parametrize("depth", [1, 4, 7])
def test_kernel_matches_plain_version(card, depth, use_fp):
    rng = np.random.default_rng(depth)
    keys, vals, fps, nxt, head = random_table(rng, 512, depth)
    q = rng.integers(1, 1 << 62, size=4099)  # a ragged last block
    bucket = rng.integers(0, 512, size=q.size)
    rows, slots = np.nonzero(keys)
    pick = rng.integers(rows.size, size=2000)
    q[:2000] = keys[rows[pick], slots[pick]]
    bucket[:2000] = head[rows[pick]]  # a hit probes its own chain
    q[-3:] = 0
    t = [torch.from_numpy(a).to(card)
         for a in (q, bucket, keys, vals, fps, nxt)]
    name = "probe64_fp" if use_fp else "probe64"
    before = kprobe.LAUNCHES[name]
    got = kprobe.probe_chain(*t, depth, use_fp=use_fp)
    torch.cuda.synchronize()
    assert kprobe.LAUNCHES[name] == before + 1
    plain = kprobe.probe_chain_plain(*t, depth, use_fp=use_fp)
    for g, p in zip(got, plain):
        assert (g is None) == (p is None)
        if p is not None:
            assert torch.equal(g, p)
    assert int(got[0].sum()) >= 1000


def test_main_path_on_card_equals_cpu(card):
    """YCSB load + C + A plans on the card give the results, tallies and
    probe_stats of the same plans on the CPU (plain versions)."""
    w = generate("A", 20000, 8192, seed=3)
    c = generate("C", 20000, 8192, seed=3)
    gpu, cpu = open_index("clht"), open_index("clht", device="cpu")
    before = dict(kprobe.LAUNCHES)
    for ops in (w.load_ops, c.run_ops, w.run_ops):
        for lo in range(0, len(ops), 4096):
            plan = Plan.from_ops(ops[lo:lo + 4096])
            a, b = gpu.execute(plan), cpu.execute(plan)
            assert a.results == b.results
            assert (a.wave_kinds, a.wave_widths) == (b.wave_kinds,
                                                     b.wave_widths)
            assert a.probe == b.probe
    assert gpu.index.probe_stats == cpu.index.probe_stats
    assert kprobe.LAUNCHES["probe64_fp"] > before["probe64_fp"]


def node_pages(index_cls, n, seed, device):
    """A P-ART or P-HOT index over ``n`` random keys (every 37th
    deleted), its export's node pages on ``device`` and the keys."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 62, size=n))
    idx = index_cls(PMem(seed=seed), device="cpu")
    for k in keys.tolist():
        idx.insert(k, k ^ (1 << 40))
    for k in keys[::37].tolist():
        idx.delete(k)
    unit_bits, *pages = kart.ops._prepare(idx.export_arrays(), device)
    return unit_bits, pages, keys


@pytest.mark.parametrize("index_cls", [PART, PHOT], ids=["art", "hot"])
def test_art_descend_matches_plain_version(card, index_cls):
    unit_bits, pages, keys = node_pages(index_cls, 6000, 1, card)
    rng = np.random.default_rng(2)
    q = rng.integers(1, 1 << 62, size=4099)  # a ragged last block
    q[:2000] = rng.choice(keys, 2000)
    q[2000:2500] = rng.choice(keys, 500) ^ 0x100  # same leaf, same fp
    q[-4:] = [0, -(1 << 63), -1, keys[0] | -(1 << 63)]
    qt = torch.from_numpy(q).to(card)
    before = kart.LAUNCHES["art_descend"]
    got = kart.art_descend(qt, *pages, unit_bits=unit_bits)
    torch.cuda.synchronize()
    assert kart.LAUNCHES["art_descend"] == before + 1
    plain = kart.descend_plain(qt, *pages, unit_bits=unit_bits)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert int(got[0].sum()) >= 1900 and int(got[4].sum()) > 0


@pytest.mark.parametrize("width", [1, 128])
def test_scan_window_matches_plain_version(card, width):
    rng = np.random.default_rng(width)
    keys = np.unique(rng.integers(1, 1 << 62, size=50000))
    vals = rng.integers(1, 1 << 62, size=keys.size)
    q = rng.integers(1, 1 << 62, size=4099)
    q[:2000] = rng.choice(keys, 2000)
    q[-4:] = [0, -(1 << 63), -1, keys[-1] + 1]
    counts = rng.integers(0, 101, size=q.size).astype(np.int32)
    t = [torch.from_numpy(a).to(card) for a in (q, counts, keys, vals)]
    before = kscan.LAUNCHES["scan_window"]
    got = kscan.scan_window(*t, max_count=width)
    torch.cuda.synchronize()
    assert kscan.LAUNCHES["scan_window"] == before + 1
    plain = kscan.scan_window_plain(*t, max_count=width)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    # a start of 2^63 or above is below every key in signed order
    assert int(got[1][-3, 0]) == (int(keys[0]) if counts[-3] else 0)


@pytest.mark.parametrize("kind", ["art", "hot", "masstree", "bwtree"])
def test_ordered_kinds_on_card_equal_cpu(card, kind):
    """YCSB load + C + E0 plans on the card give the results, tallies
    and probe_stats of the same plans on the CPU (plain versions)."""
    c = generate("C", 6000, 4096, seed=4)
    e0 = generate("E0", 6000, 1024, seed=4)
    gpu, cpu = open_index(kind), open_index(kind, device="cpu")
    before = {**kart.LAUNCHES, **kscan.LAUNCHES}
    for ops, force in ((c.load_ops, False), (c.run_ops[:1024], True),
                       (c.run_ops, False), (e0.run_ops, False)):
        for lo in range(0, len(ops), 1024):
            plan = Plan.from_ops(ops[lo:lo + 1024])
            a = gpu.execute(plan, force_kernel=force)
            b = cpu.execute(plan, force_kernel=force)
            assert a.results == b.results
            assert (a.wave_kinds, a.wave_widths) == (b.wave_kinds,
                                                     b.wave_widths)
            assert a.probe == b.probe
    assert gpu.index.probe_stats == cpu.index.probe_stats
    name = "art_descend" if kind in ("art", "hot") else "scan_window"
    after = {**kart.LAUNCHES, **kscan.LAUNCHES}
    assert after[name] > before[name]
    assert after["scan_window"] > before["scan_window"]  # E0's scans


HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern


@pytest.mark.parametrize("scheme", ["hash", "prefix", "prefix@58",
                                    "prefix@5"])
def test_shard_route_matches_plain_version(card, scheme):
    rng = np.random.default_rng(11)
    keys = rng.integers(HIGH, (1 << 63) - 1, size=4099, dtype=np.int64)
    keys[:6] = [0, 1, HIGH, -1, (1 << 63) - 1, 1 << 62]
    kt = torch.from_numpy(keys).to(card)
    for n_shards in (1, 2, 4, 8, 32, 64):
        if scheme == "prefix@5" and n_shards > 64:
            continue
        bits, shift = kpart.route_params(n_shards, scheme)
        before = kpart.LAUNCHES["shard_route"]
        got = kpart.shard_route(kt, bits=bits, shift=shift)
        torch.cuda.synchronize()
        assert kpart.LAUNCHES["shard_route"] == before + 1
        assert torch.equal(got, kpart.shard_route_plain(kt, bits=bits,
                                                        shift=shift))
        assert np.array_equal(got.cpu().numpy(),
                              kpart.route_ref(keys, n_shards, scheme))
    empty = kpart.shard_route(kt[:0], bits=3, shift=-1)
    assert empty.shape == (0,)


@pytest.mark.parametrize("writes_conflict", [False, True])
@pytest.mark.parametrize("n_a,n_b", [(1, 1), (4099, 1), (300, 5000),
                                     (4096, 12288), (7, 0)])
def test_conflict_any_matches_plain_version(card, n_a, n_b,
                                            writes_conflict):
    rng = np.random.default_rng(n_a + n_b)
    pool = rng.integers(HIGH, (1 << 63) - 1, size=max(64, n_b // 4))
    pool[:4] = [0, HIGH, -1, (1 << 63) - 1]
    ka = rng.integers(0, 5, size=n_a).astype(np.int32)
    kb = rng.integers(0, 5, size=n_b).astype(np.int32)
    kb[kb == 4] = 1  # few scans, or every write conflicts
    xa, xb = rng.choice(pool, n_a), rng.choice(pool, n_b)
    t = [torch.from_numpy(a).to(card) for a in (ka, xa, kb, xb)]
    before = kconf.LAUNCHES["conflict_any"]
    got = kconf.kernel.conflict_any(*t, writes_conflict=writes_conflict)
    torch.cuda.synchronize()
    assert kconf.LAUNCHES["conflict_any"] == before + (n_b > 0)
    plain = kconf.conflict_any_plain(*t, writes_conflict=writes_conflict)
    assert torch.equal(got, plain)
    ref = kconf.conflict_any_ref(ka, xa, kb, xb,
                                 writes_conflict=writes_conflict)
    assert np.array_equal(got.cpu().numpy(), ref)
    if n_b:
        assert 0 < int(got.sum()) < n_a or n_a == 1


@pytest.mark.parametrize("width", [1, 128])
def test_scan_window_rows_matches_plain_version(card, width):
    rng = np.random.default_rng(width + 7)
    runs = [np.unique(rng.integers(HIGH, (1 << 63) - 1, size=n))
            for n in (5000, 0, 1, 20000, 300, 7, 0, 9000)]
    offsets = np.concatenate([[0], np.cumsum([r.size for r in runs])])
    keys = np.concatenate(runs)
    vals = rng.integers(1, 1 << 62, size=keys.size)
    shard = rng.integers(0, len(runs), size=4099)
    q = rng.integers(HIGH, (1 << 63) - 1, size=shard.size)
    for i in range(0, 2000):
        if runs[shard[i]].size:
            q[i] = rng.choice(runs[shard[i]])
    q[-4:] = [0, HIGH, -1, (1 << 63) - 1]
    counts = rng.integers(0, 101, size=q.size).astype(np.int32)
    base = offsets[:-1][shard]
    length = offsets[1:][shard] - base
    t = [torch.from_numpy(a).to(card)
         for a in (q, counts, base, length, keys, vals)]
    before = dict(kscan.LAUNCHES)
    got = kscan.scan_window_rows(*t, max_count=width)
    torch.cuda.synchronize()
    assert kscan.LAUNCHES["scan_window_sharded"] == \
        before["scan_window_sharded"] + 1
    assert kscan.LAUNCHES["scan_window"] == before["scan_window"]
    plain = kscan.scan_window_rows_plain(*t, max_count=width)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    assert int((got[0][:, 0] & (got[1][:, 0] == t[0])).sum()) >= 1000


def test_sharded_session_on_card_equals_cpu(card):
    """Sharded P-CLHT plans on the card (routing, mesh reads, stream
    admission) give the results and tallies of the same plans on the
    CPU, and launch the three scale-out kernels."""
    w = generate("A", 20000, 8192, seed=5)
    c = generate("C", 20000, 8192, seed=5)
    gpu = open_index("clht", shards=8, mesh_reads=True)
    cpu = open_index("clht", shards=8, mesh_reads=True, device="cpu")
    before = {**kpart.LAUNCHES, **kconf.LAUNCHES, **kscan.LAUNCHES}
    for ops in (w.load_ops, c.run_ops, w.run_ops):
        for lo in range(0, len(ops), 4096):
            plan = Plan.from_ops(ops[lo:lo + 4096])
            a, b = gpu.execute(plan), cpu.execute(plan)
            assert a.results == b.results
            assert (a.found, a.acked, a.mesh) == (b.found, b.acked, b.mesh)
    drivers = [s.streams(4) for s in (gpu, cpu)]
    for d in drivers:
        for i in range(8):
            d.streams[i % 4].submit(Plan.from_ops(
                w.run_ops[1024 * i:1024 * (i + 2)]))
        d.run()
    assert drivers[0].stats["deferred_plans"] == \
        drivers[1].stats["deferred_plans"] > 0
    assert sorted(gpu.items()) == sorted(cpu.items())
    after = {**kpart.LAUNCHES, **kconf.LAUNCHES, **kscan.LAUNCHES}
    for name in ("shard_route", "conflict_any", "scan_window_sharded"):
        assert after[name] > before[name], name
