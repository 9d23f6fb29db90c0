"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device, since a CUDA kernel has no CPU form).  Run on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX: the kernels are held against their plain
PyTorch versions, which tests/test_torch_{probe,art,scan,partition,
conflict,sharded,attention}.py hold against the JAX package on the CPU.
The index kernels have no tolerance: every output is an integer.  The
two attention kernels and their plain versions do the same fp32
arithmetic in another order: float32 outputs agree within 1e-5, and
bfloat16 outputs (the same fp32 value rounded once) within 2e-2, one
bf16 step at the outputs' magnitude.  The WKV6 kernel sums its chunked
form in fp32 where the plain version runs the step-by-step recurrence:
float32 outputs and every final state agree within 2e-5 of their
largest magnitude, and bfloat16 outputs elementwise within 4 bf16 unit
roundoffs (2^-8) of the plain value plus 4 * 2^-16 of the largest.  The
SSD kernel does the same for the Mamba-2 scan (its chunked form against
the step-by-step recurrence), held to the same limits.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import Plan, open_index
from repro_torch.configs import get_arch
from repro_torch.core.ycsb import generate
from repro_torch.core import PART, PHOT, PMem
from repro_torch.kernels import art_probe as kart
from repro_torch.kernels import clht_probe as ktag
from repro_torch.kernels import conflict as kconf
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import mamba_scan as kssd
from repro_torch.kernels import paged_attention as kpaged
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels import partition as kpart
from repro_torch.kernels import probe as kprobe
from repro_torch.kernels import rwkv6_scan as kwkv
from repro_torch.kernels import scan as kscan
from repro_torch.kernels.probe import fp64
from repro_torch.models import LM
from repro_torch.serving import Server

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
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6, 7, 8, 64])
def test_kernel_matches_plain_version(card, depth, use_fp):
    """Chains longer than one group of lines, probes from overflow rows,
    a ragged last block, key 0 and values of 2^32 and above."""
    rng = np.random.default_rng(depth)
    keys, vals, fps, nxt, head = random_table(rng, 512, depth)
    q = rng.integers(1, 1 << 62, size=4099)  # a ragged last block
    bucket = rng.integers(0, 512, size=q.size)
    rows, slots = np.nonzero(keys)
    pick = rng.integers(rows.size, size=3000)
    q[:3000] = keys[rows[pick], slots[pick]]
    bucket[:2000] = head[rows[pick[:2000]]]  # a hit probes its own chain
    bucket[2000:3000] = rows[pick[2000:]]   # ... or starts at its own row
    bucket[3000:3500] = rng.integers(0, keys.shape[0], size=500)
    q[-3:] = 0
    lines, table_depth = kprobe.pack_lines(keys, vals, fps, nxt, device=card)
    assert table_depth == depth
    qt, bt = (torch.from_numpy(a).to(card) for a in (q, bucket))
    name = "probe64_fp" if use_fp else "probe64"
    before = kprobe.LAUNCHES[name]
    got = kprobe.probe_chain(qt, bt, lines, depth, use_fp=use_fp)
    torch.cuda.synchronize()
    assert kprobe.LAUNCHES[name] == before + 1
    plain = kprobe.probe_chain_plain(qt, bt, lines, depth, use_fp=use_fp)
    for g, p in zip(got, plain):
        assert (g is None) == (p is None)
        if p is not None:
            assert torch.equal(g, p)
    found = got[0].cpu().numpy()
    assert found[:3000].all()
    assert (got[1].cpu().numpy()[:3000] >= 1 << 32).any()


def test_probe_rejects_a_misaligned_table(card):
    rng = np.random.default_rng(9)
    keys, vals, fps, nxt, _ = random_table(rng, 64, 3)
    lines, depth = kprobe.pack_lines(keys, vals, fps, nxt, device=card)
    buf = torch.empty(lines.numel() + 1, dtype=torch.int64, device=card)
    shifted = buf[1:].view(lines.shape)
    shifted.copy_(lines)
    q = torch.from_numpy(keys[:, 0].copy()).to(card)
    b = torch.arange(q.numel(), device=card)
    before = dict(kprobe.LAUNCHES)
    with pytest.raises(ValueError, match="aligned"):
        kprobe.probe_chain(q, b, shifted, depth, use_fp=True)
    assert kprobe.LAUNCHES == before


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
    deleted, unless it is the only one), its export's node pages on
    ``device`` and the keys."""
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 1 << 62, size=n))
    idx = index_cls(PMem(seed=seed), device="cpu")
    for k in keys.tolist():
        idx.insert(k, k ^ (1 << 40))
    for k in keys[::37].tolist() if n > 1 else []:
        idx.delete(k)
    unit_bits, *pages = kart.ops._prepare(idx.export_arrays(), device)
    return unit_bits, pages, keys


@pytest.mark.parametrize("n_keys", [4096, 1])
@pytest.mark.parametrize("index_cls", [PART, PHOT], ids=["art", "hot"])
def test_art_descend_matches_plain_version(card, index_cls, n_keys):
    """2^12 keys, and a one-key tree whose root is its leaf."""
    unit_bits, pages, keys = node_pages(index_cls, n_keys, 1, card)
    assert (pages[1] >> 4 == 1) == (n_keys == 1)  # the root's leaf bit
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


@pytest.mark.parametrize("unit_bits", [8, 4])
def test_pack_entries_matches_plain_version(card, unit_bits):
    """The per-epoch packing of the child entries: children in range,
    -1, other negatives and rows past the table, on the card and by the
    plain version on the CPU."""
    rng = np.random.default_rng(unit_bits)
    n = 70000
    children = rng.integers(-3, n + 3, size=(n, 1 << unit_bits)).astype(
        np.int32)
    hdr = rng.integers(0, 32, size=n).astype(np.int32)
    want = torch.from_numpy(children.copy())
    kart.ref.pack_entries_plain(want, torch.from_numpy(hdr))
    got = torch.from_numpy(children.copy()).to(card)
    before = kart.LAUNCHES["art_pack_entries"]
    kart.kernel.pack_entries(got, torch.from_numpy(hdr).to(card))
    torch.cuda.synchronize()
    assert kart.LAUNCHES["art_pack_entries"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert int((want == -1).sum()) > (children < 0).sum()


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


@pytest.mark.parametrize("width", [1, 2, 33, 128])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 34, 1089, 1090, 1 << 18])
def test_scan_window_edge_runs_match_plain_version(card, n, width):
    """The 33-way search at the run lengths where its rounds change (32,
    33, 1089, 1090), on empty and one-entry runs and at P-Masstree's
    2^18; negative keys, starts below and above the run, key 0, -1 and
    keys of 2^63 and above, counts of 0; windows of 1 (the entry taken
    by shuffle from the last round), 2, 33 and 128."""
    rng = np.random.default_rng(n + width)
    keys = np.unique(rng.integers(-(1 << 62), 1 << 62, size=n + 16))
    keys = np.sort(rng.choice(keys, n, replace=False)).astype(np.int64)
    vals = rng.integers(1, 1 << 62, size=n)
    q = rng.integers(HIGH, (1 << 63) - 1, size=4099)
    if n:
        q[:2000] = rng.choice(keys, 2000)
        q[2000:2500] = rng.choice(keys, 500) + 1
        q[2500:2504] = [keys[0] - 1, keys[0], keys[-1], keys[-1] + 1]
    q[-5:] = [0, -1, HIGH, HIGH + 1, (1 << 63) - 1]
    counts = rng.integers(0, width + 1, size=q.size).astype(np.int32)
    counts[::9] = 0
    t = [torch.from_numpy(a).to(card) for a in (q, counts, keys, vals)]
    before = kscan.LAUNCHES["scan_window"]
    by_width = kscan.WINDOWS["scan_window"].get(width, 0)
    got = kscan.scan_window(*t, max_count=width)
    torch.cuda.synchronize()
    assert kscan.LAUNCHES["scan_window"] == before + 1
    assert kscan.WINDOWS["scan_window"][width] == by_width + 1
    plain = kscan.scan_window_plain(*t, max_count=width)
    for g, p in zip(got, plain):
        assert torch.equal(g, p)


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
    if kind in ("art", "hot"):  # each export's child entries packed
        assert after["art_pack_entries"] > before["art_pack_entries"]


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


@pytest.mark.parametrize("scheme", ["hash", "prefix", "prefix@58"])
@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 65537])
def test_shard_partition_matches_plain_version(card, n, scheme):
    """Both forms (one cluster of 8 blocks at n <= 4096 and S <= 128,
    tiles otherwise),
    1 to 2^12 shards, keys 0, -1, 2^63 and 2^63 - 1 among random ones:
    bit-identical to the plain version and to the numpy partition, one
    launch counted a call; 2^13 shards raise."""
    rng = np.random.default_rng(n + 3)
    keys = rng.integers(HIGH, (1 << 63) - 1, size=n, dtype=np.int64)
    keys[: n // 2] = rng.integers(1, 1 << 62, size=n // 2)
    keys[:4] = [0, -1, HIGH, (1 << 63) - 1][:min(n, 4)]
    kt = torch.from_numpy(keys).to(card)
    for bits in range(13):
        b, shift = kpart.route_params(1 << bits, scheme)
        before = kpart.LAUNCHES["shard_partition"]
        got = kpart.shard_partition(kt, bits=b, shift=shift)
        torch.cuda.synchronize()
        assert kpart.LAUNCHES["shard_partition"] == before + 1
        plain = kpart.shard_partition_plain(kt, bits=b, shift=shift)
        for g, p in zip(got, plain):
            assert torch.equal(g, p), bits
        shards, order, offsets = kpart.partition_ref(keys, 1 << bits, scheme)
        assert np.array_equal(got[0].cpu().numpy(), shards)
        assert np.array_equal(got[1].cpu().numpy(), order)
        assert np.array_equal(got[2].cpu().numpy(), offsets)
    with pytest.raises(ValueError, match="P2"):
        kpart.shard_partition(kt, bits=13, shift=-1)


@pytest.mark.parametrize("writes_conflict", [False, True])
@pytest.mark.parametrize("n_a,n_b", [(1, 1), (4099, 1), (64, 7),
                                     (300, 5000), (4096, 12288),
                                     (9000, 12289), (4096, 65536),
                                     (300, 65537), (7, 0)])
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


@pytest.mark.parametrize("writes_conflict", [False, True])
@pytest.mark.parametrize("n_b", [1, 7, 12288, 65536, 65537])
@pytest.mark.parametrize("case", ["edges", "no-scan", "no-write",
                                  "gets-only", "duplicates"])
def test_conflict_any_edge_sets_match_plain_version(card, case, n_b,
                                                    writes_conflict):
    """Reference sets of 1 op to 65537 on keys 0, -1, INT64_MIN and
    INT64_MAX, with no SCAN, no write or only GETs, and of one key many
    times over, as a GET and as a write."""
    rng = np.random.default_rng(n_b + len(case))
    edges = np.array([0, -1, HIGH, (1 << 63) - 1, 1], np.int64)
    pool = np.concatenate([edges, rng.integers(HIGH, (1 << 63) - 1,
                                               size=max(8, n_b // 3))])
    kinds_b = {"no-scan": (0, 1, 2, 3, 5), "no-write": (0, 4, 5),
               "gets-only": (0,)}.get(case, (0, 1, 2, 3, 4, 5))
    ka = rng.integers(0, 6, size=4096).astype(np.int32)
    kb = rng.choice(np.array(kinds_b, np.int32), size=n_b)
    xa, xb = rng.choice(pool, ka.size), rng.choice(pool, n_b)
    if case == "edges":
        xa[::2] = np.resize(edges, xa[::2].size)
        xb[:] = np.resize(edges, n_b)
    if case == "duplicates":
        xb[:] = xa[3]
    t = [torch.from_numpy(a).to(card) for a in (ka, xa, kb, xb)]
    before = kconf.LAUNCHES["conflict_any"]
    got = kconf.kernel.conflict_any(*t, writes_conflict=writes_conflict)
    torch.cuda.synchronize()
    assert kconf.LAUNCHES["conflict_any"] == before + 1
    assert torch.equal(got, kconf.conflict_any_plain(
        *t, writes_conflict=writes_conflict))
    assert np.array_equal(got.cpu().numpy(), kconf.conflict_any_ref(
        ka, xa, kb, xb, writes_conflict=writes_conflict))


@pytest.mark.parametrize("width", [1, 128])
def test_scan_window_rows_matches_plain_version(card, width):
    rng = np.random.default_rng(width + 7)
    runs = [np.unique(rng.integers(HIGH, (1 << 63) - 1, size=n))
            for n in (5000, 0, 1, 20000, 300, 7, 0, 9000, 32, 33, 1089,
                      1090, 1 << 17)]
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
            routed = kpart.LAUNCHES["shard_partition"]
            a, b = gpu.execute(plan), cpu.execute(plan)
            assert kpart.LAUNCHES["shard_partition"] == routed + 1
            assert a.results == b.results
            assert (a.found, a.acked, a.mesh) == (b.found, b.acked, b.mesh)
            assert a.shard_ops == b.shard_ops
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
    for name in ("shard_partition", "conflict_any", "scan_window_sharded"):
        assert after[name] > before[name], name
    assert after["shard_route"] == before["shard_route"]
    ids = gpu.index.route(np.array([k for _, k, _ in c.load_ops[:999]],
                                   np.int64))
    assert kpart.LAUNCHES["shard_route"] == after["shard_route"] + 1
    assert ids.dtype == np.int32 and int(ids.max()) < 8


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def normal(rng, shape, dtype, device):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,Hk,dh,causal,window", [
    (1, 256, 256, 14, 2, 64, True, None),   # Qwen2-0.5B prefill
    (1, 512, 512, 14, 2, 64, True, None),
    (2, 37, 37, 4, 2, 32, True, None),      # ragged T, reduced widths
    (2, 100, 300, 8, 8, 128, True, None),   # right-aligned queries
    (1, 200, 200, 4, 1, 64, True, 48),      # sliding window
    (1, 70, 90, 4, 2, 64, False, None),
    (1, 1, 1, 4, 1, 32, True, None),        # the hybrid's prompts of 1
    (1, 8, 8, 4, 1, 32, True, None),        # and 8 tokens
    (1, 63, 63, 4, 2, 64, True, None),      # a query tile's edges
    (1, 64, 64, 4, 2, 64, True, None),
    (1, 65, 65, 4, 2, 64, True, None),
    (2, 129, 129, 4, 2, 64, True, None),
    (1, 129, 129, 4, 2, 128, True, None),
    (2, 65, 200, 4, 1, 32, True, 70),       # window, ragged key tile
    (1, 100, 40, 4, 2, 64, True, None),     # T > S: 60 rows see no key
    (2, 150, 20, 2, 1, 128, True, None),
    (1, 90, 30, 4, 4, 32, True, None),
])
def test_flash_attention_matches_plain_version(card, B, T, S, H, Hk, dh,
                                               causal, window, dtype):
    rng = np.random.default_rng(T + S + dh)
    q = normal(rng, (B, T, H, dh), dtype, card)
    k, v = (normal(rng, (B, S, Hk, dh), dtype, card) for _ in range(2))
    before = kflash.LAUNCHES["flash_attention"]
    got = kflash.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kflash.LAUNCHES["flash_attention"] == before + 1
    plain = kflash.attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - plain.float()).abs().max())
    assert err < ATTN_TOL[dtype], err
    if causal and T > S:  # rows i < T - S see no key: exactly 0
        assert torch.equal(got[:, :T - S], torch.zeros_like(got[:, :T - S]))


# chip_smoke.py's elementwise limit for the bf16 attention kernels: each
# element within ATTN_STEPS bf16 unit roundoffs (2^-8) of its plain
# value, plus as many of 2^-8 of the largest magnitude
ATTN_STEPS = 4


def attn_limit(plain):
    p = plain.float().abs()
    return ATTN_STEPS * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())


def test_flash_attention_bf16_within_attn_steps(card):
    """Qwen2-0.5B's prefill at T = 512 in bf16, held elementwise to
    chip_smoke.py's limit: a P rounded once to bf16 before P.V would
    not be the fp32 P.V of the plain version."""
    rng = np.random.default_rng(512)
    q = normal(rng, (1, 512, 14, 64), torch.bfloat16, card)
    k, v = (normal(rng, (1, 512, 2, 64), torch.bfloat16, card)
            for _ in range(2))
    got = kflash.flash_attention(q, k, v)
    plain = kflash.attention_plain(q, k, v)
    diff = (got.float() - plain.float()).abs()
    assert bool((diff <= attn_limit(plain)).all()), \
        float((diff / attn_limit(plain)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,H,Hk,dh,NP,PS,MAXP,edges", [
    (1, 14, 2, 64, 40, 16, 34, False),   # Qwen2-0.5B decode over 544 slots
    (3, 4, 4, 64, 16, 32, 4, False),
    (2, 4, 2, 32, 9, 16, 4, False),      # reduced widths
    (4, 8, 2, 128, 32, 64, 8, False),
    (1, 14, 2, 64, 40, 16, 34, True),    # Qwen2: G = 7, 8 splits of 5 pages
    (1, 4, 1, 32, 40, 16, 34, True),     # the hybrid at reduced(): G = 4
    (1, 8, 8, 128, 16, 64, 8, True),     # G = 1
    (4, 14, 2, 64, 160, 16, 34, True),   # 4 sequences, different lens
    (2, 64, 1, 64, 40, 16, 20, True),    # G = 64: two head groups
])
def test_paged_attention_matches_plain_version(card, B, H, Hk, dh, NP, PS,
                                               MAXP, edges, dtype):
    """Pages out of order, -1 entries past the live pages, a sequence of
    length 0 (zeros) and one at MAXP * PS.  With ``edges`` the lens sit
    at the kernel's split edges (``split_plan``): 0, 1, a split
    boundary and one either side, MAXP * PS - 1 and MAXP * PS, each
    sequence of the batch at one of them, over as many calls as that
    takes."""
    rng = np.random.default_rng(B * H + dh)
    q = normal(rng, (B, H, dh), dtype, card)
    pk, pv = (normal(rng, (NP, PS, Hk, dh), dtype, card) for _ in range(2))
    table = rng.integers(0, NP, size=(B, MAXP)).astype(np.int32)
    if NP >= MAXP:
        table[0] = rng.permutation(NP)[:MAXP]
    lens = rng.integers(1, PS * MAXP, size=B).astype(np.int32)
    lens[0] = PS * MAXP
    if B > 1:
        lens[1] = 0
        table[1:, -1] = -1
        lens[2:] = np.minimum(lens[2:], PS * (MAXP - 1))
    calls = [lens]
    if edges:
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        pages, n_splits = kpaged.split_plan(MAXP, B, H, Hk, sms)
        assert n_splits > 1
        table[:, -1] = rng.integers(0, NP, size=B)  # every page live
        edge = pages * PS
        want = [0, 1, edge - 1, edge, edge + 1, PS * MAXP - 1, PS * MAXP]
        want += [PS * MAXP] * (-len(want) % B)
        calls = [np.array(want[i:i + B], np.int32)
                 for i in range(0, len(want), B)]
    tt = torch.from_numpy(table).to(card)
    for lens in calls:
        lt = torch.from_numpy(lens).to(card)
        before = kpaged.LAUNCHES["paged_attention"]
        got = kpaged.paged_mqa(q, pk, pv, tt, lt)
        torch.cuda.synchronize()
        assert kpaged.LAUNCHES["paged_attention"] == before + 1
        plain = kpaged.paged_attention_plain(q, pk, pv, tt, lt)
        assert torch.isfinite(got.float()).all()
        err = float((got.float() - plain.float()).abs().max())
        assert err < ATTN_TOL[dtype], (lens, err)
        for b in np.flatnonzero(lens == 0):
            assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_paged_attention_every_split_count(card, monkeypatch, splits,
                                           dtype):
    """Qwen2-0.5B's decode shape at each split count the kernel takes
    (the plan chosen by a patched ``split_plan``): the split plan
    changes the order of the sums, not the result."""
    rng = np.random.default_rng(splits)
    q = normal(rng, (2, 14, 64), dtype, card)
    pk, pv = (normal(rng, (68, 16, 2, 64), dtype, card) for _ in range(2))
    table = torch.arange(68, dtype=torch.int32, device=card).reshape(2, 34)
    lens = torch.tensor([529, 17], dtype=torch.int32, device=card)
    monkeypatch.setattr(paged_kernel, "split_plan",
                        lambda maxp, *_: (-(-maxp // splits), splits))
    got = kpaged.paged_attention(q, pk, pv, table, lens)
    plain = kpaged.paged_attention_plain(q, pk, pv, table, lens)
    err = float((got.float() - plain.float()).abs().max())
    assert err < ATTN_TOL[dtype], err


def test_paged_attention_long_table_in_one_split(card, monkeypatch):
    """A table of 32768 pages in one split (fp32, dh 128, the most
    shared memory a block takes): the kernel reads the table from
    device memory, so its length has no limit."""
    rng = np.random.default_rng(32768)
    MAXP, PS = 32768, 16
    q = normal(rng, (2, 4, 128), torch.float32, card)
    pk, pv = (normal(rng, (64, PS, 1, 128), torch.float32, card)
              for _ in range(2))
    table = torch.from_numpy(
        rng.integers(0, 64, size=(2, MAXP)).astype(np.int32)).to(card)
    lens = torch.tensor([MAXP * PS, 1000], dtype=torch.int32, device=card)
    monkeypatch.setattr(paged_kernel, "split_plan",
                        lambda maxp, *_: (maxp, 1))
    got = kpaged.paged_attention(q, pk, pv, table, lens)
    plain = kpaged.paged_attention_plain(q, pk, pv, table, lens)
    err = float((got - plain).abs().max())
    assert err < ATTN_TOL[torch.float32], err


def test_attention_kernels_raise_and_never_fall_back(card):
    """A head width the kernels are not built for raises on the card
    (the plain versions take any width, on the CPU only)."""
    q = torch.zeros(1, 8, 2, 48, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        kflash.flash_attention(q, q, q)
    qd = torch.zeros(1, 2, 48, device=card)
    pages = torch.zeros(2, 16, 2, 48, device=card)
    table = torch.zeros(1, 2, dtype=torch.int32, device=card)
    lens = torch.ones(1, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="head_dim"):
        kpaged.paged_attention(qd, pages, pages, table, lens)


def test_full_width_server_on_card(card):
    """Qwen2-0.5B at full width serves two requests sharing a prefix on
    the card, blocking and pipelined alike, through both attention
    kernels and never through their plain versions."""
    cfg = get_arch("qwen2-0.5b")
    lm = LM(cfg, seed=0)
    assert lm.device.type == "cuda"
    rng = np.random.default_rng(0)
    prefix = rng.integers(1, cfg.vocab, 32).tolist()
    prompts = [prefix + rng.integers(1, cfg.vocab, n).tolist()
               for n in (40, 75)]
    before = {**kflash.LAUNCHES, **kpaged.LAUNCHES}
    outs = []
    for pipelined in (False, True):
        server = Server(lm, page_size=16, n_pages=64)
        assert server.kv.table.device.type == "cuda"
        for p in prompts:
            server.submit(p, max_new=6)
        reqs = list(server.queue)
        server.run_until_drained(max_len=128, pipelined=pipelined)
        assert all(r.done and len(r.out) == 6 for r in reqs)
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
        assert server.stats["prefix_hits"] == 32
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert kflash.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 2 * 2 * cfg.n_layers
    assert kpaged.LAUNCHES["paged_attention"] == \
        before["paged_attention"] + 2 * 2 * 5 * cfg.n_layers


def wkv_inputs(rng, B, T, H, dh, dtype, device, strong=False):
    """r, k, v in ``dtype``, logw fp32 (down to -8 when ``strong``), u
    and a carried state fp32."""
    r, k, v = (normal(rng, (B, T, H, dh), dtype, device) for _ in range(3))
    lo, hi = (0.5, 8.0) if strong else (0.001, 0.15)
    logw = -torch.from_numpy(rng.uniform(lo, hi, size=(B, T, H, dh))
                             .astype(np.float32)).to(device)
    u = normal(rng, (H, dh), torch.float32, device)
    state = normal(rng, (B, H, dh, dh), torch.float32, device)
    return r, k, v, logw, u, state


# the bf16 prefill takes chunks of CHUNK steps; T = 1 is the decode path
CHUNK = 64


@pytest.mark.parametrize("B,T,H,dh,dtype,strong,carried", [
    (1, 512, 64, 64, torch.bfloat16, False, False),  # RWKV6-7B prefill
    (1, 1, 64, 64, torch.bfloat16, False, True),     # RWKV6-7B decode
    (1, 512, 64, 64, torch.bfloat16, True, False),
    (2, 37, 4, 32, torch.float32, False, True),      # ragged T, reduced
    (1, 300, 2, 128, torch.float32, True, True),
    (3, 16, 3, 64, torch.float32, False, False),
    # decode at B = 2 and 4, both dtypes, every head dim
    *[(B, 1, 3, dh, dtype, B == 4, True) for B in (2, 4)
      for dtype in (torch.float32, torch.bfloat16) for dh in (32, 64, 128)],
    # around the chunk: C - 1, C, C + 1 and 2C + 1 (strong decays there)
    (1, CHUNK - 1, 3, 64, torch.bfloat16, False, True),
    (2, CHUNK, 2, 32, torch.bfloat16, False, False),
    (1, CHUNK + 1, 2, 128, torch.bfloat16, False, True),
    (2, 2 * CHUNK + 1, 3, 64, torch.bfloat16, True, True),
    (1, 2 * CHUNK + 1, 2, 64, torch.float32, True, True),
    (1, 32, 64, 64, torch.bfloat16, False, False),   # RWKV's 32-token prompt
])
def test_wkv6_matches_plain_version(card, B, T, H, dh, dtype, strong,
                                    carried):
    rng = np.random.default_rng(T + H + dh)
    r, k, v, logw, u, state = wkv_inputs(rng, B, T, H, dh, dtype, card,
                                         strong)
    state = state if carried else None
    before = kwkv.LAUNCHES["wkv6"]
    got, got_state = kwkv.wkv6(r, k, v, logw, u, state)
    torch.cuda.synchronize()
    assert kwkv.LAUNCHES["wkv6"] == before + 1
    plain, plain_state = kwkv.wkv6_plain(r, k, v, logw, u, state)
    assert got.dtype == dtype and got.shape == r.shape
    assert torch.isfinite(got.float()).all()
    assert torch.isfinite(got_state).all()
    scale = float(plain_state.abs().max())
    assert float((got_state - plain_state).abs().max()) <= 2e-5 * scale
    diff = (got.float() - plain.float()).abs()
    p = plain.float().abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5 * float(p.max())
    else:
        limit = 4 * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())
        assert bool((diff <= limit).all())
    if carried:  # the state is read: dropping it breaks the limit
        dropped, _ = kwkv.wkv6_plain(r, k, v, logw, u)
        assert float((dropped.float() - plain.float()).abs().max()) > \
            1e-2 * float(p.max())


def test_wkv6_raises_and_never_falls_back(card):
    rng = np.random.default_rng(0)
    r, k, v, logw, u, _ = wkv_inputs(rng, 1, 4, 2, 48, torch.float32, card)
    with pytest.raises(ValueError, match="head_dim"):
        kwkv.wkv6(r, k, v, logw, u)
    r, k, v, logw, u, _ = wkv_inputs(rng, 1, 4, 2, 32, torch.float32, card)
    with pytest.raises(TypeError, match="float32 logw"):
        kwkv.wkv6(r, k, v, logw.double(), u)


@pytest.mark.parametrize("Q,W", [(4096, 128), (4099, 128), (1, 128),
                                 (300, 12), (77, 37), (5, 1)])
def test_clht_probe_matches_plain_version(card, Q, W):
    """Repeated keys (the first hit wins), zero lanes and query 0."""
    rng = np.random.default_rng(Q + W)
    bk = rng.integers(0, 50, size=(Q, W)).astype(np.int32)
    bv = rng.integers(-(1 << 31), 1 << 31, size=(Q, W)).astype(np.int32)
    q = rng.integers(0, 60, size=Q).astype(np.int32)
    args = [torch.from_numpy(a).to(card) for a in (q, bk, bv)]
    before = ktag.LAUNCHES["clht_probe"]
    found, vals = ktag.clht_probe(*args)
    torch.cuda.synchronize()
    assert ktag.LAUNCHES["clht_probe"] == before + 1
    pf, pv = ktag.probe_plain(*args)
    assert torch.equal(found, pf) and torch.equal(vals, pv)
    assert found.dtype == torch.bool and vals.dtype == torch.int32


def test_tag_lookup_on_card_equals_numpy(card):
    """A chained table of 2^12 buckets, hits, misses, colliding tags and
    query 0, through the card's front end and kernel."""
    rng = np.random.default_rng(3)
    n_buckets = 1 << 12
    tags = rng.integers(-(1 << 31), 1 << 31, size=3 * n_buckets)
    tags = tags.astype(np.int32)
    tags[-100:] = tags[:100]
    values = rng.integers(1, 1 << 31, size=tags.shape[0]).astype(np.int32)
    keys, vals, nxt = ktag.tag_table_np(tags, values, n_buckets)
    q = np.concatenate([tags[:3000], rng.integers(
        -(1 << 31), 1 << 31, size=1000).astype(np.int32), [0, 0, 0]])
    q = q.astype(np.int32)
    before = dict(ktag.LAUNCHES)
    found, got = ktag.tag_lookup(*(torch.from_numpy(a).to(card)
                                   for a in (q, keys, vals, nxt)),
                                 n_buckets=n_buckets)
    assert ktag.LAUNCHES == {**before, "tag_probe": before["tag_probe"] + 1}
    nf, nv = ktag.tag_lookup_np(q, keys, vals, nxt, n_buckets)
    assert np.array_equal(found.cpu().numpy(), nf)
    assert np.array_equal(got.cpu().numpy(), nv)
    assert nf[-3:].all() and not nv[-3:].any()


@pytest.mark.parametrize("zero_tag", [False, True])
def test_tag_probe_matches_plain_version(card, zero_tag):
    """2^12 buckets at 3 tags a bucket (chains of one row and more), a
    sixth of the tags stored twice, tag 0 stored or not:
    tag_probe against tag_windows + probe_plain on the card and the numpy
    reading, one launch a call; every stored tag is found."""
    rng = np.random.default_rng(7 + zero_tag)
    n_buckets = 1 << 12
    tags = rng.integers(-(1 << 31), 1 << 31, size=3 * n_buckets)
    tags = tags.astype(np.int32)
    tags[-(tags.size // 6):] = tags[:tags.size // 6]
    values = rng.integers(1, 1 << 31, size=tags.shape[0]).astype(np.int32)
    if zero_tag:
        tags[5], values[5] = 0, 1234
    table = ktag.tag_table_np(tags, values, n_buckets)
    q = np.concatenate([tags, rng.integers(-(1 << 31), 1 << 31,
                                           size=4000).astype(np.int32),
                        np.zeros(5, np.int32)]).astype(np.int32)
    args = [torch.from_numpy(a).to(card) for a in (q, *table)]
    before = ktag.LAUNCHES["tag_probe"]
    found, got = ktag.tag_probe(*args, n_buckets=n_buckets)
    torch.cuda.synchronize()
    assert ktag.LAUNCHES["tag_probe"] == before + 1
    pf, pv = ktag.tag_probe_plain(*args, n_buckets=n_buckets)
    assert torch.equal(found, pf) and torch.equal(got, pv)
    nf, nv = ktag.tag_lookup_np(q, *table, n_buckets)
    assert np.array_equal(found.cpu().numpy(), nf)
    assert np.array_equal(got.cpu().numpy(), nv)
    assert nf[-5:].all() and nf[:tags.size].all()
    with pytest.raises(ValueError, match="n_buckets"):
        ktag.tag_probe(*args, n_buckets=table[0].shape[0] + 1)


def test_tag_probe_follows_a_table_written_in_place(card):
    """The kernel reads the table's tensors where they lie: new values
    are read after an in-place update, and one launch is counted a call
    either way."""
    rng = np.random.default_rng(9)
    tags = rng.integers(-(1 << 31), 1 << 31, size=3000).astype(np.int32)
    values = rng.integers(1, 1 << 31, size=3000).astype(np.int32)
    table = [torch.from_numpy(a).to(card)
             for a in ktag.tag_table_np(tags, values, 1024)]
    q = torch.from_numpy(tags).to(card)
    before = ktag.LAUNCHES["tag_probe"]
    f1, v1 = ktag.tag_probe(q, *table, n_buckets=1024)
    table[1].add_(1)
    f2, v2 = ktag.tag_probe(q, *table, n_buckets=1024)
    torch.cuda.synchronize()
    assert ktag.LAUNCHES["tag_probe"] == before + 2
    assert torch.equal(f1, f2) and bool(f1.all())
    assert torch.equal(v2, v1 + 1)
    pf, pv = ktag.tag_probe_plain(q, *table, n_buckets=1024)
    assert torch.equal(f2, pf) and torch.equal(v2, pv)


def test_full_width_rwkv_server_on_card(card):
    """RWKV6-7B at full width (32 layers, 64 heads of 64) serves prompts
    of 32 (L) and 64 (H) tokens and one of 75 on the card, blocking and
    pipelined alike, through the WKV6 kernel: 32 launches per prefill and
    per decode step, and never its plain version."""
    cfg = get_arch("rwkv6-7b")
    lm = LM(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (32, 64, 75)]
    before = kwkv.LAUNCHES["wkv6"]
    outs = []
    for pipelined in (False, True):
        server = Server(lm, page_size=16, n_pages=64)
        for p in prompts:
            server.submit(p, max_new=4)
        reqs = list(server.queue)
        server.run_until_drained(max_len=128, pipelined=pipelined)
        assert all(r.done and len(r.out) == 4 for r in reqs)
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert kwkv.LAUNCHES["wkv6"] == before + 2 * (3 + 3 * 3) * cfg.n_layers


def ssd_inputs(rng, B, T, H, dh, N, dtype, device):
    """x, B_, C_ in ``dtype``; dt in [0.001, 0.4], A in [-1.5, -0.3] and a
    carried state fp32 (tests/test_kernels.py's ranges)."""
    x = normal(rng, (B, T, H, dh), dtype, device)
    Bm, Cm = (normal(rng, (B, T, N), dtype, device) for _ in range(2))
    dt = torch.from_numpy(rng.uniform(0.001, 0.4, size=(B, T, H))
                          .astype(np.float32)).to(device)
    A = -torch.from_numpy(rng.uniform(0.3, 1.5, size=(H,))
                          .astype(np.float32)).to(device)
    state = normal(rng, (B, H, dh, N), torch.float32, device)
    return x, dt, Bm, Cm, A, state


@pytest.mark.parametrize("B,T,H,dh,N,dtype,carried", [
    (1, 4096, 256, 64, 16, torch.bfloat16, False),  # Jamba prefill
    (1, 1, 256, 64, 16, torch.bfloat16, True),      # Jamba decode
    (2, 3001, 16, 64, 16, torch.bfloat16, True),    # ragged T, per batch
    (2, 37, 8, 32, 8, torch.float32, True),         # reduced, ragged
    (3, 256, 2, 128, 16, torch.float32, False),     # test_kernels' width
    (1, 64, 4, 64, 8, torch.float32, True),
    (4, 1, 8, 32, 8, torch.float32, True),          # reduced decode
    (1, 1, 8, 32, 8, torch.float32, True),          # the hybrid's decode
    (1, 1, 256, 64, 16, torch.float32, True),       # Mamba's fp32 decode
    # decode at B = 2 and 4, both dtypes, every head dim
    *[(B, 1, 5, dh, 16 if dh == 64 else 8, dtype, True) for B in (2, 4)
      for dtype in (torch.float32, torch.bfloat16) for dh in (32, 64, 128)],
    # around the chunk: C - 1, C, C + 1 and 2C + 1
    (1, CHUNK - 1, 9, 64, 16, torch.bfloat16, True),
    (2, CHUNK, 3, 32, 8, torch.bfloat16, False),
    (1, CHUNK + 1, 17, 128, 16, torch.bfloat16, True),
    (3, 2 * CHUNK + 1, 8, 64, 8, torch.bfloat16, True),
])
def test_ssd_matches_plain_version(card, B, T, H, dh, N, dtype, carried):
    rng = np.random.default_rng(T + H + dh + N)
    x, dt, Bm, Cm, A, state = ssd_inputs(rng, B, T, H, dh, N, dtype, card)
    state = state if carried else None
    before = kssd.LAUNCHES["ssd"]
    got, got_state = kssd.ssd(x, dt, Bm, Cm, A, state)
    torch.cuda.synchronize()
    assert kssd.LAUNCHES["ssd"] == before + 1
    plain, plain_state = kssd.ssd_plain(x, dt, Bm, Cm, A, state)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert torch.isfinite(got_state).all()
    scale = float(plain_state.abs().max())
    assert float((got_state - plain_state).abs().max()) <= 2e-5 * scale
    diff = (got.float() - plain.float()).abs()
    p = plain.float().abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5 * float(p.max())
    else:
        limit = 4 * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())
        assert bool((diff <= limit).all())
    if carried:  # the state is read: dropping it breaks the limit
        dropped, _ = kssd.ssd_plain(x, dt, Bm, Cm, A)
        assert float((dropped.float() - plain.float()).abs().max()) > \
            1e-2 * float(p.max())


def test_ssd_state_chains_on_card(card):
    """Two halves chained through the state equal the whole sequence."""
    rng = np.random.default_rng(5)
    x, dt, Bm, Cm, A, _ = ssd_inputs(rng, 2, 300, 4, 64, 16, torch.float32,
                                     card)
    whole, s_whole = kssd.ssd(x, dt, Bm, Cm, A)
    head, s = kssd.ssd(*(t[:, :123].contiguous() for t in (x, dt, Bm, Cm)),
                       A)
    tail, s = kssd.ssd_heads(*(t[:, 123:].contiguous()
                               for t in (x, dt, Bm, Cm)), A, s)
    scale = float(whole.abs().max())
    assert float((torch.cat([head, tail], 1) - whole).abs().max()) <= \
        2e-5 * scale
    assert float((s - s_whole).abs().max()) <= 2e-5 * float(
        s_whole.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_wkv6_state_chains_on_card(card, dtype):
    """A prompt in three pieces (a prefill of 2C + 1, one decode step, a
    ragged prefill) chained through the state equals the plain version
    over the whole, with strong decays: outputs within 2e-5 (fp32) or the
    bf16 limit, the final state within 2e-5."""
    rng = np.random.default_rng(7)
    r, k, v, logw, u, state = wkv_inputs(rng, 2, 3 * CHUNK, 3, 64, dtype,
                                         card, strong=True)
    plain, plain_state = kwkv.wkv6_plain(r, k, v, logw, u, state)
    outs, s = [], state
    for lo, hi in ((0, 2 * CHUNK + 1), (2 * CHUNK + 1, 2 * CHUNK + 2),
                   (2 * CHUNK + 2, 3 * CHUNK)):
        piece = (t[:, lo:hi].contiguous() for t in (r, k, v, logw))
        o, s = kwkv.wkv6(*piece, u, s)
        outs.append(o)
    got = torch.cat(outs, 1)
    diff = (got.float() - plain.float()).abs()
    p = plain.float().abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 2e-5 * float(p.max())
    else:
        assert bool((diff <= 4 * 2.0 ** -8 * (p + 2.0 ** -8 * p.max())).all())
    assert float((s - plain_state).abs().max()) <= 2e-5 * float(
        plain_state.abs().max())


def test_ssd_raises_and_never_falls_back(card):
    rng = np.random.default_rng(0)
    x, dt, Bm, Cm, A, _ = ssd_inputs(rng, 1, 4, 2, 48, 16, torch.float32,
                                     card)
    with pytest.raises(ValueError, match="head_dim"):
        kssd.ssd(x, dt, Bm, Cm, A)
    x, dt, Bm, Cm, A, _ = ssd_inputs(rng, 1, 4, 2, 32, 12, torch.float32,
                                     card)
    with pytest.raises(ValueError, match="d_state"):
        kssd.ssd(x, dt, Bm, Cm, A)
    x, dt, Bm, Cm, A, _ = ssd_inputs(rng, 1, 4, 2, 32, 16, torch.float32,
                                     card)
    with pytest.raises(TypeError, match="float32 dt"):
        kssd.ssd(x, dt.double(), Bm, Cm, A)


def test_reduced_hybrid_server_on_card(card):
    """Jamba-1.5-Large at reduced() serves prompts of 1 and 8 (H) tokens
    and one of 40 on the card, blocking and pipelined alike, through the
    SSD kernel (7 launches per prefill and per decode step: the Mamba
    sublayers of its one superblock) and both attention kernels, never
    their plain versions."""
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    lm = LM(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (1, 8, 40)]
    before = {**kssd.LAUNCHES, **kflash.LAUNCHES, **kpaged.LAUNCHES}
    outs = []
    for pipelined in (False, True):
        server = Server(lm, page_size=16, n_pages=64)
        for p in prompts:
            server.submit(p, max_new=4)
        reqs = list(server.queue)
        server.run_until_drained(max_len=128, pipelined=pipelined)
        assert all(r.done and len(r.out) == 4 for r in reqs)
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out)
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    assert kssd.LAUNCHES["ssd"] == before["ssd"] + 2 * (3 + 3 * 3) * 7
    assert kflash.LAUNCHES["flash_attention"] == \
        before["flash_attention"] + 2 * 3
    assert kpaged.LAUNCHES["paged_attention"] == \
        before["paged_attention"] + 2 * 3 * 3


def test_mamba_mixer_on_card_equals_cpu(card):
    """Jamba's reduced Mamba mixer in fp32 over a ragged prompt of two
    batch rows and three decode steps, on the card (the SSD kernel, with
    the conv output laid out as the card's einsum leaves it) and on the
    CPU (the plain version): within 2e-5 of the largest magnitude."""
    from repro_torch.models import mamba as mamba_mod
    cfg = get_arch("jamba-1.5-large-398b").reduced()
    p = mamba_mod.init_mamba(torch.Generator().manual_seed(0), cfg)
    p = {k: v.float() for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 40, cfg.d_model)).astype(np.float32))
    runs = []
    for dev in (card, torch.device("cpu")):
        w = {k: v.to(dev) for k, v in p.items()}
        xd = x.to(dev)
        out, state = mamba_mod.mamba_forward(w, xd[:, :37], cfg,
                                             return_state=True)
        outs = [out]
        for t in range(37, 40):
            o, state = mamba_mod.mamba_decode(w, xd[:, t:t + 1], state, cfg)
            outs.append(o)
        runs.append(torch.cat([o.cpu() for o in outs], 1))
    scale = float(runs[1].abs().max())
    assert float((runs[0] - runs[1]).abs().max()) <= 2e-5 * scale


@pytest.mark.parametrize("kind,mix,keyspace", [("clht", "F", "int"),
                                               ("art", "A", "string")])
def test_matrix_workload_on_card_equals_replay(card, kind, mix, keyspace):
    """A Zipf F on P-CLHT and a string-key A on P-ART at 2^12 keys, in
    plans and through the buffered engine, on the card: the counts and
    the final items equal ``replay``'s, and the read waves launched the
    index's kernel."""
    from repro_torch.core.ycsb import run_workload
    from repro_torch.data.workloads import matrix_workload, replay
    wl = matrix_workload(mix, 1 << 12, 1 << 12, dist="zipfian", theta=0.99,
                         keyspace=keyspace, seed=5)
    want = replay(wl.load_ops, wl.run_ops)
    name = "probe64_fp" if kind == "clht" else "art_descend"
    for buffered in (False, True):
        s = open_index(kind)
        assert s.index.device.type == "cuda"
        run_workload(s.index, wl, phase="load", batch_lookups=True)
        before = {**kprobe.LAUNCHES, **kart.LAUNCHES}[name]
        s.execute(Plan.from_ops([("lookup", k, 0)
                                 for _, k, _ in wl.load_ops[:1024]]),
                  force_kernel=True)
        done = run_workload(s.index, wl, phase="run", batch_lookups=True,
                            buffered=buffered, max_batch=1024)
        assert (done["found"], done["acked"], done["scanned"]) == \
            want.counts(), buffered
        assert dict(s.index.items()) == want.model
        assert {**kprobe.LAUNCHES, **kart.LAUNCHES}[name] > before


def test_crash_sweep_on_card_then_batched_read_back(card):
    """The powerfail sweep of the JAX tests' P-CLHT (8 buckets: rehashes)
    with the index on the card: ``ok``, more than 50 crash states; then
    every surviving key looked up in one plan on the probe kernel equals
    its scalar lookup (an export made before a ``PMSnapshot.restore``
    is never served after it)."""
    from repro_torch.core import PCLHT, run_crash_sweep
    rng = np.random.default_rng(4)
    keys = [int(k) for k in np.unique(rng.integers(1, 1 << 60, size=40))]
    keys += list(range(0x0F00000000000000, 0x0F00000000000000 + 30))
    ops = [("insert", k, k ^ 0xAB) for k in dict.fromkeys(keys)]
    ops += [("delete", k, 0) for k in keys[:8]]
    built = []

    def factory(pm):
        built.append(PCLHT(pm, n_buckets=8, device=card))
        return built[-1]

    report = run_crash_sweep(factory, ops, mode="powerfail", post_writes=6,
                             max_states=4000)
    assert report.ok, report.summary()
    assert report.n_crash_states > 50
    index = built[0]
    probe = [k for _, k, _ in ops] + [k + 1 for _, k, _ in ops[:20]]
    scalar = [index.lookup(k) for k in probe]
    before = kprobe.LAUNCHES["probe64_fp"]
    got = index.execute(Plan.from_ops([("lookup", k, 0) for k in probe]),
                        force_kernel=True).results
    assert got == scalar
    assert kprobe.LAUNCHES["probe64_fp"] == before + 1
    assert sum(v is not None for v in got) == len(set(keys)) - 8
