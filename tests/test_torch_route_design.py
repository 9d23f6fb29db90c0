"""The partition kernel's design (``csrc/shard_route.cu``
``shard_partition``), on the CPU, and the sharded plan path built on it.

``shard_partition`` routes a batch and sorts it stably by shard on the
card. A warp holds kKeys * 32 consecutive keys (round j, lane l: key
first + 32 * j + l); a key's rank among its warp's keys of the same
shard is the warp's count of that shard in earlier rounds plus its peers
in lower lanes (``__match_any_sync``); the warps' counts sit in a table
[S][warps] whose exclusive scan, shard-major then warp order, gives each
warp's base for each shard. At Q <= 4096 and S <= 128 one cluster of 8
blocks does all of it: each block ranks its 512 keys over its own [S][4]
table and reads every block's count of each shard through distributed
shared memory; otherwise tiles of 8 warps count their keys, one block
scans the [S][tiles] counts, and each tile ranks its keys over its own
[S][8] table. ``model_partition`` below follows that lane by lane, with
the constants read from the source, and is held to
``np.argsort(kind="stable")``.

The plain version ``shard_partition_plain`` (what the wrapper runs on
CPU tensors, and what ``chip_smoke.py`` holds the kernel to on the card)
is held to the JAX package's ``partition_ref`` and to its Pallas
``shard_route`` in interpret mode followed by a stable argsort, on keys
0, -1, 2^63 and 2^63 - 1 among random ones.  ``ShardedIndex`` partitions
every plan with one ``shard_partition`` call and one readback (the mesh
path: none before its search); the port's and the JAX package's sharded
indexes agree on plans with and without scans, with empty shards.

Keys are drawn with numpy from a seed; every compared value is an
integer, so nothing has a tolerance.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from repro.core import PCLHT as JPCLHT
from repro.core import Plan as JPlan
from repro.core.baselines import FastFair as JFastFair
from repro.distributed import ShardedIndex as JShardedIndex
from repro.kernels.partition.ref import partition_ref as jax_partition_ref
from repro.kernels.partition import route_shards as jax_route_shards
from repro_torch.api import Plan
from repro_torch.core import PCLHT
from repro_torch.core.baselines import FastFair
from repro_torch.distributed import ShardedIndex
from repro_torch.distributed import sharded as tsharded
from repro_torch.kernels import partition as tpart

CPU = torch.device("cpu")
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern
TOP = (1 << 63) - 1
SRC = (pathlib.Path(tpart.kernel.__file__).parents[2] / "csrc"
       / "shard_route.cu").read_text()


def constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SRC)
    assert m, f"{name} is not a number in csrc/shard_route.cu"
    return int(m.group(1))


WARP = constant("kWarp")
KEYS = constant("kKeys")
CLUSTER_KEYS = constant("kClusterKeys")
CLUSTER_MAX_SHARDS = constant("kClusterMaxShards")
CLUSTER_BLOCKS = constant("kClusterBlocks")
TILE_WARPS = constant("kTileWarps")
MAX_BITS = constant("kMaxShardBits")
CLUSTER_THREADS = CLUSTER_KEYS // CLUSTER_BLOCKS // KEYS
CLUSTER_WARPS = CLUSTER_THREADS // WARP
TILE_KEYS = TILE_WARPS * WARP * KEYS


def edge_keys(seed: int, n: int) -> np.ndarray:
    """Random int64 keys over the whole range (a half below 2^62, so
    prefix routes reach every shard), with 0, -1, 2^63 and 2^63 - 1."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(HIGH, TOP, size=n, dtype=np.int64)
    keys[: n // 2] = rng.integers(1, 1 << 62, size=n // 2)
    edges = np.array([0, -1, HIGH, TOP, 1, 1 << 62], np.int64)[:n]
    keys[:edges.size] = edges
    return keys


def warp_ranks(ids: np.ndarray, first: int, n: int, cnt: np.ndarray,
               rank: np.ndarray) -> None:
    """One warp of the source's ``warp_ranks``: KEYS rounds over keys
    first + 32 * j + l, the match-any peers below each lane, then the
    lowest peer raising the warp's count (``cnt`` [S])."""
    for j in range(KEYS):
        idx = first + j * WARP + np.arange(WARP)
        s = np.full(WARP, -1, np.int64)
        s[idx < n] = ids[idx[idx < n]]
        peers = s[None, :] == s[:, None]                   # [lane, peer]
        below = np.tril(np.ones((WARP, WARP), bool), -1)   # peer < lane
        n_below = (peers & below).sum(axis=1)
        for lane in range(WARP):
            if s[lane] < 0:
                continue
            rank[idx[lane]] = cnt[s[lane]] + n_below[lane]
        for lane in range(WARP):  # the lowest peer adds the group
            if s[lane] >= 0 and n_below[lane] == 0:
                cnt[s[lane]] += peers[lane].sum()


def exclusive(a: np.ndarray) -> np.ndarray:
    """Exclusive scan of a flattened table, in its row-major order."""
    flat = a.reshape(-1)
    return (np.cumsum(flat) - flat).reshape(a.shape)


def model_partition(ids: np.ndarray, n_shards: int):
    """(order, offsets, form) as the kernel computes them from the ids."""
    n = ids.shape[0]
    rank = np.zeros(n, np.int64)
    order = np.full(n, -1, np.int64)
    if n <= CLUSTER_KEYS and n_shards <= CLUSTER_MAX_SHARDS:
        block_keys = CLUSTER_THREADS * KEYS
        tables = np.zeros((CLUSTER_BLOCKS, n_shards, CLUSTER_WARPS),
                          np.int64)                  # each block's [S][warps]
        for blk in range(CLUSTER_BLOCKS):
            for w in range(CLUSTER_WARPS):
                warp_ranks(ids, blk * block_keys + w * WARP * KEYS, n,
                           tables[blk, :, w], rank)
        totals = tables.sum(axis=2)                  # [blocks, S]
        every = totals.sum(axis=0)                   # read through DSMEM
        below = np.cumsum(every) - every             # the lower shards
        offsets = np.append(below, n)
        for i in range(n):
            blk, w = i // block_keys, i % block_keys // (WARP * KEYS)
            s = ids[i]
            warp_base = tables[blk, s, :w].sum()
            before = totals[:blk, s].sum()
            order[below[s] + before + warp_base + rank[i]] = i
        return order, offsets, "one cluster"
    tiles = -(-n // TILE_KEYS)
    counts = np.zeros((n_shards, tiles), np.int64)
    for t in range(tiles):
        counts[:, t] = np.bincount(ids[t * TILE_KEYS:(t + 1) * TILE_KEYS],
                                   minlength=n_shards)
    bases = exclusive(counts)
    offsets = np.append(bases[:, 0] if tiles else np.zeros(n_shards,
                                                           np.int64), n)
    for t in range(tiles):
        table = np.zeros((n_shards, TILE_WARPS), np.int64)
        for w in range(TILE_WARPS):
            warp_ranks(ids, t * TILE_KEYS + w * WARP * KEYS, n,
                       table[:, w], rank)
        # each shard's warps in order, from the tile's base
        warp_base = bases[:, t:t + 1] + np.cumsum(table, axis=1) - table
        for i in range(t * TILE_KEYS, min(n, (t + 1) * TILE_KEYS)):
            w = (i - t * TILE_KEYS) // (WARP * KEYS)
            order[warp_base[ids[i], w] + rank[i]] = i
    return order, offsets, "tiles"


def test_source_constants():
    """The forms' sizes: the cluster's blocks hold 4096 keys, a thread a
    shard, their tables in static shared memory; a tile's [4096][8]
    table fits the 227 KB a block may have; the wrapper's limit is the
    source's."""
    assert WARP == 32 and KEYS == 4 and CLUSTER_KEYS == 4096
    assert CLUSTER_BLOCKS <= 8  # the portable cluster size
    assert CLUSTER_THREADS * CLUSTER_BLOCKS * KEYS == CLUSTER_KEYS
    assert CLUSTER_MAX_SHARDS <= CLUSTER_THREADS  # a thread a shard
    # a block's table, counts and bases in static shared memory
    assert 4 * CLUSTER_MAX_SHARDS * (CLUSTER_WARPS + 2) <= 48 * 1024
    assert 4 * TILE_WARPS * (1 << MAX_BITS) <= 232448
    assert tpart.MAX_PARTITION_BITS == MAX_BITS == 12
    assert "kTileWarps * kWarp * kKeys" in SRC


@pytest.mark.parametrize("n_shards", [1, 2, 8, 64, 256, 512, 4096])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4095, 4096, 4097])
def test_lane_model_is_the_stable_sort(n, n_shards):
    """The kernel's ranking, lane by lane, in both forms: the stable
    sort-by-shard permutation and the runs' offsets."""
    bits = n_shards.bit_length() - 1
    scheme = "hash" if n % 2 else "prefix"
    keys = edge_keys(n + n_shards, n)
    ids = tpart.route_ref(keys, n_shards, scheme)
    order, offsets, form = model_partition(ids.astype(np.int64), n_shards)
    assert form == ("one cluster" if n <= 4096 and bits <= 7 else "tiles")
    np.testing.assert_array_equal(order, np.argsort(ids, kind="stable"))
    np.testing.assert_array_equal(
        offsets, np.concatenate([[0], np.cumsum(np.bincount(
            ids, minlength=n_shards))]))


def test_lane_model_over_many_tiles_and_one_shard():
    """65537 keys (65 tiles, a ragged last one) and every key in one
    shard: ranks run on across rounds, warps and tiles."""
    keys = edge_keys(9, 65537)
    for n_shards, scheme in ((8, "hash"), (64, "prefix@58")):
        ids = tpart.route_ref(keys, n_shards, scheme).astype(np.int64)
        order, _, form = model_partition(ids, n_shards)
        assert form == "tiles"
        np.testing.assert_array_equal(order, np.argsort(ids,
                                                        kind="stable"))
    ids = np.full(5000, 3, np.int64)
    order, offsets, _ = model_partition(ids, 16)
    np.testing.assert_array_equal(order, np.arange(5000))
    assert offsets.tolist() == [0] * 4 + [5000] * 13


@pytest.mark.parametrize("scheme", ["hash", "prefix", "prefix@58"])
@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4095, 4096, 4097])
def test_plain_version_matches_jax_partition_ref(n, scheme):
    keys = edge_keys(n + 3, n)
    kt = torch.from_numpy(keys)
    for bits in range(7):
        n_shards = 1 << bits
        b, shift = tpart.route_params(n_shards, scheme)
        got = tpart.shard_partition(kt, bits=b, shift=shift)
        for g in got:
            assert g.dtype == torch.int32
        shards, order, offsets = (g.numpy() for g in got)
        rs, ro, roff = jax_partition_ref(keys, n_shards, scheme)
        np.testing.assert_array_equal(shards, rs)
        np.testing.assert_array_equal(order, ro.astype(np.int32))
        np.testing.assert_array_equal(offsets, roff.astype(np.int32))
        assert offsets.shape == (n_shards + 1,)


@pytest.mark.parametrize("scheme", ["hash", "prefix", "prefix@58"])
@pytest.mark.parametrize("n", [1, 33, 4097])
def test_plain_version_matches_pallas_route_and_stable_argsort(n, scheme):
    keys = edge_keys(n + 5, n)
    for n_shards in (1, 8, 64):
        b, shift = tpart.route_params(n_shards, scheme)
        shards, order, offsets = tpart.shard_partition_plain(
            torch.from_numpy(keys), bits=b, shift=shift)
        ids = jax_route_shards(keys, n_shards, scheme, use_kernel=True,
                               interpret=True)
        np.testing.assert_array_equal(shards.numpy(), ids)
        np.testing.assert_array_equal(order.numpy(),
                                      np.argsort(ids, kind="stable"))
        np.testing.assert_array_equal(
            np.diff(offsets.numpy()), np.bincount(ids, minlength=n_shards))


def test_wrapper_on_the_cpu_counts_no_launch_and_names_its_limit():
    keys = torch.from_numpy(edge_keys(4, 300))
    before = dict(tpart.LAUNCHES)
    got = tpart.shard_partition(keys, bits=12, shift=-1)
    assert got[2].shape == (4097,) and int(got[2][-1]) == 300
    assert tpart.LAUNCHES == before
    with pytest.raises(ValueError, match="P2"):
        tpart.shard_partition(keys, bits=13, shift=-1)
    with pytest.raises(TypeError):
        tpart.shard_partition(keys.to(torch.int32), bits=2, shift=-1)
    with pytest.raises(ValueError):
        tpart.shard_partition(keys[::2], bits=2, shift=-1)
    with pytest.raises(ValueError):
        tpart.shard_partition(keys, bits=4, shift=61)


# -- the sharded plan path --------------------------------------------------

KINDS = {
    "clht": (lambda p: JPCLHT(p, n_buckets=64),
             lambda p: PCLHT(p, n_buckets=64, device=CPU)),
    "fastfair": (JFastFair, lambda p: FastFair(p, device=CPU)),
}


def plans(kinds, keys, aux):
    return (JPlan.from_arrays(kinds, keys, aux),
            Plan.from_arrays(kinds, keys, aux))


def assert_same(jr, tr):
    assert tr.results == jr.results
    assert (tr.found, tr.acked, tr.scanned) == (jr.found, jr.acked,
                                                jr.scanned)
    assert (tr.wave_kinds, tr.wave_widths) == (jr.wave_kinds,
                                               jr.wave_widths)
    assert tr.probe == jr.probe
    assert (tr.shard_ops, tr.mesh) == (jr.shard_ops, jr.mesh)


@pytest.mark.parametrize("kind", list(KINDS))
def test_plans_with_empty_shards_match_jax(kind):
    """8 shards, keys in 3 of them: loads, mixed plans (with scans on
    the ordered index), and all-GET plans on the mesh and per-shard
    paths; results, shard_ops, waves, probe deltas, stats and every
    shard's PMem counters equal the JAX package's."""
    jf, tf = KINDS[kind]
    j = JShardedIndex(jf, 8)
    t = ShardedIndex(tf, 8, device=CPU)
    rng = np.random.default_rng(21)
    if j.scheme == "hash":
        pool = np.unique(rng.integers(1, TOP, size=600))
        pool = pool[np.isin(tpart.route_ref(pool, 8, "hash"), [0, 3, 6])]
    else:  # prefix routing: key bits 62-60, keys in shards 0, 1 and 5
        pool = np.unique(np.concatenate([
            rng.integers(1, 1 << 60, size=200),
            rng.integers(1 << 60, 2 << 60, size=200),
            rng.integers(5 << 60, 6 << 60, size=200)]))
    assert np.unique(tpart.route_ref(pool, 8, j.scheme)).size == 3
    n = pool.size // 2
    jp, tp = plans(np.ones(n, np.int32), pool[:n], pool[:n] + 7)
    assert_same(j.execute(jp), t.execute(tp))
    for _ in range(3):
        kinds = rng.integers(0, 5 if t.ORDERED else 4, size=300)
        jp, tp = plans(kinds.astype(np.int32), rng.choice(pool, 300),
                       rng.integers(1, 40, size=300))
        jr, tr = j.execute(jp), t.execute(tp)
        assert_same(jr, tr)
        if not (kinds == 4).any():  # scans are replicated
            assert tr.shard_ops.count(0) >= 5
    gets = np.concatenate([pool, rng.integers(1, TOP, size=40)])
    jp, tp = plans(np.zeros(gets.size, np.int32), gets,
                   np.zeros(gets.size, np.int64))
    for kw in ({"mesh": True}, {"mesh": False}, {"mesh": True}):
        jr, tr = j.execute(jp, **kw), t.execute(tp, **kw)
        assert_same(jr, tr)
        assert tr.mesh == kw["mesh"]
    assert t.stats == j.stats
    for jpm, tpm in zip(j.pmems, t.pmems):
        assert dataclasses.asdict(tpm.counters) == \
            dataclasses.asdict(jpm.counters)
    assert list(t.items()) == list(j.items())


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("scans", [False, True])
def test_execute_partitions_once_and_reads_back_once(monkeypatch, mesh,
                                                     scans):
    """A plan makes one shard_partition call, and the per-shard path one
    readback before its sub-plans; the mesh path reads nothing back
    before its search and one copy after it.  route (ids only) is not
    called."""
    calls = {"partition": 0, "to_host": 0}
    real_partition, real_to_host = tsharded.shard_partition, \
        tsharded.to_host

    def partition(*a, **kw):
        calls["partition"] += 1
        return real_partition(*a, **kw)

    def to_host(*a):
        calls["to_host"] += 1
        return real_to_host(*a)

    def no_route(*a, **kw):
        raise AssertionError("execute routed with route_shards")

    monkeypatch.setattr(tsharded, "shard_partition", partition)
    monkeypatch.setattr(tsharded, "to_host", to_host)
    monkeypatch.setattr(tsharded, "route_shards", no_route)
    t = ShardedIndex(KINDS["fastfair"][1], 4, device=CPU,
                     scheme="prefix@61")
    rng = np.random.default_rng(3)
    keys = rng.integers(1, 1 << 62, size=512)
    t.execute(Plan.from_arrays(np.ones(512, np.int32), keys, keys))
    calls.update(partition=0, to_host=0)
    kinds = np.zeros(512, np.int32)
    if scans:
        kinds[::50] = 4
    t.execute(Plan.from_arrays(kinds, keys, np.full(512, 5)), mesh=mesh)
    took_mesh = mesh and not scans
    assert calls == {"partition": 1, "to_host": 1}
    assert t.stats["mesh_plans"] == int(took_mesh)
