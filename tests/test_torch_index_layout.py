"""The per-epoch layouts of the two pointer-chasing index kernels, on the
CPU and without JAX.

``probe.pack_lines``: one 64-byte line per row (keys, values, where the
rest of the chain starts, fingerprint bytes and the count of rows after
it) and a region of chain copies; every field reads back, a probe may
start at any row and reads the lanes a walk over ``nxt`` reads, merges
and cycles raise, and the depth is capped at 64.
``art_probe.pack_children``: each child entry carries the child's
clamped level and leaf bit; out-of-range children become -1, a root
that is a leaf works, and more rows than 26 bits name raise.
``readback.to_host``: a wave's outputs come back in one copy, each
array equal to its tensor.  Exact everywhere: every value is an integer.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PART, PHOT, PMem
from repro_torch.kernels import art_probe as tart
from repro_torch.kernels import probe as tprobe
from repro_torch.kernels.probe import fp64, layout
from repro_torch.kernels.probe.ref import chain_window
from repro_torch.kernels.readback import to_host

CPU = torch.device("cpu")


def chains(rng, lengths, n_rows):
    """nxt [n_rows] linking disjoint chains of the given lengths over a
    shuffled row order (so a chain's rows are scattered), with the rows
    no chain takes left as chains of one row."""
    order = rng.permutation(n_rows)
    nxt = np.full(n_rows, -1, np.int64)
    at = 0
    for m in lengths:
        rows = order[at:at + m]
        nxt[rows[:-1]] = rows[1:]
        at += m
    return nxt


def table(seed, lengths, n_rows):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 1 << 62, size=(n_rows, 3))
    keys[rng.random(keys.shape) < 0.25] = 0
    vals = rng.integers(1 << 31, 1 << 62, size=(n_rows, 3))
    return keys, vals, fp64(keys), chains(rng, lengths, n_rows)


def walk(nxt, row, depth):
    """The rows a probe from ``row`` visits, walking ``nxt``."""
    rows = []
    while row >= 0 and len(rows) < depth:
        rows.append(row)
        row = nxt[row]
    return rows


def test_every_field_reads_back():
    keys, vals, fps, nxt = table(1, [1, 2, 5, 9, 3, 3], 40)
    lines, depth = tprobe.pack_lines(keys, vals, fps, nxt, device=CPU)
    lines = lines.numpy()
    n_rows = nxt.size
    assert depth == 9
    assert lines.shape == (n_rows + int((nxt >= 0).sum()), 8)
    np.testing.assert_array_equal(lines[:n_rows, 0:3], keys)
    np.testing.assert_array_equal(lines[:n_rows, 3:6], vals)
    w7 = lines[:, 7]
    for s in range(3):
        np.testing.assert_array_equal((w7[:n_rows] >> (8 * s)) & 0xFF,
                                      fps[:, s])
    for r in range(n_rows):
        after = walk(nxt, r, n_rows)[1:]
        assert w7[r] >> layout.COUNT_SHIFT == len(after)
        assert (w7[r] >> 24) & 0xFF == 0
        if not after:
            assert lines[r, 6] == -1
            continue
        # the rest of the chain lies on consecutive lines, each a copy
        # of its row carrying the row's w6 and w7
        first = lines[r, 6]
        for h, row in enumerate(after):
            np.testing.assert_array_equal(lines[first + h], lines[row])
    assert lines.dtype == np.int64


@pytest.mark.parametrize("depth", [1, 2, 4, 9, 12])
def test_a_probe_starts_at_any_row_and_reads_the_chain(depth):
    keys, vals, fps, nxt = table(2, [1, 2, 5, 9, 3, 3, 7], 48)
    lines, _ = tprobe.pack_lines(keys, vals, fps, nxt, device=CPU)
    n_rows = nxt.size
    # every row, and a start on each side of the table
    starts = torch.tensor([-1, *range(n_rows), lines.shape[0]])
    win, live = chain_window(starts, lines, depth)
    for i, r in enumerate(starts.tolist()):
        rows = walk(nxt, r, depth) if 0 <= r < n_rows else []
        assert live[i].tolist() == [h < len(rows) for h in range(depth)]
        for h, row in enumerate(rows):
            np.testing.assert_array_equal(win[i, h, 0:3].numpy(), keys[row])
            np.testing.assert_array_equal(win[i, h, 3:6].numpy(), vals[row])
    # the probe itself: every resident key, probed from every row of its
    # chain up to its own, is found with its value
    q, b, want = [], [], []
    for r in range(n_rows):
        for row in walk(nxt, r, depth):
            for s in range(3):
                if keys[row, s]:
                    q.append(keys[row, s])
                    b.append(r)
                    want.append(vals[row, s])
    for use_fp in (True, False):
        found, got, _, _ = tprobe.probe_chain(
            torch.tensor(q), torch.tensor(b), lines, depth, use_fp=use_fp)
        hits = found.numpy()
        # a key twice in one chain returns the first copy's value
        keep = np.array([keys[walk(nxt, bb, depth)].ravel().tolist()
                         .index(qq) for qq, bb in zip(q, b)])
        first = np.array([vals[walk(nxt, bb, depth)].ravel()[k]
                          for bb, k in zip(b, keep)])
        assert hits.all()
        np.testing.assert_array_equal(got.numpy(), first)
        assert (first == np.array(want)).mean() > 0.99


def test_key_zero_counts_the_lanes_past_the_chain():
    keys, vals, fps, nxt = table(3, [4, 2], 6)
    keys[:] = 1 + np.arange(18).reshape(6, 3)  # no empty slot
    fps = fp64(keys)
    lines, depth = tprobe.pack_lines(keys, vals, fps, nxt, device=CPU)
    assert depth == 4
    short = int(np.flatnonzero([len(walk(nxt, r, 9)) == 2
                                for r in range(6)])[0])
    found, values, nfp, nfalse = tprobe.probe_chain(
        torch.tensor([0, 0]), torch.tensor([short, -1]), lines, depth,
        use_fp=True)
    # two live rows, two past the end (6 lanes); a start outside: 12
    assert found.tolist() == [True, True] and values.tolist() == [0, 0]
    assert nfp.tolist() == [6, 12] and nfalse.tolist() == [0, 0]


@pytest.mark.parametrize("fault", ["merge", "cycle", "range"])
def test_a_merge_a_cycle_or_a_pointer_out_of_range_raises(fault):
    keys, vals, fps, nxt = table(4, [3, 3], 8)
    heads = [r for r in range(8) if r not in set(nxt.tolist())]
    if fault == "merge":   # two rows point at one
        nxt[walk(nxt, heads[1], 9)[-1]] = walk(nxt, heads[0], 9)[1]
        match = "two predecessors"
    elif fault == "cycle":  # a chain's last row points at its head
        chain = walk(nxt, heads[0], 9)
        nxt[chain[-1]] = chain[0]
        match = "cycle"
    else:
        nxt[heads[0]] = 8
        match = "out of range"
    with pytest.raises(ValueError, match=match):
        tprobe.pack_lines(keys, vals, fps, nxt, device=CPU)


def test_depth_is_capped_at_64():
    keys, vals, fps, nxt = table(5, [70, 3], 80)
    lines, depth = tprobe.pack_lines(keys, vals, fps, nxt, device=CPU)
    assert depth == layout.MAX_DEPTH == 64
    head = [r for r in range(80) if r not in set(nxt.tolist())
            and len(walk(nxt, r, 99)) == 70][0]
    rows = walk(nxt, head, 70)
    q = torch.tensor([keys[rows[63]].max(), keys[rows[64]].max()])
    found, _, _, _ = tprobe.probe_chain(q, torch.tensor([head, head]),
                                        lines, depth, use_fp=False)
    assert found.tolist() == [True, False]  # hop 64 is past the cut


def random_pages(rng, n, unit_bits):
    fan, n_units = 1 << unit_bits, 64 // unit_bits
    return (rng.integers(-3, n + 3, size=(n, fan)).astype(np.int32),
            rng.integers(-3, n_units + 3, size=n).astype(np.int32),
            (rng.random(n) < 0.3).astype(np.uint8))


@pytest.mark.parametrize("unit_bits", [8, 4])
def test_packed_entries_carry_the_clamped_child_header(unit_bits):
    rng = np.random.default_rng(unit_bits)
    n, n_units = 200, 64 // unit_bits
    children, level, is_leaf = random_pages(rng, n, unit_bits)
    packed, root = tart.pack_children(children, level, is_leaf,
                                      unit_bits=unit_bits, device=CPU)
    packed = packed.numpy()
    ok = (children >= 0) & (children < n)
    assert (packed[~ok] == -1).all()  # out of range: the walk stops
    c = children[ok]
    e = packed[ok]
    np.testing.assert_array_equal(e & tart.ref.ROW_MASK, c)
    np.testing.assert_array_equal((e >> 26) & 15,
                                  np.clip(level[c], 0, n_units - 1))
    np.testing.assert_array_equal((e >> 30) & 1, is_leaf[c])
    assert (e >= 0).all()
    assert root == min(max(level[0], 0), n_units - 1) | (is_leaf[0] << 4)
    assert children.min() < 0  # the export's own array is left as it was


@pytest.mark.parametrize("cls", [PART, PHOT], ids=["art", "hot"])
def test_a_root_that_is_a_leaf(cls):
    idx = cls(PMem(seed=3), device="cpu")
    idx.insert(12345, 12345 ^ (1 << 40))
    arrays = idx.export_arrays()
    assert arrays["is_leaf"][0]  # one key: the root is the leaf
    _, root = tart.pack_children(arrays["children"], arrays["level"],
                                 arrays["is_leaf"],
                                 unit_bits=int(arrays.get("unit_bits", 8)),
                                 device=CPU)
    assert root & tart.ref.LEAF_BIT
    q = np.array([12345, 99991, 0, 12345 ^ 0x100, -(1 << 63)], np.int64)
    found, vals = tart.batched_lookup(q, arrays, device=CPU)
    f, v, *_ = tart.descend_fp_ref(q, arrays)
    np.testing.assert_array_equal(found, f)
    np.testing.assert_array_equal(vals, v)
    assert found.tolist() == [True, False, False, False, False]
    assert vals[0] == 12345 ^ (1 << 40)


def test_more_rows_than_26_bits_name_raise(monkeypatch):
    rng = np.random.default_rng(6)
    children, level, is_leaf = random_pages(rng, 40, 4)
    monkeypatch.setattr(tart.ops, "MAX_ROWS", 40)
    tart.pack_children(children, level, is_leaf, unit_bits=4, device=CPU)
    monkeypatch.setattr(tart.ops, "MAX_ROWS", 39)
    with pytest.raises(ValueError, match="at most 39"):
        tart.pack_children(children, level, is_leaf, unit_bits=4,
                           device=CPU)
    assert tart.ops.MAX_ROWS != 1 << 26


@pytest.mark.parametrize("n", [0, 1, 4099])
def test_to_host_splits_one_copy_back_into_each_output(n):
    rng = np.random.default_rng(n)
    values = torch.from_numpy(rng.integers(-(1 << 63), 1 << 63, size=n,
                                           dtype=np.int64))
    counts = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=n,
                                           dtype=np.int32))
    found = torch.from_numpy(rng.random(n) < 0.5)
    got = to_host(values, counts, found)
    assert [a.dtype for a in got] == [np.int64, np.int32, np.bool_]
    for a, t in zip(got, (values, counts, found)):
        np.testing.assert_array_equal(a, t.numpy())
