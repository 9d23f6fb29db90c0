"""The port's chained probe (repro_torch.kernels.probe) against the JAX
package's probe kernels, bit for bit.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
side runs ``_gather_probe`` in interpret mode, as its snapshot lookup
calls it, and ``gather_chain_windows`` + the numpy oracles.  Tables are
random bucket chains of depth 1-6 with empty slots holding stale
values, values at and above 2^32, fingerprint near-misses (same
fingerprint, other key), probes that start at overflow rows, and key-0
queries.  The port's side reads the line table ``pack_lines`` builds.  No tolerance: every output
is an integer and must be equal.  The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.clht_probe.ops import _gather_probe
from repro.kernels.probe import (combine64, fp64 as jax_fp64,
                                 gather_chain_windows, probe64_fp_ref,
                                 probe64_ref, split64)
from repro_torch.kernels import probe as tprobe
from repro_torch.kernels.probe import ref as tref

SLOTS = 3


def make_table(seed, n_buckets, depth):
    """Random chained table: [R, 3] keys/vals, fps, nxt and each row's
    chain head (-1 for rows no chain reaches); the longest chain has
    exactly ``depth`` rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, depth + 1, size=n_buckets)
    lengths[rng.integers(n_buckets)] = depth
    n_rows = int(lengths.sum()) + 3  # a few rows no chain reaches
    nxt = np.full(n_rows, -1, np.int64)
    head = np.full(n_rows, -1, np.int64)
    free = n_buckets
    for b in range(n_buckets):
        prev = b
        head[b] = b
        for _ in range(lengths[b] - 1):
            nxt[prev] = free
            head[free] = b
            prev, free = free, free + 1
    keys = rng.integers(1, 1 << 62, size=(n_rows, SLOTS))
    keys[rng.random(keys.shape) < 0.25] = 0  # empty slots
    # values span both halves; empty slots keep stale non-zero values
    vals = rng.integers(1 << 31, 1 << 62, size=(n_rows, SLOTS))
    vals[0, 0] = 1 << 32
    # a key twice in one chain (twice in one row at depth 1): the first
    # in hop-major, slot-minor order must win
    b = int(np.argmax(lengths))
    keys[b, 2] = 12345
    if depth > 1:
        keys[nxt[b], 1] = 12345
    else:
        keys[b, 0] = 12345
    return keys, vals, jax_fp64(keys), nxt, head


def make_queries(seed, table, n_q):
    """Hits, misses, fingerprint near-misses, probes that start at a
    row of their chain other than its head (overflow rows included) and
    key 0, with the row each query's probe starts at."""
    keys, _, fps, _, head = table
    rng = np.random.default_rng(seed + 1)
    n_rows, n_buckets = keys.shape[0], int(head.max()) + 1
    q = rng.integers(1, 1 << 62, size=n_q)
    bucket = rng.integers(0, n_buckets, size=n_q)
    live = np.argwhere((keys != 0) & (head >= 0)[:, None])
    pick = live[rng.integers(len(live), size=n_q // 2)]
    q[: n_q // 2] = keys[pick[:, 0], pick[:, 1]]
    bucket[: n_q // 2] = head[pick[:, 0]]
    # near-misses: a fresh key whose fingerprint equals a slot's in the
    # probed chain, so the filter passes and the full compare rejects
    pool = rng.integers(1, 1 << 62, size=20000)
    pool_fp = jax_fp64(pool)
    for i in range(n_q // 2, n_q // 2 + n_q // 8):
        r, s = live[rng.integers(len(live))]
        cand = pool[pool_fp == fps[r, s]]
        q[i], bucket[i] = cand[i % len(cand)], head[r]
    # a probe may start at any row: a resident key from its own row, and
    # a fresh key from a random one
    own = live[rng.integers(len(live), size=n_q // 16)]
    lo = n_q // 2 + n_q // 8
    q[lo:lo + own.shape[0]] = keys[own[:, 0], own[:, 1]]
    bucket[lo:lo + own.shape[0]] = own[:, 0]
    lo += own.shape[0]
    bucket[lo:lo + n_q // 16] = rng.integers(0, n_rows, size=n_q // 16)
    q[-5:] = 0  # key 0 matches empty slots and lanes past a chain's end
    q[-6] = 12345
    bucket[-6] = head[np.argwhere(keys == 12345)[0, 0]]
    return q.astype(np.int64), bucket.astype(np.int64)


def line_table(table):
    keys, vals, fps, nxt, _ = table
    lines, _ = tprobe.pack_lines(keys, vals, fps, nxt,
                                 device=torch.device("cpu"))
    return lines


def port_probe(q, bucket, table, depth, use_fp):
    found, values, nfp, nfalse = tprobe.probe_chain(
        torch.from_numpy(q), torch.from_numpy(bucket), line_table(table),
        depth, use_fp=use_fp)
    out = [found.numpy(), values.numpy()]
    if use_fp:
        out += [nfp.numpy(), nfalse.numpy()]
    return out


def windows(q, bucket, table, depth):
    """The JAX package's windowed form, cut or zero-padded to exactly
    ``depth * 3`` lanes (the shape its snapshot lookup probes)."""
    keys, vals, fps, nxt, _ = table
    wins = gather_chain_windows(bucket, nxt, (keys, vals, fps),
                                max_chain=depth)
    w = depth * SLOTS
    return [np.pad(a[:, :w], ((0, 0), (0, max(0, w - a.shape[1]))))
            for a in wins]


@pytest.mark.parametrize("use_fp", [True, False])
@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
def test_probe_chain_matches_jax_gather_probe(depth, use_fp):
    table = make_table(depth, n_buckets=40, depth=depth)
    keys, vals, fps, nxt, _ = table
    q, bucket = make_queries(depth, table, 300)
    qlo, qhi = split64(q)
    out = _gather_probe(
        jnp.asarray(bucket.astype(np.int32)), jnp.asarray(qlo),
        jnp.asarray(qhi), jnp.asarray(jax_fp64(q).astype(np.int32)),
        *[jnp.asarray(h) for kv in (keys, vals) for h in split64(kv)],
        jnp.asarray(fps.astype(np.int32)),
        jnp.asarray(nxt.astype(np.int32)), depth=depth, use_fp=use_fp,
        interpret=True)
    ref = [np.asarray(out[0]),
           combine64(np.asarray(out[1]), np.asarray(out[2]))]
    ref[1] = np.where(ref[0], ref[1], 0)
    if use_fp:
        ref += [np.asarray(out[3]), np.asarray(out[4])]
    got = port_probe(q, bucket, table, depth, use_fp)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert got[0][:150].all()  # every drawn hit is found
    own = slice(300 // 2 + 300 // 8, 300 // 2 + 300 // 8 + 300 // 16)
    assert got[0][own].all()  # so is a key probed from its own row
    assert (got[1] >= 1 << 31).sum() > 0
    if use_fp:
        assert got[3].sum() > 0  # near-misses reached the full compare
        assert (got[2][-5:] > 0).any()  # key 0 matches the empty lanes


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5, 6])
def test_probe_chain_matches_windowed_oracles(depth):
    table = make_table(100 + depth, n_buckets=64, depth=depth)
    q, bucket = make_queries(100 + depth, table, 1000)
    kwin, vwin, fwin = windows(q, bucket, table, depth)
    f, v, nfp, nfalse = probe64_fp_ref(q, kwin, vwin, jax_fp64(q), fwin)
    got = port_probe(q, bucket, table, depth, True)
    for g, r in zip(got, (f, v, nfp, nfalse)):
        np.testing.assert_array_equal(g, r)
    f, v = probe64_ref(q, kwin, vwin)
    got = port_probe(q, bucket, table, depth, False)
    np.testing.assert_array_equal(got[0], f)
    np.testing.assert_array_equal(got[1], v)


def test_torch_mix64_and_fp64_match_numpy():
    rng = np.random.default_rng(7)
    k = np.concatenate([[0, 1, (1 << 63) - 1, 1 << 62, 12345],
                        rng.integers(0, 1 << 63, size=5000)])
    from repro.kernels.clht_probe import mix64 as jax_mix64
    from repro_torch.kernels.probe import fp64 as port_fp64
    got = tref.mix64(torch.from_numpy(k)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, jax_mix64(k))
    np.testing.assert_array_equal(tref.fp64(torch.from_numpy(k)).numpy(),
                                  jax_fp64(k))
    np.testing.assert_array_equal(port_fp64(k), jax_fp64(k))


def test_probe_chain_cpu_runs_plain_version_and_counts_no_launch():
    table = make_table(3, n_buckets=16, depth=3)
    q, bucket = make_queries(3, table, 64)
    before = dict(tprobe.LAUNCHES)
    got = port_probe(q, bucket, table, 3, True)
    assert tprobe.LAUNCHES == before
    plain = tprobe.probe_chain_plain(torch.from_numpy(q),
                                     torch.from_numpy(bucket),
                                     line_table(table), 3, use_fp=True)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p.numpy())


def test_probe_chain_rejects_bad_inputs():
    table = make_table(4, n_buckets=8, depth=2)
    q, bucket = make_queries(4, table, 16)
    lines = line_table(table)
    good = [torch.from_numpy(q), torch.from_numpy(bucket), lines]
    bad_dtype = list(good)
    bad_dtype[2] = lines.to(torch.int32)
    with pytest.raises(TypeError):
        tprobe.probe_chain(*bad_dtype, 2, use_fp=True)
    bad_shape = list(good)
    bad_shape[1] = good[1][:-1]
    with pytest.raises(ValueError):
        tprobe.probe_chain(*bad_shape, 2, use_fp=True)
    bad_shape = list(good)
    bad_shape[2] = lines[:, :6].contiguous()
    with pytest.raises(ValueError):
        tprobe.probe_chain(*bad_shape, 2, use_fp=True)
    strided = list(good)
    strided[2] = lines.t().contiguous().t()
    with pytest.raises(ValueError):
        tprobe.probe_chain(*strided, 2, use_fp=True)
    misaligned = list(good)
    buf = torch.zeros(lines.numel() + 1, dtype=torch.int64)
    misaligned[2] = buf[1:].view(lines.shape)
    with pytest.raises(ValueError, match="aligned"):
        tprobe.probe_chain(*misaligned, 2, use_fp=True)
    with pytest.raises(ValueError):
        tprobe.probe_chain(*good, 0, use_fp=True)
