"""The port's 32-bit tag probe (repro_torch, on the CPU) against the JAX
package, bit for bit: ``probe_plain`` against ``probe_ref`` and the
Pallas ``clht_probe`` in interpret mode, and ``tag_lookup`` against the
JAX ``tag_lookup`` over chained tables, query 0 included.  Inputs are
drawn with numpy from a seed; every output is an integer or a bool, so
nothing has a tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.clht_probe import clht_probe as jax_clht_probe
from repro.kernels.clht_probe import probe_ref
from repro.kernels.clht_probe import tag_lookup as jax_tag_lookup
from repro_torch.kernels import clht_probe as ktag

I32 = (-(1 << 31), 1 << 31)


def windows(rng, Q, W, hit_share=0.5):
    """Windows with repeated keys (first-hit order matters), queries
    that hit about half the time, and zero lanes."""
    bk = rng.integers(1, 1000, size=(Q, W)).astype(np.int32)
    bk[rng.random((Q, W)) < 0.05] = 0
    bv = rng.integers(*I32, size=(Q, W)).astype(np.int32)
    col = rng.integers(0, W, size=Q)
    q = np.where(rng.random(Q) < hit_share, bk[np.arange(Q), col],
                 123456789).astype(np.int32)
    q[:3] = 0
    return q, bk, bv


@pytest.mark.parametrize("Q,W,qb", [(512, 128, 256), (256, 128, 128),
                                    (1024, 128, 256), (256, 12, 256)])
def test_probe_plain_matches_ref_and_pallas(Q, W, qb):
    q, bk, bv = windows(np.random.default_rng(Q + W), Q, W)
    found, vals = ktag.probe_plain(*(torch.from_numpy(a) for a in
                                     (q, bk, bv)))
    jargs = [jnp.asarray(a) for a in (q, bk, bv)]
    for jf, jv in (probe_ref(*jargs),
                   jax_clht_probe(*jargs, query_block=qb)):
        assert np.array_equal(found.numpy(), np.asarray(jf))
        assert np.array_equal(vals.numpy(), np.asarray(jv))
    assert found.dtype == torch.bool and vals.dtype == torch.int32
    assert found[:3].all()  # query 0 hits a zero lane


def table(seed, n_buckets, n_keys):
    """A chained table of ``n_keys`` random int32 tags (a quarter of
    them repeated under another value: colliding tags) and queries over
    it: hits, misses, query 0, and the extreme int32 values."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(*I32, size=n_keys).astype(np.int32)
    tags[-(n_keys // 4):] = tags[:n_keys // 4]
    values = rng.integers(1, 1 << 31, size=n_keys).astype(np.int32)
    keys, vals, nxt = ktag.tag_table_np(tags, values, n_buckets)
    queries = np.concatenate([
        tags[rng.integers(0, n_keys, size=384)],
        rng.integers(*I32, size=120).astype(np.int32),
        np.array([0, 0, I32[0], I32[1] - 1, -1, 1, 2, 3], np.int32)])
    return queries, keys, vals, nxt, tags, values


@pytest.mark.parametrize("n_buckets,n_keys", [(64, 150), (1024, 2600),
                                              (1000, 700)])
def test_tag_lookup_matches_jax(n_buckets, n_keys):
    q, keys, vals, nxt, _, _ = table(n_buckets, n_buckets, n_keys)
    assert q.shape[0] % 256 == 0  # the Pallas kernel's tile
    found, values = ktag.tag_lookup(
        *(torch.from_numpy(a) for a in (q, keys, vals, nxt)),
        n_buckets=n_buckets)
    jf, jv = jax_tag_lookup(*(jnp.asarray(a) for a in (q, keys, vals, nxt)),
                            n_buckets=n_buckets)
    assert np.array_equal(found.numpy(), np.asarray(jf))
    assert np.array_equal(values.numpy(), np.asarray(jv))
    nf, nv = ktag.tag_lookup_np(q, keys, vals, nxt, n_buckets)
    assert np.array_equal(found.numpy(), nf)
    assert np.array_equal(values.numpy(), nv)
    # query 0 is found with value 0: empty lanes are key 0, value 0
    zero = q == 0
    assert found.numpy()[zero].all() and not values.numpy()[zero].any()
    assert 0 < found.numpy().mean() < 1


def test_tag_table_holds_every_tag_and_the_first_of_a_collision():
    """Every tag whose bucket holds at most 12 earlier tags reads back;
    a tag inserted twice reads back its first value."""
    q, keys, vals, nxt, tags, values = table(5, 512, 1200)
    found, got = ktag.tag_lookup(
        *(torch.from_numpy(a) for a in (tags, keys, vals, nxt)),
        n_buckets=512)
    first = {}
    for t, v in zip(tags.tolist(), values.tolist()):
        first.setdefault(t, v)
    assert found.all()
    assert got.tolist() == [first[t] for t in tags.tolist()]
    assert len(first) < len(tags)  # the table has colliding tags


def test_tag_hash_wraps_like_uint32():
    q = np.array([0, 1, -1, I32[0], I32[1] - 1, 0x12345678, -0x12345678],
                 np.int32)
    for n in (1, 7, 1 << 18, (1 << 32) - 1):
        got = ktag.tag_hash(torch.from_numpy(q), n).numpy()
        z = (q.astype(np.uint32) * np.uint32(0x9E3779B9)).astype(np.uint32)
        z = z ^ (z >> np.uint32(16))
        assert np.array_equal(got, (z % np.uint32(n)).astype(np.int64))


def test_wrapper_takes_any_q_on_the_cpu_and_checks_types():
    q, bk, bv = windows(np.random.default_rng(1), 1001, 40)
    before = dict(ktag.LAUNCHES)
    found, vals = ktag.clht_probe(*(torch.from_numpy(a) for a in
                                    (q, bk, bv)))
    pf, pv = probe_ref(*(jnp.asarray(a) for a in (q, bk, bv)))
    assert np.array_equal(found.numpy(), np.asarray(pf))
    assert np.array_equal(vals.numpy(), np.asarray(pv))
    assert ktag.LAUNCHES == before
    with pytest.raises(TypeError, match="int32"):
        ktag.clht_probe(torch.from_numpy(q).long(), torch.from_numpy(bk),
                        torch.from_numpy(bv))
    with pytest.raises(ValueError, match="windows"):
        ktag.clht_probe(torch.from_numpy(q), torch.from_numpy(bk),
                        torch.from_numpy(bv[:, :3]))
