"""Shard routing on the port (repro_torch, device="cpu") against the
JAX package, bit for bit.

``route_shards(device=cpu)`` runs the port's ``shard_route`` wrapper on
CPU tensors, i.e. its plain PyTorch version ``shard_route_plain``; it
is held against the JAX package's Pallas ``shard_route`` in interpret
mode (``route_shards(use_kernel=True)``) and its numpy oracle, on hash,
``prefix``, ``prefix@58`` (which straddled the key's halves on the
TPU) and ``prefix@31``, for 1 to 32 shards, with keys of 0 and of 2^63
and above.  No tolerance: shard ids are integers.
"""

import numpy as np
import pytest
import torch

from repro.kernels.partition import route_ref as jax_route_ref
from repro.kernels.partition import route_shards as jax_route_shards
from repro_torch.kernels import partition as tpart

CPU = torch.device("cpu")
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern


def route_keys(seed, n):
    rng = np.random.default_rng(seed)
    keys = rng.integers(HIGH, (1 << 63) - 1, size=n, dtype=np.int64)
    keys[: n // 2] = rng.integers(1, 1 << 62, size=n // 2)
    keys[:8] = [0, 1, HIGH, -1, (1 << 63) - 1, 1 << 62, (1 << 58) + 3,
                (1 << 31) - 1]
    return keys


@pytest.mark.parametrize("n_shards", [1, 2, 8, 32])
@pytest.mark.parametrize("scheme", ["hash", "prefix", "prefix@58",
                                    "prefix@31"])
def test_shard_route_plain_matches_jax_kernel(scheme, n_shards):
    keys = route_keys(n_shards, 1000)
    got = tpart.route_shards(keys, n_shards, scheme, device=CPU)
    ref = jax_route_shards(keys, n_shards, scheme, use_kernel=True,
                           interpret=True)
    assert got.dtype == np.int32 and got.shape == keys.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_route_ref(keys, n_shards, scheme))
    assert int(got.min()) >= 0 and int(got.max()) < n_shards
    if n_shards > 1:
        assert np.unique(got).size > 1


def test_route_shards_host_default_is_the_oracle():
    keys = route_keys(3, 500)
    for scheme in ("hash", "prefix", "prefix@58"):
        np.testing.assert_array_equal(
            tpart.route_shards(keys, 16, scheme),
            jax_route_shards(keys, 16, scheme))
    for device in (None, CPU):
        empty = tpart.route_shards(keys[:0], 8, device=device)
        assert empty.shape == (0,) and empty.dtype == np.int32


def test_shard_route_cpu_runs_plain_version_and_counts_no_launch():
    keys = torch.from_numpy(route_keys(4, 300))
    before = dict(tpart.LAUNCHES)
    for scheme in ("hash", "prefix@58"):
        bits, shift = tpart.route_params(8, scheme)
        got = tpart.shard_route(keys, bits=bits, shift=shift)
        assert torch.equal(got, tpart.shard_route_plain(keys, bits=bits,
                                                        shift=shift))
    assert tpart.LAUNCHES == before
    assert tpart.route_params(1, "hash") == (0, -1)
    assert tpart.route_params(8, "prefix") == (3, 60)
    assert tpart.route_params(4, "prefix@58") == (2, 57)


def test_shard_route_rejects_bad_inputs():
    keys = torch.from_numpy(route_keys(5, 64))
    with pytest.raises(TypeError):
        tpart.shard_route(keys.to(torch.int32), bits=2, shift=-1)
    with pytest.raises(ValueError):
        tpart.shard_route(keys[::2], bits=2, shift=-1)
    with pytest.raises(ValueError):
        tpart.shard_route(keys, bits=32, shift=-1)
    with pytest.raises(ValueError):
        tpart.shard_route(keys, bits=4, shift=61)
    with pytest.raises(ValueError):
        tpart.route_params(4, "range")
    with pytest.raises(AssertionError):
        tpart.route_params(6, "hash")
