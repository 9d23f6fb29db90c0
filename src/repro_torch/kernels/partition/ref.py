"""Shard routing on the host — the write-path partitioner.

Copied from the JAX package's ``kernels/partition/ref.py``.  Two
routing schemes, both mapping int64 PM keys onto a power-of-two shard
count:

* ``hash``   — top ``log2(n_shards)`` bits of the splitmix64 finalizer
  (bit-for-bit ``core.clht._mix``), so shard placement is uniform
  regardless of key skew.  Used by the unordered indexes.
* ``prefix`` — top bits of the key itself (keys are PM words in
  ``[0, 2^63)``, so bit 62 downward); ``prefix@<m>`` routes on bit
  ``m`` downward instead.  Used by the ordered indexes.

The routes run in numpy ``uint64``, which has the logical right shifts
splitmix64 needs.  ``shard_route_plain`` is the plain PyTorch version
of the CUDA routing kernel (``csrc/shard_route.cu``): the same routes on
int64 tensors, where multiplies wrap modulo 2^64 and each right shift of
the hash is masked to make it logical.  ``shard_partition_plain`` is the
plain version of the partition kernel of the same source: that route,
a stable sort of the ids, a bincount and a cumsum, as ``partition_ref``
computes them in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

_U64 = np.uint64


def prefix_msb(scheme: str) -> int:
    """The highest routed bit of a prefix scheme: 62 for ``prefix``
    (63-bit PM words), ``m`` for ``prefix@<m>``."""
    if scheme == "prefix":
        return 62
    msb = int(scheme.split("@", 1)[1])
    if not 0 < msb <= 62:
        raise ValueError(f"prefix msb out of range in {scheme!r}")
    return msb


def mix64_ref(keys: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer — must match core.clht._mix."""
    z = np.asarray(keys).astype(np.uint64) + _U64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def route_ref(keys: np.ndarray, n_shards: int,
              scheme: str = "hash") -> np.ndarray:
    """Shard id per key: [Q] int32 in [0, n_shards)."""
    assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0, \
        f"n_shards must be a power of two, got {n_shards}"
    keys = np.asarray(keys, np.int64)
    if n_shards == 1:
        return np.zeros(keys.shape, np.int32)
    b = n_shards.bit_length() - 1
    if scheme == "hash":
        return (mix64_ref(keys) >> _U64(64 - b)).astype(np.int32)
    if scheme.startswith("prefix"):
        msb = prefix_msb(scheme)
        assert msb + 1 - b >= 0, (scheme, n_shards)
        return ((keys >> np.int64(msb + 1 - b)) & np.int64(n_shards - 1)
                ).astype(np.int32)
    raise ValueError(f"unknown shard scheme {scheme!r}")


def partition_ref(keys: np.ndarray, n_shards: int, scheme: str = "hash"):
    """(shards [Q] int32, order [Q] int64, offsets [n_shards+1] int64):
    ``order`` is the *stable* sort-by-shard permutation (same-shard ops
    keep their arrival order — same-key ops always share a shard, so
    per-key history is preserved); ``offsets[s]:offsets[s+1]`` indexes
    shard ``s``'s run within ``order``."""
    shards = route_ref(keys, n_shards, scheme)
    order = np.argsort(shards, kind="stable")
    counts = np.bincount(shards, minlength=n_shards)
    offsets = np.zeros(n_shards + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return shards, order, offsets


def route_params(n_shards: int, scheme: str) -> tuple:
    """(bits, shift) of a route: ``bits = log2(n_shards)``; ``shift`` is
    -1 for ``hash`` and ``msb + 1 - bits`` for a prefix scheme."""
    assert n_shards >= 1 and (n_shards & (n_shards - 1)) == 0, \
        f"n_shards must be a power of two, got {n_shards}"
    bits = n_shards.bit_length() - 1
    if bits > 31:
        raise ValueError(f"at most 2^31 shards, got {n_shards}")
    if scheme == "hash":
        return bits, -1
    if scheme.startswith("prefix"):
        shift = prefix_msb(scheme) + 1 - bits
        assert shift >= 0, (scheme, n_shards)
        return bits, shift
    raise ValueError(f"unknown shard scheme {scheme!r}")


def shard_route_plain(keys: torch.Tensor, *, bits: int, shift: int
                      ) -> torch.Tensor:
    """keys: [Q] int64.  Returns [Q] int32 shard ids: 0 when ``bits``
    is 0, else the top ``bits`` of splitmix64 (``shift`` < 0) or key
    bits [shift, shift + bits)."""
    # the torch splitmix64 lives with the probe, whose fingerprints
    # import this module's numpy hash: import it here, not at the top
    from ..probe.ref import _shr, mix64
    if bits == 0:
        return torch.zeros(keys.shape, dtype=torch.int32, device=keys.device)
    if shift < 0:
        return _shr(mix64(keys), 64 - bits).to(torch.int32)
    return (_shr(keys, shift) & ((1 << bits) - 1)).to(torch.int32)


def shard_partition_plain(keys: torch.Tensor, *, bits: int, shift: int):
    """keys: [Q] int64.  Returns (shards [Q], order [Q], offsets
    [2^bits + 1]) int32: ``shard_route_plain``'s ids, the stable
    sort-by-shard permutation and the per-shard run offsets."""
    shards = shard_route_plain(keys, bits=bits, shift=shift)
    order = torch.sort(shards, stable=True).indices.to(torch.int32)
    offsets = torch.zeros((1 << bits) + 1, dtype=torch.int32,
                          device=keys.device)
    offsets[1:] = torch.cumsum(torch.bincount(shards, minlength=1 << bits),
                               0)
    return shards, order, offsets
