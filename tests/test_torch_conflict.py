"""Plan-conflict admission on the port (repro_torch, device="cpu")
against the JAX package, bit for bit.

``conflict_any(device=cpu)`` runs the port's wrapper on CPU tensors,
i.e. its plain PyTorch version ``conflict_any_plain``; it is held
against the JAX package's Pallas ``conflict_any_kernel`` in interpret
mode (``conflict_any(use_kernel=True)``) and its numpy oracle, with
``writes_conflict`` both ways, over keys drawn from a small pool (so
same-key pairs are common) that holds key 0 and keys of 2^63 and above
(the window test is signed 64-bit order in all three), and with empty
sets.  No tolerance: the outputs are booleans.
"""

import numpy as np
import pytest
import torch

from repro.kernels.conflict import conflict_any as jax_conflict_any
from repro.kernels.conflict import conflict_any_ref as jax_conflict_any_ref
from repro_torch.kernels import conflict as tconf

CPU = torch.device("cpu")
HIGH = -(1 << 63)  # 2^63 as an int64 bit pattern


def op_sets(seed, n_a, n_b):
    """Candidate and reference ops over a pool of about 4 keys per
    reference op: same-key pairs are common, and so are candidates
    that conflict with nothing."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(HIGH, (1 << 63) - 1, size=max(48, 4 * n_b))
    pool[:5] = [0, HIGH, -1, (1 << 63) - 1, 1]
    ka = rng.integers(0, 5, size=n_a).astype(np.int32)
    kb = rng.integers(0, 5, size=n_b).astype(np.int32)
    return ka, rng.choice(pool, n_a), kb, rng.choice(pool, n_b)


@pytest.mark.parametrize("writes_conflict", [False, True])
@pytest.mark.parametrize("n_a,n_b", [(1, 1), (600, 300), (700, 1100),
                                     (40, 0), (0, 20)])
def test_conflict_any_plain_matches_jax_kernel(n_a, n_b, writes_conflict):
    ka, xa, kb, xb = op_sets(n_a * 7 + n_b, n_a, n_b)
    got = tconf.conflict_any(ka, xa, kb, xb,
                             writes_conflict=writes_conflict, device=CPU)
    ref = jax_conflict_any(ka, xa, kb, xb, writes_conflict=writes_conflict,
                           use_kernel=True, interpret=True)
    assert got.dtype == bool and got.shape == (n_a,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jax_conflict_any_ref(ka, xa, kb, xb,
                                  writes_conflict=writes_conflict))
    np.testing.assert_array_equal(
        got, tconf.conflict_any(ka, xa, kb, xb,
                                writes_conflict=writes_conflict))
    if n_a > 1 and n_b > 1:
        assert 0 < int(got.sum()) < n_a


def test_window_order_is_signed_64_bit():
    """A write of key 2^63 (negative as int64) lands in no scan window
    that starts at a positive key, and in every window that starts at
    or below it; the TPU kernel's split-half compare agrees."""
    ka = np.array([4, 4, 4, 1], np.int32)        # SCAN, SCAN, SCAN, PUT
    xa = np.array([5, HIGH, HIGH + 1, 7], np.int64)
    kb = np.array([1, 4], np.int32)              # PUT 2^63, SCAN from 8
    xb = np.array([HIGH, 8], np.int64)
    want = np.array([False, True, False, False])
    for got in (tconf.conflict_any(ka, xa, kb, xb, device=CPU),
                tconf.conflict_any(ka, xa, kb, xb),
                jax_conflict_any(ka, xa, kb, xb, use_kernel=True)):
        np.testing.assert_array_equal(got, want)


def test_conflict_any_cpu_runs_plain_version_and_counts_no_launch():
    ka, xa, kb, xb = (torch.from_numpy(a) for a in op_sets(9, 200, 150))
    before = dict(tconf.LAUNCHES)
    got = tconf.kernel.conflict_any(ka, xa, kb, xb, writes_conflict=True)
    assert tconf.LAUNCHES == before
    assert torch.equal(got, tconf.conflict_any_plain(ka, xa, kb, xb,
                                                     writes_conflict=True))
    empty = tconf.kernel.conflict_any(ka, xa, kb[:0], xb[:0])
    assert empty.dtype == torch.bool and not bool(empty.any())


def test_conflict_any_rejects_bad_inputs():
    ka, xa, kb, xb = (torch.from_numpy(a) for a in op_sets(10, 20, 10))
    with pytest.raises(TypeError):
        tconf.kernel.conflict_any(ka.to(torch.int64), xa, kb, xb)
    with pytest.raises(ValueError):
        tconf.kernel.conflict_any(ka, xa[:-1], kb, xb)
    with pytest.raises(ValueError):
        tconf.kernel.conflict_any(ka, xa, kb[::2], xb[::2])
