"""The port's SSD plain version (repro_torch, on the CPU) against the
JAX package's oracle ``ssd_ref``, its Pallas ``ssd`` in interpret mode,
its ``ssd_heads`` wrapper and the model's jnp ``_ssd_chunked``.

Inputs are drawn with numpy from a seed and handed to both packages.
The JAX kernel takes [B*H, T, ...] rows with B_ and C_ per row; the port
takes the model's layout, x [B, T, H, dh] with B_ and C_ [B, T, N]
shared by every head of a batch row, so the kernel tests lay the JAX
rows out as heads of one batch row, with one B_ and C_ for all of them
and A per row.  Everything is fp32; the recurrence and the chunked
forms sum in other orders, and ``tests/test_kernels.py`` holds the
Pallas kernel to its oracle within 5e-4, the tolerance used here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan import ssd as jax_ssd
from repro.kernels.mamba_scan import ssd_heads as jax_ssd_heads
from repro.kernels.mamba_scan import ssd_ref
from repro.models.mamba import _ssd_chunked
from repro_torch.kernels import mamba_scan as kssd

TOL = 5e-4


def draw(seed, B, T, H, dh, N):
    """x [B, T, H, dh], dt [B, T, H] in [0.001, 0.4], B_ and C_
    [B, T, N], A [H] in [-1.5, -0.3] (tests/test_kernels.py's ranges),
    fp32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T, H, dh)).astype(np.float32)
    dt = rng.uniform(0.001, 0.4, size=(B, T, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32)
              for _ in range(2))
    A = -rng.uniform(0.3, 1.5, size=(H,)).astype(np.float32)
    return x, dt, Bm, Cm, A


def torch_of(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def as_rows(x, dt, Bm, Cm, A):
    """One batch row's heads -> the JAX kernel's [H, T, ...] rows, B_ and
    C_ copied into every row."""
    H = x.shape[2]
    T, N = Bm.shape[1:]
    return (jnp.asarray(x[0].transpose(1, 0, 2)), jnp.asarray(dt[0].T),
            jnp.asarray(np.broadcast_to(Bm[0], (H, T, N))),
            jnp.asarray(np.broadcast_to(Cm[0], (H, T, N))), jnp.asarray(A))


def err(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


@pytest.mark.parametrize("BH,T,dh,N,chunk", [
    (3, 128, 64, 16, 32), (2, 256, 128, 16, 128), (2, 64, 64, 8, 64),
])
def test_plain_matches_ref_and_pallas(BH, T, dh, N, chunk):
    """tests/test_kernels.py's three shapes: the JAX rows are the port's
    heads (B = 1, H = BH), each with its own A."""
    args = draw(BH * T + dh + N, 1, T, BH, dh, N)
    y, state = kssd.ssd_plain(*torch_of(*args))
    rows = as_rows(*args)
    ref, ref_state = ssd_ref(*rows)
    pallas = jax_ssd(*rows, chunk=chunk)
    y_rows = y[0].transpose(0, 1)
    assert y.dtype == torch.float32 and y.shape == (1, T, BH, dh)
    assert state.shape == (1, BH, dh, N)
    assert err(y_rows, ref) < TOL
    assert err(y_rows, pallas) < TOL
    assert err(state[0], ref_state) < TOL


def test_plain_matches_the_ssd_heads_wrapper():
    """tests/test_kernels.py's wrapper shape, in the model's layout: two
    batch rows, each with its own B_ and C_ shared by its heads."""
    x, dt, Bm, Cm, A = draw(11, 2, 64, 2, 32, 8)
    y, _ = kssd.ssd_heads(*torch_of(x, dt, Bm, Cm, A))
    want = jax_ssd_heads(*(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)),
                         chunk=32)
    assert err(y, want) < TOL


@pytest.mark.parametrize("B,T,H,dh,N,chunk", [
    (2, 37, 3, 32, 8, 16),    # ragged T: the jnp form pads with dt = 0
    (1, 300, 2, 64, 16, 256),
    (3, 1, 4, 64, 16, 256),   # one step: decode
    (2, 64, 8, 32, 8, 16),    # jamba-1.5-large-398b.reduced()'s widths
])
def test_plain_matches_the_models_chunked_form(B, T, H, dh, N, chunk):
    """Per-batch B_ and C_, output and final state."""
    args = draw(T + H + N, B, T, H, dh, N)
    y, state = kssd.ssd_plain(*torch_of(*args))
    want, final = _ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    assert err(y, want) < TOL
    assert err(state, final) < TOL


def test_ragged_t_and_final_state_match_ref():
    """T = 37, not a multiple of any chunk; each batch row's heads."""
    x, dt, Bm, Cm, A = draw(5, 2, 37, 3, 64, 16)
    y, state = kssd.ssd_plain(*torch_of(x, dt, Bm, Cm, A))
    for b in range(2):
        one = [a[b:b + 1] for a in (x, dt, Bm, Cm)] + [A]
        ref, ref_state = ssd_ref(*as_rows(*one))
        assert err(y[b].transpose(0, 1), ref) < TOL
        assert err(state[b], ref_state) < TOL


@pytest.mark.parametrize("split", [1, 16, 37])
def test_state_carries_across_calls(split):
    """Two halves chained through the state equal the whole sequence;
    T = 1 steps from the carried state are decode."""
    x, dt, Bm, Cm, A = torch_of(*draw(9, 2, 50, 3, 32, 8))
    whole, s_whole = kssd.ssd(x, dt, Bm, Cm, A)
    head, s = kssd.ssd(x[:, :split], dt[:, :split], Bm[:, :split],
                       Cm[:, :split], A)
    tail, s = kssd.ssd_heads(x[:, split:], dt[:, split:], Bm[:, split:],
                             Cm[:, split:], A, s)
    assert float((torch.cat([head, tail], 1) - whole).abs().max()) < 1e-5
    assert float((s - s_whole).abs().max()) < 1e-5
    outs, s = [], None
    for t in range(50):
        o, s = kssd.ssd_heads(x[:, t:t + 1], dt[:, t:t + 1], Bm[:, t:t + 1],
                              Cm[:, t:t + 1], A, s)
        outs.append(o)
    assert float((torch.cat(outs, 1) - whole).abs().max()) < 1e-5
    assert float((s - s_whole).abs().max()) < 1e-5


def test_wrapper_runs_the_plain_version_on_the_cpu_and_checks_shapes():
    x, dt, Bm, Cm, A = torch_of(*draw(3, 1, 5, 2, 32, 8))
    before = dict(kssd.LAUNCHES)
    y, s = kssd.ssd(x.to(torch.bfloat16), dt, Bm.to(torch.bfloat16),
                    Cm.to(torch.bfloat16), A)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert kssd.LAUNCHES == before  # a CPU call launches nothing
    with pytest.raises(ValueError, match="A must be"):
        kssd.ssd(x, dt, Bm, Cm, A[:1])
    with pytest.raises(ValueError, match="dt must be"):
        kssd.ssd(x, dt[:, :4], Bm, Cm, A)
    with pytest.raises(ValueError, match="B_ and C_"):
        kssd.ssd(x, dt, Bm, Cm[..., :4], A)
    with pytest.raises(ValueError, match="state must be"):
        kssd.ssd(x, dt, Bm, Cm, A, torch.zeros(1, 2, 32, 7))
    with pytest.raises(TypeError, match="B_ is"):
        kssd.ssd(x, dt, Bm.double(), Cm, A)
