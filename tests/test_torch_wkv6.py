"""The port's WKV6 plain version (repro_torch, on the CPU) against the
JAX package's oracle ``wkv6_ref``, its Pallas ``wkv6`` in interpret
mode and the model's jnp ``_wkv_chunked``.

Inputs are drawn with numpy from a seed and handed to both packages.
The JAX kernel takes one head's [B*H, T, dh] with a bonus u shared by
all rows; the port takes the model's [B, T, H, dh] with u per head, so
the tests lay the JAX rows out as heads.  Everything is fp32; the
recurrence and the chunked forms sum in other orders, and
``tests/test_kernels.py`` holds the Pallas kernel to its oracle within
5e-4, the tolerance used here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import wkv6 as jax_wkv6
from repro.kernels.rwkv6_scan import wkv6_ref
from repro.models.rwkv import _wkv_chunked
from repro_torch.kernels import rwkv6_scan as kwkv

TOL = 5e-4


def draw(seed, B, T, H, dh, lo=0.001, hi=0.15):
    """r, k, v, logw [B, T, H, dh] and u [H, dh], fp32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
               for _ in range(3))
    logw = -rng.uniform(lo, hi, size=(B, T, H, dh)).astype(np.float32)
    u = rng.normal(size=(H, dh)).astype(np.float32)
    return r, k, v, logw, u


def torch_of(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def rows(a):
    """[1, T, H, dh] -> the JAX kernel's [H, T, dh]."""
    return jnp.asarray(a[0].transpose(1, 0, 2))


def err(t, j):
    return float(np.abs(t.numpy() - np.asarray(j)).max())


@pytest.mark.parametrize("BH,T,dh,chunk", [
    (3, 128, 64, 32), (2, 256, 64, 128), (2, 64, 128, 64), (1, 96, 32, 32),
])
def test_plain_matches_ref_and_pallas(BH, T, dh, chunk):
    """tests/test_kernels.py's four shapes: the JAX rows are the port's
    heads (B = 1, H = BH), u the same for every head."""
    r, k, v, logw, u = draw(BH * T + dh, 1, T, BH, dh)
    u = np.broadcast_to(u[:1], u.shape).copy()
    o, state = kwkv.wkv6_plain(*torch_of(r, k, v, logw, u))
    args = [rows(a) for a in (r, k, v, logw)] + [jnp.asarray(u[0])]
    ref, ref_state = wkv6_ref(*args)
    pallas = jax_wkv6(*args, chunk=chunk)
    o_rows = o[0].transpose(0, 1)
    assert o.dtype == torch.float32 and o.shape == (1, T, BH, dh)
    assert err(o_rows, ref) < TOL
    assert err(o_rows, pallas) < TOL
    assert err(state[0], ref_state) < TOL * 10  # magnitude ~T, fp32 sums


@pytest.mark.parametrize("B,T,H,dh,chunk", [(2, 37, 3, 32, 16),
                                            (1, 300, 2, 64, 256),
                                            (3, 1, 4, 64, 256)])
def test_plain_matches_the_models_chunked_form(B, T, H, dh, chunk):
    """Ragged T (the jnp form pads to whole chunks) and T = 1, in the
    model's layout, output and final state."""
    r, k, v, logw, u = draw(T + H, B, T, H, dh)
    o, state = kwkv.wkv6_plain(*torch_of(r, k, v, logw, u))
    y, final = _wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                            chunk)
    assert err(o, y) < TOL
    assert err(state, final) < TOL * 10


def test_ragged_t_and_final_state_match_ref():
    """T = 37, not a multiple of any chunk; the final state per head."""
    r, k, v, logw, u = draw(5, 1, 37, 2, 64)
    o, state = kwkv.wkv6_plain(*torch_of(r, k, v, logw, u))
    for h in range(2):
        ref, ref_state = wkv6_ref(*(jnp.asarray(a[0, :, h][None])
                                    for a in (r, k, v, logw)),
                                  jnp.asarray(u[h]))
        assert err(o[:, :, h], ref) < TOL
        assert err(state[:, h], ref_state) < TOL * 10


def test_strong_decay_at_chunk_256():
    """logw down to -8: the Pallas kernel's factored exp(-cum) overflows
    fp32 at its model's chunk of 256 (its docstring holds it exact only
    for chunks of 128 or less), while the recurrence, the jnp chunked
    form and the port's plain version stay finite and agree."""
    r, k, v, logw, u = draw(7, 1, 256, 2, 64, lo=0.5, hi=8.0)
    o, state = kwkv.wkv6_plain(*torch_of(r, k, v, logw, u))
    assert torch.isfinite(o).all() and torch.isfinite(state).all()
    args = [rows(a) for a in (r, k, v, logw)]
    u0 = np.broadcast_to(u[:1], u.shape).copy()
    o0, _ = kwkv.wkv6_plain(*torch_of(r, k, v, logw, u0))
    ref, _ = wkv6_ref(*args, jnp.asarray(u0[0]))
    assert err(o0[0].transpose(0, 1), ref) < TOL
    pallas = np.asarray(jax_wkv6(*args, jnp.asarray(u0[0]), chunk=256))
    assert not np.isfinite(pallas).all()
    y, final = _wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                            256)
    # the jnp form subtracts prefix sums of logw that reach about -1000
    # over the chunk, so each exponent carries fp32's absolute error at
    # that magnitude (about 6e-5): held relative to the largest output
    assert err(o, y) < 2e-4 * float(np.abs(np.asarray(y)).max())
    assert err(state, final) < 2e-4 * float(np.abs(np.asarray(final)).max())


def test_state_carries_across_calls():
    """Splitting T at any point and carrying the state gives the one-call
    output and state; T = 1 steps are decode."""
    r, k, v, logw, u = (torch.from_numpy(a) for a in draw(9, 2, 20, 3, 32))
    whole, s_whole = kwkv.wkv6(r, k, v, logw, u)
    head, s = kwkv.wkv6(r[:, :7], k[:, :7], v[:, :7], logw[:, :7], u)
    outs = [head]
    for t in range(7, 20):
        o, s = kwkv.wkv6_heads(r[:, t:t + 1], k[:, t:t + 1], v[:, t:t + 1],
                               logw[:, t:t + 1], u, s)
        outs.append(o)
    assert float((torch.cat(outs, 1) - whole).abs().max()) < 1e-5
    assert float((s - s_whole).abs().max()) < 1e-5


def test_wrapper_runs_the_plain_version_on_the_cpu_and_checks_shapes():
    r, k, v, logw, u = (torch.from_numpy(a) for a in draw(3, 1, 5, 2, 32))
    before = dict(kwkv.LAUNCHES)
    o, s = kwkv.wkv6(r.to(torch.bfloat16), k.to(torch.bfloat16),
                     v.to(torch.bfloat16), logw, u)
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert kwkv.LAUNCHES == before  # a CPU call launches nothing
    with pytest.raises(ValueError, match="u must be"):
        kwkv.wkv6(r, k, v, logw, u[:1])
    with pytest.raises(ValueError, match="state must be"):
        kwkv.wkv6(r, k, v, logw, u, torch.zeros(1, 2, 32, 31))
    with pytest.raises(TypeError, match="k is"):
        kwkv.wkv6(r, k.double(), v, logw, u)
