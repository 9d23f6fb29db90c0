"""The scans' gradients on the CPU: the port's plain backward versions
(``wkv6_bwd_plain``, ``ssd_bwd_plain``) against ``jax.vjp`` of the JAX
package's jnp chunked forms (``_wkv_chunked``, ``_ssd_chunked``, which
the JAX train step differentiates) and against ``torch.autograd``
through the plain forward versions; ``wkv6_heads`` and ``ssd_heads``
(autograd Functions over the kernels' wrappers, which run the plain
versions on CPU tensors) under float64 finite differences.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: against ``jax.vjp``, every gradient within 2e-4 of its
largest magnitude (fp32; the chunked form sums in another order and
factors its decays, where the plain version runs the step recurrence:
the forward tests hold the two to 5e-4 absolute); against
``torch.autograd`` of the plain forward, 1e-5 of the largest magnitude
(the same fp32 recurrence, differentiated by hand and by autograd);
``gradcheck`` at its float64 defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba import _ssd_chunked
from repro.models.rwkv import _wkv_chunked
from repro_torch.kernels import mamba_scan as kssd
from repro_torch.kernels import rwkv6_scan as kwkv

JAX_TOL = 2e-4
AUTOGRAD_TOL = 1e-5


def rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got,
                     np.float64)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-30)


def wkv_draw(seed, B, T, H, dh, lo, hi, carried=False):
    """r, k, v, do [B, T, H, dh], logw log-uniform in [-hi, -lo], u
    [H, dh], and with ``carried`` a state and the final state's
    gradient, fp32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v, do = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
                   for _ in range(4))
    logw = -np.exp(rng.uniform(np.log(lo), np.log(hi),
                               size=(B, T, H, dh))).astype(np.float32)
    u = rng.normal(size=(H, dh)).astype(np.float32)
    state, dstate = (rng.normal(size=(B, H, dh, dh)).astype(np.float32)
                     if carried else None for _ in range(2))
    return r, k, v, logw, u, do, state, dstate


def ssd_draw(seed, B, T, H, dh, N, dt_lo, dt_hi, carried=False):
    """x, dy [B, T, H, dh], dt uniform in [dt_lo, dt_hi], B_, C_ [B, T,
    N], A in [-1.5, -0.3], and with ``carried`` a state and the final
    state's gradient, fp32 numpy."""
    rng = np.random.default_rng(seed)
    x, dy = (rng.normal(size=(B, T, H, dh)).astype(np.float32)
             for _ in range(2))
    dt = rng.uniform(dt_lo, dt_hi, size=(B, T, H)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, T, N)).astype(np.float32)
              for _ in range(2))
    A = -rng.uniform(0.3, 1.5, size=H).astype(np.float32)
    state, dstate = (rng.normal(size=(B, H, dh, N)).astype(np.float32)
                     if carried else None for _ in range(2))
    return x, dt, Bm, Cm, A, dy, state, dstate


def torch_of(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


# ----------------------------------------------------------------------
# against jax.vjp of the model's chunked forms
# ----------------------------------------------------------------------
@pytest.mark.parametrize("B,T,H,dh,chunk,lo,hi", [
    (2, 37, 3, 32, 16, 1e-3, 0.5),     # ragged T over the chunk
    (1, 64, 2, 64, 16, 1e-3, 20.0),    # strong decays, logw to -20
    (1, 40, 2, 32, 16, 1e-6, 1e-3),    # decays near 0 (w near 1)
    (2, 1, 2, 64, 16, 1e-3, 8.0),      # T = 1
    (1, 50, 1, 64, 256, 0.01, 3.0),    # one chunk longer than T
], ids=["ragged", "strong-decay", "weak-decay", "T1", "one-chunk"])
def test_wkv6_bwd_plain_matches_jax_vjp(B, T, H, dh, chunk, lo, hi):
    """dr, dk, dv, dlogw and du from the output's and the final state's
    gradients."""
    r, k, v, logw, u, do, _, _ = wkv_draw(T * 7 + dh, B, T, H, dh, lo, hi)
    dfinal = np.random.default_rng(T).normal(
        size=(B, H, dh, dh)).astype(np.float32)
    (y, final), vjp = jax.vjp(
        lambda *a: _wkv_chunked(*a, chunk),
        *(jnp.asarray(a) for a in (r, k, v, logw, u)))
    want = vjp((jnp.asarray(do), jnp.asarray(dfinal)))
    got = kwkv.wkv6_bwd_plain(*torch_of(r, k, v, logw, u, do), None,
                              torch.from_numpy(dfinal))
    assert got[5] is None  # no input state, no gradient for it
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert rel(g, w) <= JAX_TOL, (name, rel(g, w))


@pytest.mark.parametrize("B,T,H,dh,N,chunk,dt_lo,dt_hi", [
    (2, 37, 3, 32, 8, 16, 1e-3, 0.4),      # ragged T over the chunk
    (1, 64, 2, 64, 16, 16, 1e-3, 0.4),     # Jamba's dh and N
    (1, 40, 2, 32, 16, 16, 1e-5, 1e-3),    # small dt
    (1, 48, 2, 64, 8, 16, 2.0, 8.0),       # strong decay (dt A to -12)
    (2, 1, 2, 32, 8, 16, 1e-3, 0.4),       # T = 1
], ids=["ragged", "jamba-widths", "small-dt", "strong-decay", "T1"])
def test_ssd_bwd_plain_matches_jax_vjp(B, T, H, dh, N, chunk, dt_lo, dt_hi):
    """dx, ddt, dB_, dC_ (summed over heads) and dA from the output's
    and the final state's gradients."""
    x, dt, Bm, Cm, A, dy, _, _ = ssd_draw(T * 5 + dh + N, B, T, H, dh, N,
                                          dt_lo, dt_hi)
    dfinal = np.random.default_rng(T + 1).normal(
        size=(B, H, dh, N)).astype(np.float32)
    (y, final), vjp = jax.vjp(
        lambda *a: _ssd_chunked(*a, chunk),
        *(jnp.asarray(a) for a in (x, dt, Bm, Cm, A)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfinal)))
    got = kssd.ssd_bwd_plain(*torch_of(x, dt, Bm, Cm, A, dy), None,
                             torch.from_numpy(dfinal))
    assert got[5] is None
    for name, g, w in zip(("dx", "ddt", "dB_", "dC_", "dA"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert rel(g, w) <= JAX_TOL, (name, rel(g, w))


# ----------------------------------------------------------------------
# against torch.autograd of the plain forward, a carried state included
# ----------------------------------------------------------------------
def autograd_of(fn, inputs, grads_out):
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in inputs]
    outs = fn(*leaves)
    loss = sum((o * g).sum() for o, g in zip(outs, grads_out)
               if g is not None)
    used = [t for t in leaves if t is not None]
    want = torch.autograd.grad(loss, used, allow_unused=True)
    # at T = 1 with no final state gradient, logw reaches no output
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(used, want)]


@pytest.mark.parametrize("carried", [True, False], ids=["state", "no-state"])
@pytest.mark.parametrize("T,dh,hi", [(37, 32, 0.5), (20, 64, 20.0),
                                     (1, 32, 8.0)])
def test_wkv6_bwd_plain_matches_autograd(T, dh, hi, carried):
    """Every gradient, the input state's too, with and without a final
    state gradient."""
    r, k, v, logw, u, do, state, dstate = wkv_draw(T + dh, 2, T, 2, dh,
                                                   1e-3, hi, carried)
    args = torch_of(r, k, v, logw, u, state)
    do_t, ds_t = torch_of(do, dstate)
    want = autograd_of(kwkv.wkv6_plain, args, (do_t, ds_t))
    got = kwkv.wkv6_bwd_plain(*args[:5], do_t, args[5], ds_t)
    assert (got[5] is None) == (not carried)
    for g, w in zip([t for t in got if t is not None], want):
        assert rel(g, w.numpy()) <= AUTOGRAD_TOL


@pytest.mark.parametrize("carried", [True, False], ids=["state", "no-state"])
@pytest.mark.parametrize("T,dh,N", [(37, 32, 8), (20, 64, 16), (1, 32, 16)])
def test_ssd_bwd_plain_matches_autograd(T, dh, N, carried):
    x, dt, Bm, Cm, A, dy, state, dstate = ssd_draw(T + dh + N, 2, T, 3, dh,
                                                   N, 1e-3, 0.4, carried)
    args = torch_of(x, dt, Bm, Cm, A, state)
    dy_t, ds_t = torch_of(dy, dstate)
    want = autograd_of(kssd.ssd_plain, args, (dy_t, ds_t))
    got = kssd.ssd_bwd_plain(*args[:5], dy_t, args[5], ds_t)
    assert (got[5] is None) == (not carried)
    for g, w in zip([t for t in got if t is not None], want):
        assert rel(g, w.numpy()) <= AUTOGRAD_TOL


# ----------------------------------------------------------------------
# the differentiable ops
# ----------------------------------------------------------------------
def f64(a):
    return torch.from_numpy(a.astype(np.float64)).requires_grad_()


@pytest.mark.parametrize("carried", [True, False], ids=["state", "no-state"])
def test_wkv6_heads_gradcheck_float64(carried):
    """Finite differences of output and final state (the plain versions
    compute in float64 for float64 inputs), strong decays included."""
    r, k, v, logw, u, _, state, _ = wkv_draw(3, 2, 7, 2, 4, 1e-3, 6.0,
                                             carried)
    args = [f64(a) for a in (r, k, v, logw, u)] + [
        f64(state) if carried else None]
    assert torch.autograd.gradcheck(lambda *a: kwkv.wkv6_heads(*a), args)


@pytest.mark.parametrize("carried", [True, False], ids=["state", "no-state"])
def test_ssd_heads_gradcheck_float64(carried):
    x, dt, Bm, Cm, A, _, state, _ = ssd_draw(4, 2, 7, 3, 4, 3, 1e-3, 0.8,
                                             carried)
    args = [f64(a) for a in (x, dt, Bm, Cm, A)] + [
        f64(state) if carried else None]
    assert torch.autograd.gradcheck(lambda *a: kssd.ssd_heads(*a), args)


def test_ops_take_a_final_state_gradient_of_none_or_zeros():
    """A trainer drops the final state: autograd hands the backward
    zeros (or None), and both give the same gradients; the output's
    gradient may arrive strided."""
    r, k, v, logw, u, do, _, _ = wkv_draw(8, 1, 9, 2, 32, 1e-3, 2.0)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (r, k, v, logw, u)]
    out, final = kwkv.wkv6_heads(*leaves)
    strided = torch.from_numpy(do).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    assert not strided.is_contiguous()
    got = torch.autograd.grad((out * strided).sum(), leaves)
    want = kwkv.wkv6_bwd_plain(*(t.detach() for t in leaves),
                               torch.from_numpy(do))
    for g, w in zip(got, want[:5]):
        assert torch.equal(g, w)
    zeros = kwkv.wkv6_bwd_plain(*(t.detach() for t in leaves),
                                torch.from_numpy(do),
                                dstate=torch.zeros(1, 2, 32, 32))
    for a, b in zip(want[:5], zeros[:5]):
        assert torch.equal(a, b)
    x, dt, Bm, Cm, A, dy, _, _ = ssd_draw(9, 1, 9, 2, 32, 8, 1e-3, 0.4)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (x, dt, Bm, Cm, A)]
    y, final = kssd.ssd_heads(*leaves)
    got = torch.autograd.grad((y * torch.from_numpy(dy)).sum(), leaves)
    want = kssd.ssd_bwd_plain(*(t.detach() for t in leaves),
                              torch.from_numpy(dy))
    for g, w in zip(got, want[:5]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,T,H", [(0, 5, 2), (2, 0, 2), (2, 5, 0)],
                         ids=["B0", "T0", "H0"])
def test_bwd_wrappers_take_empty_inputs(B, T, H):
    """B, T or H of 0 follow the forward's conventions: empty gradients,
    du and dA zero, the input state's gradient the final state's."""
    dh, N = 32, 8
    z = torch.zeros
    state = torch.randn(B, H, dh, dh)
    dstate = torch.randn(B, H, dh, dh)
    got = kwkv.wkv6_bwd(z(B, T, H, dh), z(B, T, H, dh), z(B, T, H, dh),
                        z(B, T, H, dh), z(H, dh), z(B, T, H, dh), state,
                        dstate)
    assert [tuple(t.shape) for t in got] == [(B, T, H, dh)] * 4 + [
        (H, dh), (B, H, dh, dh)]
    assert not bool(got[4].any())
    assert torch.equal(got[5], dstate)
    sstate = torch.randn(B, H, dh, N)
    got = kssd.ssd_bwd(z(B, T, H, dh), z(B, T, H), z(B, T, N), z(B, T, N),
                       -torch.ones(H), z(B, T, H, dh), sstate, None)
    assert [tuple(t.shape) for t in got] == [
        (B, T, H, dh), (B, T, H), (B, T, N), (B, T, N), (H,),
        (B, H, dh, N)]
    assert not bool(got[4].any())
    if T == 0:
        assert not bool(got[5].any())


def test_bwd_wrappers_check_their_inputs_and_refuse_grad():
    r, k, v, logw, u, do, state, _ = wkv_draw(1, 1, 4, 2, 32, 1e-3, 1.0,
                                              True)
    args = torch_of(r, k, v, logw, u, do)
    with pytest.raises(ValueError, match="do must be"):
        kwkv.wkv6_bwd(*args[:5], args[5][:, :3])
    with pytest.raises(ValueError, match="dstate must be"):
        kwkv.wkv6_bwd(*args, None, torch.zeros(1, 2, 32, 31))
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        kwkv.wkv6_bwd(args[0].requires_grad_(), *args[1:])
    x, dt, Bm, Cm, A, dy, _, _ = ssd_draw(2, 1, 4, 2, 32, 8, 1e-3, 0.4)
    args = torch_of(x, dt, Bm, Cm, A, dy)
    with pytest.raises(ValueError, match="dy must be"):
        kssd.ssd_bwd(*args[:5], args[5].double())
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        kssd.ssd_bwd(args[0], args[1].requires_grad_(), *args[2:])
    with torch.no_grad():
        kssd.ssd_bwd(*args)
